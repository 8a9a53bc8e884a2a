"""Solver state checkpoint / resume.

Port of mayamatchmovesolver_tpu/solver/checkpoint.py.  The reference
persists solver state through the Maya scene (Collection node
serialization, collection.py:375-415) and undo stacks; here the
attribute block, a parameter vector or a whole resumable LM / BA state
goes to an npz so long solves resume across processes.  The npz keys
(`lm_<field>`, `ba_<field>`, `format_version`, `metadata`) and the
arrays' dtypes are the JAX package's, so each package loads the other's
files.  Every loader takes the device the tensors go to.
"""

import dataclasses
import json

import numpy as np
import torch

from mayamatchmovesolver_torch.scene.attrblock import AttrBlock
from mayamatchmovesolver_torch.solver import ba as ba_mod
from mayamatchmovesolver_torch.solver import lm as lm_mod

FORMAT_VERSION = 1

# The evaluation counters came to the state classes after the first
# checkpoints were written; a file without them resumes with the counts
# of a fresh state: lm_init has evaluated the residuals and the Jacobian
# once, ba_init only the cost (its first assembly is counted by the
# first iteration).  Any other missing field is an error.
_LM_COUNTER_DEFAULTS = {"nfev": 1, "njev": 1}
_BA_COUNTER_DEFAULTS = {"nfev": 1, "njev": 0}


def _host(tensor):
    return tensor.detach().cpu().numpy()


def _check_version(data):
    version = int(data["format_version"])
    if version != FORMAT_VERSION:
        raise ValueError("unsupported checkpoint version: %d" % version)


def _attrs_from(data, device):
    return AttrBlock(
        static_values=torch.as_tensor(data["static_values"], device=device),
        anim_values=torch.as_tensor(data["anim_values"], device=device),
    )


def save_attrs(file_path, attrs: AttrBlock, metadata=None):
    """Write the attribute block (+ JSON metadata) to an npz."""
    np.savez_compressed(
        file_path,
        format_version=FORMAT_VERSION,
        static_values=_host(attrs.static_values),
        anim_values=_host(attrs.anim_values),
        metadata=json.dumps(metadata or {}),
    )


def load_attrs(file_path, *, device):
    """Returns (AttrBlock on `device`, metadata dict)."""
    with np.load(file_path, allow_pickle=False) as data:
        _check_version(data)
        attrs = _attrs_from(data, device)
        metadata = json.loads(str(data["metadata"]))
    return attrs, metadata


def save_solve_state(file_path, attrs, params=None, iteration=0,
                     cost=None, extra=None):
    """Checkpoint mid-solve state (params vector + progress counters)."""
    meta = dict(extra or {})
    meta["iteration"] = int(iteration)
    if cost is not None:
        meta["cost"] = float(cost)
    if params is None:
        params = np.zeros(0)
    elif isinstance(params, torch.Tensor):
        params = _host(params)
    np.savez_compressed(
        file_path,
        format_version=FORMAT_VERSION,
        static_values=_host(attrs.static_values),
        anim_values=_host(attrs.anim_values),
        params=np.asarray(params),
        metadata=json.dumps(meta),
    )


def load_solve_state(file_path, *, device):
    """Returns (AttrBlock on `device`, params as numpy or None,
    metadata).  Checks format_version like load_attrs (the JAX package's
    load_solve_state reads any version)."""
    with np.load(file_path, allow_pickle=False) as data:
        _check_version(data)
        attrs = _attrs_from(data, device)
        params = np.asarray(data["params"])
        metadata = json.loads(str(data["metadata"]))
    return attrs, (params if params.size else None), metadata


def _save_state(file_path, state, prefix, metadata):
    np.savez_compressed(
        file_path,
        format_version=FORMAT_VERSION,
        metadata=json.dumps(metadata or {}),
        **{prefix + f.name: _host(getattr(state, f.name))
           for f in dataclasses.fields(state)},
    )


def _load_state(file_path, cls, prefix, counter_defaults, device):
    with np.load(file_path, allow_pickle=False) as data:
        _check_version(data)
        fields = {}
        for f in dataclasses.fields(cls):
            key = prefix + f.name
            if key in data:
                fields[f.name] = torch.as_tensor(data[key], device=device)
            elif f.name in counter_defaults:
                fields[f.name] = torch.tensor(
                    counter_defaults[f.name], dtype=torch.int32,
                    device=device)
            else:
                raise ValueError(
                    "checkpoint %s has no field %r" % (file_path, key))
        metadata = json.loads(str(data["metadata"]))
    return cls(**fields), metadata


def save_lm_state(file_path, state, metadata=None):
    """Checkpoint a full resumable LM state (solver/lm.py LMState — the
    per-iteration-block state the chunked solve passes between blocks).
    Resume by loading and feeding it back into lm.lm_run_block."""
    _save_state(file_path, state, "lm_", metadata)


def load_lm_state(file_path, *, device):
    """Returns (LMState on `device`, metadata dict).  A file written
    before the evaluation counters existed starts them at their values
    after lm_init (1 and 1); any other missing field raises (the JAX package fills every missing field with
    an int32 zero)."""
    return _load_state(file_path, lm_mod.LMState, "lm_",
                       _LM_COUNTER_DEFAULTS, device)


def save_ba_state(file_path, state, metadata=None):
    """Checkpoint a resumable BA state (solver/ba.py BAState — the block
    state the chunked BA solve passes between blocks).  Resume by
    loading and feeding it back into ba.ba_run_block."""
    _save_state(file_path, state, "ba_", metadata)


def load_ba_state(file_path, *, device):
    """Returns (BAState on `device`, metadata dict); missing fields as in
    load_lm_state, the counters starting at their values after ba_init
    (nfev 1, njev 0)."""
    return _load_state(file_path, ba_mod.BAState, "ba_",
                       _BA_COUNTER_DEFAULTS, device)
