"""The interop bridge and the port's independence from jax.

interop turns the JAX package's baked FlatScene / AttrBlock / SceneLens
(as numpy arrays) into the port's objects; that must reproduce the
port's own bake of the same scene exactly.  And every port module must
import in a process where jax cannot be imported.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port_cases import jax_fields, rich_scene, to_numpy
from mayamatchmovesolver_torch.scene import interop

REPO = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def carried_and_baked():
    _, j_sc, j_at, j_lens, _ = rich_scene("jax")
    _, t_sc, t_at, t_lens, _ = rich_scene("torch")
    carried = (
        interop.flat_scene(jax_fields(j_sc), j_sc.doubling_steps,
                           device="cpu", dtype=torch.float64),
        interop.attr_block(jax_fields(j_at), device="cpu"),
        interop.scene_lens(jax_fields(j_lens), j_lens.model_types,
                           device="cpu"),
    )
    return carried, (t_sc, t_at, t_lens)


@pytest.mark.parametrize("which", ["scene", "attrs", "lens"])
def test_interop_reproduces_the_ports_bake(carried_and_baked, which):
    carried, baked = carried_and_baked
    i = ("scene", "attrs", "lens").index(which)
    got, want = carried[i], baked[i]
    assert type(got) is type(want)
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device, field.name
            np.testing.assert_array_equal(to_numpy(a), to_numpy(b),
                                          err_msg=field.name)
        else:
            assert a == b, field.name


def test_interop_rejects_missing_fields():
    _, j_sc, _, _, _ = rich_scene("jax")
    arrays = jax_fields(j_sc)
    del arrays["tfm_parent"]
    with pytest.raises(ValueError, match="tfm_parent"):
        interop.flat_scene(arrays, 2, device="cpu", dtype=torch.float64)


PORT_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts)
    for p in (REPO / "mayamatchmovesolver_torch").rglob("*.py")
)


def test_every_port_module_imports_without_jax():
    for reached in ("solver.lm", "api", "sfm.camerasolve",
                    "solver.strategies", "parallel.ba_sharded",
                    "parallel.multihost"):
        assert "mayamatchmovesolver_torch." + reached in PORT_MODULES
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "for name in %r:\n"
        "    importlib.import_module(name.replace('.__init__', ''))\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and m.startswith(('jax', 'mayamatchmovesolver_tpu'))]\n"
        "assert not bad, bad\n" % (PORT_MODULES,)
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
