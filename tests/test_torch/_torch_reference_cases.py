"""The JAX package's own test cases, run on the port.

`port_cases(path, names, replace)` reads a test file of the reference,
points it at the port (its imports name mayamatchmovesolver_torch, its
bakes take device="cpu", the tools that bake a SceneGraph are called
with device="cpu", and `jnp` is a small torch stand-in), executes it as
a module of its own and returns its test functions as pytest params.
The reference's file itself is untouched and still runs as written in
its own directory.
"""

import dataclasses
import functools
import inspect
import pathlib
import types

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]

# The port's functions that bake a SceneGraph themselves and so take a
# keyword-only device, "cuda" by default.
BAKING_TOOLS = (
    "centertwodee.apply_center",
    "markertools.create_average_marker",
    "markertools.duplicate_marker",
    "originframe.set_camera_origin_frame",
    "raycast.apply_raycast_bundles",
    "reparent.reparent",
    "scaleadjust.apply_scene_scale",
)


class _Jnp:
    """What the reference's tests call of jax.numpy, on torch."""

    int32 = torch.int64

    @staticmethod
    def arange(*args):
        return torch.arange(*args)

    @staticmethod
    def asarray(x, dtype=None):
        if torch.is_tensor(x):
            return x if dtype is None else x.to(dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype)


def _on_cpu(fn):
    return functools.partial(fn, device="cpu")


def port_source(path, replace=()):
    """The reference test file's text, pointed at the port."""
    text = (REPO / path).read_text()
    text = text.replace("mayamatchmovesolver_tpu", "mayamatchmovesolver_torch")
    text = text.replace("import jax.numpy as jnp", "jnp = _JNP")
    text = text.replace(".bake()", '.bake(device="cpu")')
    text = text.replace("bake_scene_lens(sg)",
                        'bake_scene_lens(sg, device="cpu")')
    for name in BAKING_TOOLS:
        text = text.replace(name + "(", "_on_cpu(%s)(" % name)
    for old, new in replace:
        assert old in text, old
        text = text.replace(old, new)
    return text


def port_module(path, replace=()):
    """The reference test file, pointed at the port, as a module."""
    name = "port_of_" + pathlib.Path(path).stem
    module = types.ModuleType(name)
    module.__file__ = str(REPO / path)
    module.__dict__.update(_JNP=_Jnp, _on_cpu=_on_cpu,
                           dataclasses=dataclasses)
    exec(compile(port_source(path, replace), module.__file__, "exec"),
         module.__dict__)
    return module


def port_cases(path, names, replace=()):
    """pytest params (test function) for the named cases of a
    reference test file, run on the port."""
    module = port_module(path, replace)
    stem = pathlib.Path(path).stem
    return [pytest.param(getattr(module, n), id="%s::%s" % (stem, n))
            for n in names]


def public_names(module):
    """Names a module defines for its users: no private names, no
    imported modules, no functions or classes defined elsewhere."""
    out = set()
    for name, value in vars(module).items():
        if name.startswith("_") or inspect.ismodule(value):
            continue
        if (inspect.isfunction(value) or inspect.isclass(value)) and (
                value.__module__ != module.__name__):
            continue
        out.add(name)
    return out
