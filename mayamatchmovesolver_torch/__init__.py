"""mayamatchmovesolver_torch — the PyTorch/CUDA port of mayamatchmovesolver_tpu.

The JAX package beside it is the reference: every module here mirrors
the module at the same path there, keeps its public names, and is held
against it by the agreement tests in tests/test_torch/.  This package
imports torch and numpy, never jax.

Ported so far (the lens + camera solve and the ST-map export):
  core/    — TRS transforms, projection matrix, film fit
  scene/   — AttrBlock, FlatScene + evaluate, SceneGraph builder,
             interop (baked JAX arrays -> port objects)
  models/  — 3DE lens models, SceneLens bindings
  solver/  — loss, bounds, SolveProblem, dense LM, solve()
  ops/     — ST-map export; csrc/stmap.cu is its Hopper kernel, built
             and loaded by _kernels.py
"""

__version__ = "0.1.0"
