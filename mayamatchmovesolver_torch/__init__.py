"""mayamatchmovesolver_torch — the PyTorch/CUDA port of mayamatchmovesolver_tpu.

The JAX package beside it is the reference: every module here mirrors
the module at the same path there, keeps its public names, and is held
against it by the agreement tests in tests/test_torch/.  This package
imports torch and numpy, never jax.

Ported so far (the lens + camera solve, the Schur BA, the per-frame
solve, the hooks and checkpoints, the lens export with warp, the solver
strategies behind the Collection API, the from-scratch camera solve,
the command line with its file formats, and the artist tools):
  api      — Frame, Lens, Collection, validate, execute(device=)
  cli      — the reference's sixteen verbs (python -m
             mayamatchmovesolver_torch.cli); --device defaults to cuda
  core/    — TRS transforms and their decomposition into Euler angles,
             projection matrix, film fit, reprojection, 2D line math
  scene/   — AttrBlock, FlatScene + evaluate, SceneGraph builder,
             interop (baked JAX arrays -> port objects)
  models/  — 3DE lens models, SceneLens bindings, attach_lens_file
  solver/  — loss, bounds, SolveProblem, the LM (one problem or a
             batch), the Schur BA and its bridge, solve() with its
             block-resumable solve loops, solve_per_frame, checkpoint,
             strategies (Step, Basic, Standard, Triangulate, Camera),
             rootframe, affects, triangulate, linalg (on torch.linalg.eigh)
  sfm/     — two-view geometry with hypothesis-parallel RANSAC, resection,
             vanishing-point calibration, the incremental camera solve
  ops/     — ST-map export of a lens or a lens stack; csrc/stmap.cu is
             its Hopper kernel, built and loaded by _kernels.py; image
             warp; lens deformer
  io/      — marker files (uvtrack, 3DE, PFTrack, MatchMover) and their
             registry, EXR (every codec) and image files, the Nuke-script
             lens file, the .mmcamera camera file
  native   — ctypes binding to native/libmmtpu_native.so (the PIZ
             Huffman codec)
  utils/   — the Kalman filter of the sequential per-frame solve, batch
             reprojection, profiling (phase timers, torch.profiler trace),
             ray-mesh intersection, smoothing, animation curves, config,
             logging, events, frame ranges, image sequences, natural sort,
             string conversions
  tools/   — artist-tool data capabilities: screen-space conversion and
             rig bake, center-2D, reparent, origin frame, scene scale,
             ray-cast onto a mesh, marker deform, marker ops, copy/paste
             markers, deviation reports, attribute bake, curves, image
             plane, subdivide line, surface cluster; those that bake a
             SceneGraph take device= (default "cuda")
"""

__version__ = "0.1.0"

from mayamatchmovesolver_torch.utils import config as _config  # noqa: F401
