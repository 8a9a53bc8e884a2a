"""Tool data-capabilities.

Port of mayamatchmovesolver_torch/tools: the data paths inside the
reference's artist tool packages (ref: python/mmSolver/tools/ — ~80
packages).  The Qt UI layers are out of scope (SURVEY.md section 7);
what survives here is every tool's underlying math/data operation, as
batched PyTorch/NumPy functions over the scene engine's tensors.  Tools
of a baked scene compute on its device; tools that bake a SceneGraph
take `device` (default "cuda", no fallback to the CPU); the numpy tools
stay on the host.

Module map (reference tool package -> module here):
  screenspacetransform, screenspacerigbake,
  screenspacemotiontrail        -> tools.screenspace
  centertwodee                  -> tools.centertwodee
  reparent2, createcontroller2  -> tools.reparent
  cameraobjectscaleadjust/-remove -> tools.scaleadjust
  attributebake, smoothkeyframes -> tools.attributebake
  averagemarker, duplicatemarker, markerbundlerename -> tools.markertools
  setcameraoriginframe          -> tools.originframe
  raycastmarker                 -> tools.raycast
  createimageplane              -> tools.imageplane
  showdeviationcurves (marker deviation attrs) -> tools.deviation
  triangulatebundle             -> solver.strategies.SolverTriangulate
  loadlens / savelensfile       -> io.lensfile
  loadmarker / savemarkerfile   -> io.uvtrack + io.formatmanager
  copypastecamera               -> io.camerafile
  attachbundletocurve           -> tools.curves
  deformmarker, togglecameradistort -> tools.deformmarker
  subdivideline                 -> tools.subdivideline
  copypastemarker               -> tools.copypastemarker
  surfacecluster, createrivet (utils/rivet) -> tools.surfacecluster
  linkmarkerbundle, togglebundlelock, togglemarkerlock,
  cameraaim                     -> tools.markertools
"""

from mayamatchmovesolver_torch.tools import (  # noqa: F401
    attributebake,
    centertwodee,
    copypastemarker,
    curves,
    deformmarker,
    deviation,
    imageplane,
    markertools,
    originframe,
    raycast,
    reparent,
    scaleadjust,
    screenspace,
    subdivideline,
    surfacecluster,
)
