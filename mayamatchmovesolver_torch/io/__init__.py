"""File formats of the port (ref: mayamatchmovesolver_tpu/io): the marker
files (uvtrack, 3DE, PFTrack, MatchMover) with their registry, EXR and
image files, and the Nuke-script lens file (io/lensfile.py)."""
from mayamatchmovesolver_torch.io.formatmanager import (  # noqa: F401
    get_formats,
    read,
)
from mayamatchmovesolver_torch.io.markerdata import (  # noqa: F401
    FileInfo,
    KeyframeData,
    MarkerData,
    markers_to_scene,
)
from mayamatchmovesolver_torch.io import (  # noqa: F401
    pftrack2dt,
    rz2,
    tdetxt,
    uvtrack,
)
