"""Marker-file format registry.

(ref: python/mmSolver/utils/loadmarker/formatmanager.py and
formats/README.md — a plugin registry keyed by file extension.)

A copy of mayamatchmovesolver_tpu/io/formatmanager.py (host code, no
tensors): the port imports nothing of the JAX package.
"""

import os

from mayamatchmovesolver_torch.io import pftrack2dt, rz2, tdetxt, uvtrack

_FORMATS = {
    ".uv": ("UV Track Points (*.uv)", uvtrack.parse),
    ".txt": ("3DEqualizer Track Points (*.txt)", tdetxt.parse),
    ".2dt": ("PFTrack 2D Tracks (*.2dt)", pftrack2dt.parse),
    ".rz2": ("MatchMover TrackPoints (*.rz2)", rz2.parse),
}


def get_formats():
    return {ext: name for ext, (name, _) in _FORMATS.items()}


def read(file_path, **kwargs):
    """Parse any supported marker file; returns (FileInfo, [MarkerData]).

    kwargs pass through to the specific parser (image_width/height for
    pixel-based formats, undistorted/with_3d_pos for uvtrack v3+).
    """
    ext = os.path.splitext(file_path)[1].lower()
    if ext not in _FORMATS:
        # Sniff uvtrack content regardless of extension, like the
        # reference's is_valid_format loop over all loaders.
        try:
            return uvtrack.parse(file_path, **kwargs)
        except Exception:
            raise ValueError("Unsupported marker format: %r" % file_path)
    _, parser = _FORMATS[ext]
    import inspect

    sig = inspect.signature(parser)
    accepted = {
        k: v for k, v in kwargs.items() if k in sig.parameters
    }
    return parser(file_path, **accepted)
