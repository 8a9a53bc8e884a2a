"""PFTrack .2dt / .txt tracker export parser.

(ref: python/mmSolver/utils/loadmarker/formats/pftrack2dt.py:109-230.)
Per tracker: quoted name, clip number (or quoted camera name), frame
count, rows "frame x_px y_px residual [zdepth]".  PFTrack pixel centers
are at 0.0 so +0.5 before normalizing.

A copy of mayamatchmovesolver_tpu/io/pftrack2dt.py (host code, no
tensors): the port imports nothing of the JAX package.
"""

from mayamatchmovesolver_torch.io.markerdata import (
    FileInfo,
    MarkerData,
    fill_occluded_frames,
)
from mayamatchmovesolver_torch.io.uvtrack import ParserError


def _int_or_none(s):
    try:
        return int(s)
    except ValueError:
        return None


def parse(file_path, image_width=None, image_height=None):
    inv_w = 1.0 / (image_width or 1.0)
    inv_h = 1.0 / (image_height or 1.0)
    with open(file_path) as f:
        lines = [ln.strip() for ln in f.readlines()]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]
    if not lines:
        raise OSError("No contents in the file: %s" % file_path)
    out = []
    i = 0
    while i < len(lines):
        line = lines[i]
        if not (line.startswith('"') and line.endswith('"')):
            i += 1
            continue
        name = line[1:-1]
        i += 1

        # Clip number (PFTrack >=6) or quoted camera name (PFTrack 5).
        line = lines[i]
        if _int_or_none(line) is not None:
            i += 1
        elif line.startswith('"') and line.endswith('"'):
            i += 1
        else:
            raise ParserError(
                "File invalid, expecting a camera name in line: %r" % line
            )

        md = MarkerData(name=name)
        num_frames = _int_or_none(lines[i])
        if num_frames is None:
            raise ParserError(
                "File invalid, expecting a number of frames in line: %r"
                % lines[i]
            )
        i += 1
        frames = []
        for _ in range(num_frames):
            split = lines[i].split(" ")
            if len(split) not in (4, 5):
                raise ParserError(
                    "File invalid, there must be 4 or 5 numbers in "
                    "line: %r" % lines[i]
                )
            frame = int(split[0])
            md.x.set_value(frame, (float(split[1]) + 0.5) * inv_w)
            md.y.set_value(frame, (float(split[2]) + 0.5) * inv_h)
            md.weight.set_value(frame, 1.0)
            frames.append(frame)
            i += 1
        fill_occluded_frames(md, frames)
        out.append(md)
    return FileInfo(marker_undistorted=True), out
