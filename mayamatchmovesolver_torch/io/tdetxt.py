"""3DEqualizer .txt 2D track export parser.

(ref: python/mmSolver/utils/loadmarker/formats/tdetxt.py:93-200.)
Layout: point count, then per point: name, color, frame count, rows
"frame x_pixels y_pixels".  Pixel coords divide by image size into UV.

A copy of mayamatchmovesolver_tpu/io/tdetxt.py (host code, no tensors):
the port imports nothing of the JAX package.
"""

from mayamatchmovesolver_torch.io.markerdata import (
    FileInfo,
    MarkerData,
    fill_occluded_frames,
)
from mayamatchmovesolver_torch.io.uvtrack import ParserError


def _strip_comments(lines):
    return [ln for ln in (l.strip() for l in lines)
            if ln and not ln.startswith("#")]


def parse(file_path, image_width=None, image_height=None):
    inv_w = 1.0 / (image_width or 1.0)
    inv_h = 1.0 / (image_height or 1.0)
    with open(file_path) as f:
        lines = _strip_comments(f.readlines())
    if not lines:
        raise OSError("No contents in the file: %s" % file_path)
    num_points = int(lines[0])
    if num_points < 1:
        raise ParserError("No points exist.")
    out = []
    idx = 1
    for _ in range(num_points):
        md = MarkerData(name=lines[idx])
        idx += 1
        md.color = int(lines[idx])
        idx += 1
        num_frames = int(lines[idx])
        if num_frames <= 0:
            idx += 1
            continue
        frames = []
        j = num_frames
        while j > 0:
            idx += 1
            line = lines[idx]
            if not line:
                break
            j -= 1
            split = line.split()
            if len(split) != 3:
                raise ParserError(
                    "File invalid, there must be 3 numbers in line: %r"
                    % line
                )
            frame = int(split[0])
            md.x.set_value(frame, float(split[1]) * inv_w)
            md.y.set_value(frame, float(split[2]) * inv_h)
            md.weight.set_value(frame, 1.0)
            frames.append(frame)
        fill_occluded_frames(md, frames)
        out.append(md)
        idx += 1
    return FileInfo(marker_undistorted=True), out
