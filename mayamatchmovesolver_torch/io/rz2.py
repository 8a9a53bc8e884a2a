"""MatchMover .rz2 tracker export parser.

(ref: python/mmSolver/utils/loadmarker/formats/rz2.py:43-140.)
Block-structured text: an imageSequence{...} block with resolution,
path, frame range; then pointTrack "name" {...} blocks with rows
"frame x_px y_px".  MatchMover's origin is top-left, so y flips.

A copy of mayamatchmovesolver_tpu/io/rz2.py (host code, no tensors): the
port imports nothing of the JAX package.
"""

import re

from mayamatchmovesolver_torch.io.markerdata import FileInfo, MarkerData
from mayamatchmovesolver_torch.io.uvtrack import ParserError


def parse(file_path):
    with open(file_path) as f:
        text = f.read()

    idx = text.find("imageSequence")
    if idx == -1:
        raise ParserError(
            "Could not get 'imageSequence' index from: %r" % file_path
        )
    start_idx = text.find("{", idx + 1)
    end_idx = text.find("}", start_idx + 1)
    if start_idx == -1 or end_idx == -1:
        raise ParserError("Malformed imageSequence block")
    imgseq = text[start_idx + 1 : end_idx].strip()
    splt = imgseq.split()
    x_res = int(splt[0])
    y_res = int(splt[1])

    range_regex = re.search(r".*b\(\s(\d*)\s(\d*)\s(\d*)\s\)", imgseq)
    if range_regex is None:
        raise ParserError(
            "Could not get the frame range from: %r" % imgseq
        )
    start_frame, end_frame, by_frame = (
        int(g) for g in range_regex.groups()
    )
    frames = range(start_frame, end_frame + 1, by_frame)

    out = []
    idx = end_idx
    while True:
        idx = text.find("pointTrack", idx + 1)
        if idx == -1:
            break
        start_idx = text.find("{", idx + 1)
        if start_idx == -1:
            break
        end_idx = text.find("}", start_idx + 1)
        if end_idx == -1:
            break
        header = text[idx:start_idx]
        track_regex = re.search(r'pointTrack\s*\"(.*)\".*', header)
        if track_regex is None:
            continue
        md = MarkerData(name=track_regex.groups()[0])
        md.weight.set_value(start_frame, 1.0)
        for frame in frames:
            md.enable.set_value(frame, 0)
        for line in text[start_idx + 1 : end_idx].splitlines():
            splt = line.split()
            if not splt:
                continue
            frame = int(splt[0])
            md.x.set_value(frame, float(splt[1]) / x_res)
            md.y.set_value(frame, (float(splt[2]) / y_res) * -1 + 1.0)
            md.enable.set_value(frame, int(frame in frames))
        out.append(md)
    return FileInfo(), out
