"""Image-sequence path handling.

Counterpart of the reference's imageseq utility
(ref: python/mmSolver/utils/imageseq.py:32-132): split a frame-numbered
file path, scan the directory for the sequence's start/end frames, and
express the sequence in several pattern styles.

Port of mayamatchmovesolver_tpu/utils/imageseq.py: a copy of the
reference's host code.
"""

import os
import re

__all__ = [
    "IMAGE_SEQ_FORMAT_STYLE_MAYA",
    "IMAGE_SEQ_FORMAT_STYLE_HASH_PADDED",
    "IMAGE_SEQ_FORMAT_STYLE_PRINTF",
    "IMAGE_SEQ_FORMAT_STYLE_FIRST_FRAME",
    "split_image_sequence_path",
    "expand_image_sequence_path",
    "frame_path",
]

# (ref: mmSolver/utils/constant.py IMAGE_SEQ_FORMAT_STYLE_*.)
IMAGE_SEQ_FORMAT_STYLE_MAYA = "maya"  # file.<f>.png
IMAGE_SEQ_FORMAT_STYLE_HASH_PADDED = "hash_padded"  # file.####.png
IMAGE_SEQ_FORMAT_STYLE_PRINTF = "printf"  # file.%04d.png
IMAGE_SEQ_FORMAT_STYLE_FIRST_FRAME = "first_frame"  # file.1001.png

_TRAILING_DIGITS = re.compile(r"^(.*?)(\d+)$")


def split_image_sequence_path(path):
    """Split '/dir/file.1001.exr' into
    (base_dir, 'file.', 1001, '1001', '.exr'); frame number -1 when the
    name has no trailing digits (ref: imageseq.py:47)."""
    base_dir, base_name = os.path.split(path)
    stem, ext = os.path.splitext(base_name)
    m = _TRAILING_DIGITS.match(stem)
    if not m:
        return base_dir, stem, -1, "", ext
    return base_dir, m.group(1), int(m.group(2)), m.group(2), ext


def _scan_sequence(base_dir, prefix, ext):
    """Find (start, end, padding) of matching files on disk
    (ref: imageseq.py:59)."""
    start, end, padding = -1, -1, 0
    try:
        names = os.listdir(base_dir or ".")
    except OSError:
        names = []
    for name in names:
        stem, e = os.path.splitext(name)
        if e != ext or not stem.startswith(prefix):
            continue
        digits = stem[len(prefix):]
        if not digits.isdigit():
            continue
        num = int(digits)
        padding = max(padding, len(digits))
        start = num if start < 0 else min(start, num)
        end = max(end, num)
    if start < 0:
        start = end = 0
        padding = 0
    return start, end, padding


def expand_image_sequence_path(path, format_style):
    """Returns (file_pattern, start_frame, end_frame, padding, is_seq)
    (ref: imageseq.py:93)."""
    path = os.path.abspath(path)
    base_dir, prefix, _num, _num_str, ext = split_image_sequence_path(
        path
    )
    start, end, padding = _scan_sequence(base_dir, prefix, ext)
    is_seq = start != end and padding > 0
    if not is_seq:
        return path, start, end, padding, False
    if format_style == IMAGE_SEQ_FORMAT_STYLE_MAYA:
        token = "<f>"
    elif format_style == IMAGE_SEQ_FORMAT_STYLE_HASH_PADDED:
        token = "#" * padding
    elif format_style == IMAGE_SEQ_FORMAT_STYLE_PRINTF:
        token = "%%0%dd" % padding
    elif format_style == IMAGE_SEQ_FORMAT_STYLE_FIRST_FRAME:
        token = str(start).zfill(padding)
    else:
        raise ValueError("unknown format style %r" % format_style)
    pattern = os.path.join(base_dir, prefix + token + ext)
    return pattern, start, end, padding, True


def frame_path(pattern, frame):
    """Resolve a pattern ('#'-padded, printf, or <f>) to a concrete
    frame's path."""
    if "#" in pattern:
        n = pattern.count("#")
        return pattern.replace("#" * n, str(int(frame)).zfill(n))
    if "<f>" in pattern:
        return pattern.replace("<f>", str(int(frame)))
    if "%" in pattern:
        return pattern % int(frame)
    return pattern
