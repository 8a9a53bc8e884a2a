"""Frame-range utilities.

Counterpart of the reference's time utility
(ref: python/mmSolver/utils/time.py:44-160).  There is no Maya
timeline here; the 'timeline' is the baked frame range of a SceneGraph
or AttrBlock, so the inner/outer modes take the scene as source.

Port of mayamatchmovesolver_tpu/utils/time.py: a copy of the
reference's host code; get_keyframe_times_for_attrs reads the port's
AttrBlock tensors to the host in one transfer.
"""

import collections

import numpy as np

__all__ = [
    "FrameRange",
    "FRAME_RANGE_MODE_SCENE_VALUE",
    "FRAME_RANGE_MODE_CUSTOM_VALUE",
    "get_frame_range",
    "convert_frame_range_to_frame_list",
    "get_keyframe_times_for_attrs",
]

FrameRange = collections.namedtuple("FrameRange", ["start", "end"])

# (ref: mmSolver/utils/constant.py FRAME_RANGE_MODE_*_VALUE; the
# timeline inner/outer modes collapse to the scene's baked range.)
FRAME_RANGE_MODE_SCENE_VALUE = "timeline_inner"
FRAME_RANGE_MODE_CUSTOM_VALUE = "custom"


def get_frame_range(
    frame_range_mode, start_frame=None, end_frame=None, scene_graph=None
):
    """(ref: utils/time.py:101 get_frame_range.)"""
    if frame_range_mode == FRAME_RANGE_MODE_CUSTOM_VALUE:
        assert start_frame is not None and end_frame is not None
        return FrameRange(int(start_frame), int(end_frame))
    if frame_range_mode == FRAME_RANGE_MODE_SCENE_VALUE:
        assert scene_graph is not None, "scene-range mode needs a scene"
        start, end = scene_graph.frame_range
        return FrameRange(int(start), int(end))
    raise ValueError("unknown frame range mode %r" % frame_range_mode)


def convert_frame_range_to_frame_list(frame_range):
    """(ref: utils/time.py:141.)"""
    start, end = frame_range
    return list(range(int(start), int(end) + 1))


def get_keyframe_times_for_attrs(attrs, attr_objs, frame_range):
    """Frames at which each animated attribute changes value — the
    dense-channel analogue of querying animCurve key times
    (ref: utils/time.py:70 get_keyframe_times_for_node_attrs).

    attrs: AttrBlock; attr_objs: iterable of scene Attribute handles;
    frame_range: (start, end) of the baked range.
    Returns {attr_name: [frame, ...]}.
    """
    start, _end = frame_range
    anim = attrs.anim_values.detach().cpu().numpy()
    out = {}
    for a in attr_objs:
        if a.code % 2 != 1:
            out[a.name] = []
            continue
        values = anim[a.code // 2]
        changed = np.nonzero(np.diff(values) != 0.0)[0]
        frames = {int(start)}
        for i in changed:
            frames.add(int(start + i))
            frames.add(int(start + i + 1))
        out[a.name] = sorted(frames)
    return out
