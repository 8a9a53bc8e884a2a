"""Intermediate marker representation for file import/export.

Mirrors the reference's MarkerData/KeyframeData model
(ref: python/mmSolver/utils/loadmarker/markerdata.py and
fileinfo.py): per-frame x/y/weight/enable channels in UV space
([0, 1], v up) plus optional 3D bundle positions.

Port of mayamatchmovesolver_tpu/io/markerdata.py: the data classes are
host Python, copied; markers_to_scene fills the port's SceneGraph, whose
bake puts the scene on the device the caller names.
"""

import dataclasses
from typing import Dict, Optional


class KeyframeData:
    """Sparse frame -> value samples
    (ref: python/mmSolver/utils/loadmarker/keyframedata in markerdata.py)."""

    def __init__(self, data: Optional[Dict[int, float]] = None):
        self._data: Dict[int, float] = dict(data or {})

    def set_value(self, frame, value):
        self._data[int(frame)] = value

    def get_value(self, frame, default=None):
        return self._data.get(int(frame), default)

    def get_times(self):
        return sorted(self._data)

    def values(self):
        return dict(self._data)

    def __len__(self):
        return len(self._data)


@dataclasses.dataclass
class MarkerData:
    name: str = ""
    group_name: str = ""
    id: Optional[str] = None
    color: Optional[int] = None
    x: KeyframeData = dataclasses.field(default_factory=KeyframeData)
    y: KeyframeData = dataclasses.field(default_factory=KeyframeData)
    weight: KeyframeData = dataclasses.field(default_factory=KeyframeData)
    enable: KeyframeData = dataclasses.field(default_factory=KeyframeData)
    bundle_x: Optional[float] = None
    bundle_y: Optional[float] = None
    bundle_z: Optional[float] = None
    bundle_lock_x: Optional[bool] = None
    bundle_lock_y: Optional[bool] = None
    bundle_lock_z: Optional[bool] = None

    def set_name(self, name):
        self.name = name

    def get_name(self):
        return self.name

    def frame_range(self):
        times = self.x.get_times()
        if not times:
            return None
        return times[0], times[-1]


@dataclasses.dataclass
class FileInfo:
    """(ref: python/mmSolver/utils/loadmarker/fileinfo.py.)"""

    marker_distorted: bool = False
    marker_undistorted: bool = False
    bundle_positions: bool = False
    camera_field_of_view: Optional[list] = None


def fill_occluded_frames(mkr_data: MarkerData, frames):
    """Frames inside the observed range without data get enable=0 and
    weight=0 (ref: uvtrack.py:277-296
    _parse_marker_occluded_frames_v1_v2_v3)."""
    if not frames:
        return mkr_data
    for frame in range(min(frames), max(frames) + 1):
        enabled = frame in frames
        mkr_data.enable.set_value(frame, int(enabled))
        if not enabled:
            mkr_data.weight.set_value(frame, 0.0)
    return mkr_data


def markers_to_scene(
    mkr_data_list,
    scene_graph,
    camera,
    uv_to_marker_space=True,
):
    """Instantiate MarkerData into the port's SceneGraph: bundles +
    markers with animated channels.  UV [0,1] converts to marker space
    [-0.5, 0.5] (the reference's loadmarker does the same shift when
    creating markers under a marker group)."""
    import numpy as np

    frames = scene_graph.frames
    created = []
    for i, md in enumerate(mkr_data_list):
        name = md.name or ("marker%d" % i)
        bnd = scene_graph.create_bundle(
            "%s_bnd" % name,
            tx=md.bundle_x or 0.0,
            ty=md.bundle_y or 0.0,
            tz=md.bundle_z or 0.0,
        )
        offset = 0.5 if uv_to_marker_space else 0.0
        tx = np.array(
            [md.x.get_value(f, 0.0) - offset for f in frames]
        )
        ty = np.array(
            [md.y.get_value(f, 0.0) - offset for f in frames]
        )
        weight = np.array([md.weight.get_value(f, 0.0) for f in frames])
        enable = np.array(
            [float(md.enable.get_value(f, 0)) for f in frames]
        )
        mkr = scene_graph.create_marker(
            name, camera=camera, bundle=bnd,
            tx=tx, ty=ty, weight=weight, enable=enable,
        )
        created.append((mkr, bnd))
    return created
