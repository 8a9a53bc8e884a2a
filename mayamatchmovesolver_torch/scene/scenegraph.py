"""Editable scene graph, baked into a FlatScene + AttrBlock.

Port of mayamatchmovesolver_tpu/scene/scenegraph.py: the same host-side
construction API (ref: lib/rust/mmscenegraph/src/scene/graph and
src/mmSolver/mayahelper/maya_scene_graph.cpp:1114).  Users build
transforms/cameras/bundles/markers with static or per-frame animated
attribute values; bake() flattens everything to tensors on a device.
"""

from typing import Optional

import numpy as np

from mayamatchmovesolver_torch.core.constants import FilmFit, RotateOrder
from mayamatchmovesolver_torch.scene.attrblock import (
    ATTR_NONE,
    AttrBlockBuilder,
)
from mayamatchmovesolver_torch.scene import flatscene


class Attribute:
    """A solvable attribute: its packed code plus solver metadata.

    Mirrors the reference Attr's min/max/offset/scale box-constraint
    metadata (ref: src/mmSolver/mayahelper/maya_attr.h:304-375).
    """

    def __init__(self, node, name, code):
        self.node = node
        self.name = name
        self.code = code
        self.min_value = -np.inf
        self.max_value = np.inf
        self.offset_value = 0.0
        self.scale_value = 1.0
        # Locked attributes are excluded from solves (ref: the
        # reference's Attr/Attribute locked state,
        # python/mmSolver/_api/attribute.py:237 is_locked — the
        # compile layer drops locked attrs before solving).
        self.locked = False

    def lock(self):
        self.locked = True
        return self

    def unlock(self):
        self.locked = False
        return self

    def is_locked(self):
        return bool(self.locked)

    def set_min_max(self, min_value=None, max_value=None):
        if min_value is not None:
            self.min_value = float(min_value)
        if max_value is not None:
            self.max_value = float(max_value)
        return self

    def __repr__(self):
        return "Attribute(%s.%s, code=%d)" % (
            self.node.name,
            self.name,
            self.code,
        )


class _Node:
    kind = "node"

    def __init__(self, graph, name):
        self.graph = graph
        self.name = name
        self.attrs = {}

    def attr(self, name) -> Attribute:
        return self.attrs[name]

    def attr_code(self, name):
        a = self.attrs.get(name)
        return ATTR_NONE if a is None else a.code

    def __repr__(self):
        return "%s(%r)" % (type(self).__name__, self.name)


class TransformNode(_Node):
    kind = "transform"

    def __init__(self, graph, name, parent, rotate_order):
        super().__init__(graph, name)
        self.parent: Optional[TransformNode] = parent
        self.rotate_order = int(rotate_order)
        self.index = None  # assigned at bake


class CameraNode(TransformNode):
    kind = "camera"

    def __init__(self, graph, name, parent, rotate_order, film_fit,
                 render_width, render_height):
        super().__init__(graph, name, parent, rotate_order)
        self.film_fit = int(film_fit)
        self.render_width = int(render_width)
        self.render_height = int(render_height)
        self.cam_index = None


class BundleNode(TransformNode):
    kind = "bundle"

    def __init__(self, graph, name, parent, rotate_order):
        super().__init__(graph, name, parent, rotate_order)
        self.bnd_index = None


class MarkerGroupNode(_Node):
    """Shared 2D overscan scale for a set of markers — the capability
    of the reference's MarkerGroup + mmMarkerScale overscan
    (ref: python/mmSolver/_api/markergroup.py,
    src/mmSolver/node/MMMarkerScaleNode.cpp).  Markers in the group
    reference the group's overscan attr codes directly."""

    kind = "markergroup"

    def __init__(self, graph, name, camera):
        super().__init__(graph, name)
        self.camera = camera


class LineNode(_Node):
    """A straightness constraint over a set of markers — the capability
    of the reference's Line API objects + mmLineBestFit node feeding the
    solve (ref: python/mmSolver/_api/line.py,
    src/mmSolver/node/MMLineBestFitNode.cpp:94).  Member markers'
    reprojected bundles are softly constrained to be collinear in
    screen space."""

    kind = "line"

    def __init__(self, graph, name, markers, weight):
        super().__init__(graph, name)
        self.markers = list(markers)
        self.weight = float(weight)


class MarkerNode(_Node):
    kind = "marker"

    def __init__(self, graph, name, camera, bundle, group=None):
        super().__init__(graph, name)
        self.camera = camera
        self.bundle = bundle
        self.group = group
        self.mkr_index = None


_TFM_DEFAULTS = {
    "tx": 0.0, "ty": 0.0, "tz": 0.0,
    "rx": 0.0, "ry": 0.0, "rz": 0.0,
    "sx": 1.0, "sy": 1.0, "sz": 1.0,
}

_CAM_DEFAULTS = {
    # Maya default film back is 36x24mm (1.417x0.945 inch); stored in mm
    # here, converted at evaluation (ref: math/dag.rs:138-147).
    "sensor_width_mm": 36.0,
    "sensor_height_mm": 24.0,
    "focal_length_mm": 35.0,
    "lens_offset_x_mm": 0.0,
    "lens_offset_y_mm": 0.0,
    "near_clip_cm": 0.1,
    "far_clip_cm": 10000.0,
    "camera_scale": 1.0,
}

_MKR_DEFAULTS = {"tx": 0.0, "ty": 0.0, "weight": 1.0, "enable": 1.0}

_MKR_GROUP_DEFAULTS = {"overscan_x": 1.0, "overscan_y": 1.0}


class SceneGraph:
    """Build a scene over an inclusive frame range, then bake()."""

    def __init__(self, frame_range=(1, 1), dtype=np.float64):
        self.start_frame, self.end_frame = int(frame_range[0]), int(
            frame_range[1]
        )
        if self.end_frame < self.start_frame:
            raise ValueError("end frame before start frame")
        self.frames = np.arange(self.start_frame, self.end_frame + 1)
        self._attr_builder = AttrBlockBuilder(len(self.frames), dtype=dtype)
        self._transforms = []  # creation order == topological order
        self._cameras = []
        self._bundles = []
        self._markers = []
        self._lines = []
        self._names = set()

    @property
    def num_frames(self):
        return len(self.frames)

    @property
    def frame_range(self):
        """Inclusive (start, end) of the baked frame range."""
        return (self.start_frame, self.end_frame)

    def frame_index(self, frame):
        return int(frame) - self.start_frame

    def _check_name(self, name):
        if name in self._names:
            raise ValueError("duplicate node name: %r" % name)
        self._names.add(name)

    def _add_attrs(self, node, defaults, values):
        for attr_name, default in defaults.items():
            value = values.get(attr_name, default)
            code = self._attr_builder.add(value)
            node.attrs[attr_name] = Attribute(node, attr_name, code)

    def set_value(self, attr, value, frame=None):
        """Edit an attribute value before bake (Attr::setValue
        counterpart, ref: src/mmSolver/mayahelper/maya_attr.h:304)."""
        self._attr_builder.set_value(attr.code, value, frame=frame)

    def get_value(self, attr, frame=None):
        """Read an attribute value pre-bake (Attr::getValue
        counterpart)."""
        return self._attr_builder.get_value(attr.code, frame=frame)

    def _register_transform(self, node):
        if node.parent is not None and node.parent.index is None:
            raise ValueError("parent must be created before child")
        node.index = len(self._transforms)
        self._transforms.append(node)

    def create_transform(self, name, parent=None,
                         rotate_order=RotateOrder.XYZ, **values):
        self._check_name(name)
        node = TransformNode(self, name, parent, rotate_order)
        self._register_transform(node)
        self._add_attrs(node, _TFM_DEFAULTS, values)
        return node

    def create_camera(self, name, parent=None, rotate_order=RotateOrder.XYZ,
                      film_fit=FilmFit.HORIZONTAL, render_width=1920,
                      render_height=1080, **values):
        self._check_name(name)
        node = CameraNode(self, name, parent, rotate_order, film_fit,
                          render_width, render_height)
        self._register_transform(node)
        node.cam_index = len(self._cameras)
        self._cameras.append(node)
        tfm_values = {k: v for k, v in values.items() if k in _TFM_DEFAULTS}
        cam_values = {k: v for k, v in values.items() if k in _CAM_DEFAULTS}
        unknown = set(values) - set(tfm_values) - set(cam_values)
        if unknown:
            raise ValueError("unknown camera attrs: %r" % sorted(unknown))
        self._add_attrs(node, _TFM_DEFAULTS, tfm_values)
        self._add_attrs(node, _CAM_DEFAULTS, cam_values)
        return node

    def create_bundle(self, name, parent=None,
                      rotate_order=RotateOrder.XYZ, **values):
        self._check_name(name)
        node = BundleNode(self, name, parent, rotate_order)
        self._register_transform(node)
        node.bnd_index = len(self._bundles)
        self._bundles.append(node)
        self._add_attrs(node, _TFM_DEFAULTS, values)
        return node

    def create_marker_group(self, name, camera=None, **values):
        """Create a MarkerGroup with (optionally animated) overscan_x/y
        scale attributes shared by its markers."""
        self._check_name(name)
        node = MarkerGroupNode(self, name, camera)
        self._add_attrs(node, _MKR_GROUP_DEFAULTS, values)
        return node

    def create_marker(self, name, camera, bundle, group=None, **values):
        self._check_name(name)
        if camera.cam_index is None:
            raise ValueError("marker camera must be a CameraNode")
        if bundle.bnd_index is None:
            raise ValueError("marker bundle must be a BundleNode")
        node = MarkerNode(self, name, camera, bundle, group=group)
        node.mkr_index = len(self._markers)
        self._markers.append(node)
        self._add_attrs(node, _MKR_DEFAULTS, values)
        if group is not None:
            # Share the group's overscan attribute codes.
            node.attrs["overscan_x"] = group.attr("overscan_x")
            node.attrs["overscan_y"] = group.attr("overscan_y")
        return node

    def create_line(self, name, markers, weight=1.0):
        """Create a Line over >= 2 markers (straightness constraint)."""
        self._check_name(name)
        markers = list(markers)
        if len(markers) < 2:
            raise ValueError("a line needs at least 2 markers")
        for m in markers:
            if m.mkr_index is None:
                raise ValueError("line members must be MarkerNodes")
        node = LineNode(self, name, markers, weight)
        self._lines.append(node)
        return node

    def line_spec(self, lines=None):
        """Padded line arrays for the solver (build_problem lines=).

        lines: LineNodes to include (default: all created lines).
        Returns dict(mkr_index (L, K), mkr_mask (L, K), weight (L,)).
        """
        if lines is None:
            lines = self._lines
        if not lines:
            return None
        k = max(len(ln.markers) for ln in lines)
        mkr_index = np.zeros((len(lines), k), np.int32)
        mkr_mask = np.zeros((len(lines), k), bool)
        weight = np.zeros(len(lines))
        for li, ln in enumerate(lines):
            for mi, m in enumerate(ln.markers):
                mkr_index[li, mi] = m.mkr_index
                mkr_mask[li, mi] = True
            weight[li] = ln.weight
        return dict(mkr_index=mkr_index, mkr_mask=mkr_mask,
                    weight=weight)

    def bake(self, dtype=None, *, device):
        """Flatten to (FlatScene, AttrBlock) on `device`."""
        if not self._cameras or not self._markers or not self._bundles:
            raise ValueError(
                "scene needs at least one camera, bundle and marker "
                "(ref: scene/flat.rs:185-190 asserts the same)"
            )
        attrs = self._attr_builder.bake(dtype=dtype, device=device)
        tfm_attr_codes = np.array(
            [
                [t.attr_code(n) for n in flatscene.TFM_ATTRS]
                for t in self._transforms
            ],
            dtype=np.int32,
        )
        tfm_rotate_order = np.array(
            [t.rotate_order for t in self._transforms], dtype=np.int32
        )
        tfm_parent = np.array(
            [
                -1 if t.parent is None else t.parent.index
                for t in self._transforms
            ],
            dtype=np.int32,
        )
        cam_tfm_index = np.array(
            [c.index for c in self._cameras], dtype=np.int32
        )
        cam_attr_codes = np.array(
            [
                [c.attr_code(n) for n in flatscene.CAM_ATTRS]
                for c in self._cameras
            ],
            dtype=np.int32,
        )
        cam_film_fit = np.array(
            [c.film_fit for c in self._cameras], dtype=np.int32
        )
        cam_render_size = np.array(
            [[c.render_width, c.render_height] for c in self._cameras],
            dtype=np.float64,
        )
        bnd_tfm_index = np.array(
            [b.index for b in self._bundles], dtype=np.int32
        )
        mkr_cam_index = np.array(
            [m.camera.cam_index for m in self._markers], dtype=np.int32
        )
        mkr_bnd_index = np.array(
            [m.bundle.bnd_index for m in self._markers], dtype=np.int32
        )
        mkr_attr_codes = np.array(
            [
                [m.attr_code(n) for n in flatscene.MKR_ATTRS]
                for m in self._markers
            ],
            dtype=np.int32,
        )
        scene = flatscene.flat_scene_from_numpy(
            tfm_attr_codes,
            tfm_rotate_order,
            tfm_parent,
            cam_tfm_index,
            cam_attr_codes,
            cam_film_fit,
            cam_render_size,
            bnd_tfm_index,
            mkr_cam_index,
            mkr_bnd_index,
            mkr_attr_codes,
            device=device,
            dtype=attrs.static_values.dtype,
        )
        return scene, attrs
