"""Object-oriented user API.

Port of mayamatchmovesolver_tpu/api.py, the counterpart of the
reference's Python API
(ref: python/mmSolver/api.py re-exporting python/mmSolver/_api):
Camera/Bundle/Marker/Attribute wrappers come from the scene graph; this
module adds the Collection + Solver + execute() workflow
(ref: _api/collection.py:218, _api/_execute/main.py:215) on top of the
solve engine.  execute() bakes the scene graph onto the device it is
given and runs the whole schedule there.

Typical use:

    import mayamatchmovesolver_torch.api as mmapi

    sg = mmapi.SceneGraph(frame_range=(1, 100))
    cam = sg.create_camera('cam', ...)
    bnd = sg.create_bundle('bnd', ...)
    mkr = sg.create_marker('mkr', camera=cam, bundle=bnd, ...)

    col = mmapi.Collection(sg)
    col.add_marker(mkr)
    col.add_attribute(bnd.attr('tx'))
    col.set_solver(mmapi.SolverStandard(frame_indices=range(100)))
    attrs, results = mmapi.execute(col, device="cuda")
"""

import dataclasses
from typing import List, Optional

import numpy as np

from mayamatchmovesolver_torch.scene.scenegraph import (  # noqa: F401
    Attribute,
    BundleNode as Bundle,
    CameraNode as Camera,
    MarkerNode as Marker,
    SceneGraph,
    TransformNode as Transform,
)
from mayamatchmovesolver_torch.models import scenelens  # noqa: F401
from mayamatchmovesolver_torch.solver import affects as affects_mod
from mayamatchmovesolver_torch.solver.solve import (
    SolverOptions,
    build_stiffness,
    merge_stiffness,
)
from mayamatchmovesolver_torch.solver.strategies import (  # noqa: F401
    SolverBasic,
    SolverCamera,
    SolverStandard,
    SolverStep,
    SolverTriangulate,
)
from mayamatchmovesolver_torch.solver import results as results_mod


class Frame:
    """A frame number plus tags (ref: python/mmSolver/_api/frame.py —
    Frame(value, tags, primary, secondary)).  Solver classes accept
    Frame objects anywhere they take frame indices."""

    def __init__(self, value, tags=None, primary=False, secondary=False):
        self.value = int(value)
        self.tags = list(tags or [])
        if primary and "primary" not in self.tags:
            self.tags.append("primary")
        if secondary and "secondary" not in self.tags:
            self.tags.append("secondary")

    def get_number(self):
        return self.value

    def get_tags(self):
        return list(self.tags)

    @property
    def primary(self):
        return "primary" in self.tags

    @property
    def secondary(self):
        return "secondary" in self.tags

    def __int__(self):
        return self.value

    def __repr__(self):
        return "Frame(%d%s)" % (
            self.value, ", tags=%r" % self.tags if self.tags else ""
        )


class Lens:
    """OO wrapper over one lens layer of a camera
    (ref: python/mmSolver/_api/lens.py — Lens nodes hold the 3DE model
    parameters; here the layer's parameters are scene attributes,
    solvable like any other).  Create layers with
    scenelens.attach_lens / attach_lens_file, then wrap:

        lens = mmapi.Lens(cam, layer_index=0)
        col.add_attribute(lens.attr('distortion'))
    """

    def __init__(self, camera, layer_index=0):
        layers = getattr(camera, "lens_layers", None)
        if not layers:
            raise ValueError("camera %r has no lens layers" % camera.name)
        self.camera = camera
        self.layer_index = int(layer_index)
        self.model_type, self._attrs = layers[self.layer_index]

    def attr(self, name) -> Attribute:
        return self._attrs[name]

    def get_attribute_list(self):
        return list(self._attrs.values())

    @property
    def parameter_names(self):
        return sorted(self._attrs)

    @staticmethod
    def layer_count(camera):
        return len(getattr(camera, "lens_layers", []) or [])

    def __repr__(self):
        return "Lens(%s, layer=%d, model=%s)" % (
            self.camera.name, self.layer_index, self.model_type
        )


@dataclasses.dataclass
class Collection:
    """A solve set: markers to measure, attributes to adjust, a solver
    schedule (ref: _api/collection.py:218 — stored as a Maya set there;
    plain Python here)."""

    scene_graph: SceneGraph
    markers: List[Marker] = dataclasses.field(default_factory=list)
    attributes: List[Attribute] = dataclasses.field(default_factory=list)
    solver: Optional[object] = None
    options: SolverOptions = dataclasses.field(
        default_factory=SolverOptions
    )
    # Per-attribute soft-constraint weights, keyed by attr code
    # (ref: the per-attr stiffness/smoothness values the reference
    # stores as auxiliary attrs on the Collection node,
    # _api/collection.py:680-754, compiled at compile.py:486-589).
    stiffness_weights: dict = dataclasses.field(default_factory=dict)
    stiffness_variances: dict = dataclasses.field(default_factory=dict)
    smoothness_weights: dict = dataclasses.field(default_factory=dict)
    smoothness_variances: dict = dataclasses.field(default_factory=dict)
    # Line straightness constraints (ref: _api/line.py Line objects in
    # the solve set; mmLineBestFit residuals).
    lines: List[object] = dataclasses.field(default_factory=list)
    # Results of the most recent execute() — the v2 results-node
    # surface (ref: MMSolver2Cmd writes typed results onto the
    # Collection node, adjust_results_setSolveData.cpp).
    last_results: List[object] = dataclasses.field(default_factory=list)

    def add_marker(self, *markers):
        for m in markers:
            if m not in self.markers:
                self.markers.append(m)
        return self

    def add_attribute(self, *attrs):
        for a in attrs:
            if a not in self.attributes:
                self.attributes.append(a)
        return self

    def set_solver(self, solver):
        self.solver = solver
        return self

    def add_line(self, *lines):
        """Add Line straightness constraints (scene_graph.create_line)
        to the solve (ref: Line objects in the reference's Collection,
        _api/line.py + collection.py)."""
        for ln in lines:
            if ln not in self.lines:
                self.lines.append(ln)
        return self

    def set_attribute_stiffness(self, attr, weight, variance=1.0):
        """Pull `attr` toward its previous-frame value during solves
        (ref: attrStiffness flag, compile.py:486-530)."""
        self.stiffness_weights[attr.code] = float(weight)
        self.stiffness_variances[attr.code] = float(variance)
        return self

    def set_attribute_smoothness(self, attr, weight, variance=1.0):
        """Pull `attr` toward the linear prediction of its two previous
        frames (ref: attrSmoothness flag, compile.py:531-589)."""
        self.smoothness_weights[attr.code] = float(weight)
        self.smoothness_variances[attr.code] = float(variance)
        return self

    def get_marker_list(self):
        return list(self.markers)

    def get_attribute_list(self):
        return list(self.attributes)


def validate(collection: Collection):
    """Problem validation before execution
    (ref: _execute/main.py:51 validate action twins +
    adjust_base.cpp:864-882 sizing checks).  Returns (ok, messages)."""
    messages = []
    needs_attrs = getattr(collection.solver, "requires_attributes", True)
    if not collection.markers:
        messages.append("collection has no markers")
    if not collection.attributes and needs_attrs:
        messages.append("collection has no attributes")
    if collection.solver is None:
        messages.append("collection has no solver")
    # errors >= parameters on at least the full frame set.
    if collection.markers and collection.attributes and needs_attrs:
        frames = getattr(collection.solver, "frame_indices", [0])
        n_frames = max(len(list(frames)), 1)
        num_errors = len(collection.markers) * n_frames * 2
        num_params = 0
        for a in collection.attributes:
            num_params += n_frames if a.code % 2 == 1 else 1
        if num_errors < num_params:
            messages.append(
                "not enough marker errors (%d) for parameters (%d)"
                % (num_errors, num_params)
            )
    return (not messages), messages


def execute(collection: Collection, options: Optional[SolverOptions] = None,
            lens=None, *, device, dtype=None):
    """Compile + run the collection's solver schedule on `device`, in
    `dtype` (the scene graph's when None).

    (ref: _api/_execute/main.py:215-544 — minus the Maya viewport/
    evaluation-manager management that has no meaning here.)
    Returns (new_attrs, [SolverResult]).  The scene graph's baked attrs
    are used as the starting state.
    """
    ok, messages = validate(collection)
    if not ok:
        result = results_mod.SolverResult()
        result.success = False
        result.reason_string = "; ".join(messages)
        return None, [result]

    options = options or collection.options
    scene, attrs = collection.scene_graph.bake(dtype, device=device)
    if lens is None:
        baked_lens = scenelens.bake_scene_lens(collection.scene_graph,
                                               device=device)
        lens = baked_lens if baked_lens.has_any() else None

    # Only the collection's markers measure error (the reference
    # restricts the solve to the Collection set's members,
    # _api/collection.py; markers outside the set are ignored).
    marker_mask = None
    all_markers = collection.scene_graph._markers
    if len(collection.markers) != len(all_markers):
        marker_mask = np.zeros(len(all_markers), dtype=bool)
        for m in collection.markers:
            marker_mask[m.mkr_index] = True

    # Exclude attributes that affect none of the collection's markers:
    # their Jacobian columns are structurally zero and would make the
    # normal equations singular (the reference splits and drops them
    # before solving; ref: splitUsedMarkersAndAttributes,
    # adjust_base.cpp:574, driven by the affects analysis).
    solve_attributes = collection.attributes
    if solve_attributes and getattr(collection.solver,
                                    "requires_attributes", True):
        # Locked attributes never enter the solve (ref: the compile
        # layer skips locked attrs, _api/attribute.py is_locked +
        # compile.py attribute filtering).
        solve_attributes = [
            a for a in solve_attributes
            if not getattr(a, "locked", False)
        ]
        if not solve_attributes:
            result = results_mod.SolverResult()
            result.success = False
            result.reason_string = "all attributes are locked"
            collection.last_results = [result]
            return None, [result]
        _, _, used_attrs, unused_attrs = (
            affects_mod.split_used_markers_and_attributes(
                collection.markers, solve_attributes
            )
        )
        if unused_attrs:
            solve_attributes = used_attrs
        if not solve_attributes:
            result = results_mod.SolverResult()
            result.success = False
            result.reason_string = (
                "no attribute affects any collection marker"
            )
            collection.last_results = [result]
            return None, [result]

    # Per-attribute stiffness/smoothness soft constraints.
    stiffness = None
    if collection.stiffness_weights or collection.smoothness_weights:
        frames = list(
            getattr(collection.solver, "frame_indices",
                    range(collection.scene_graph.num_frames))
        )
        specs = []
        if collection.stiffness_weights:
            specs.append(build_stiffness(
                attrs, collection.attributes, frames,
                weight=collection.stiffness_weights,
                variance=dict(collection.stiffness_variances),
                mode="stiffness",
            ))
        if collection.smoothness_weights:
            specs.append(build_stiffness(
                attrs, collection.attributes, frames,
                weight=collection.smoothness_weights,
                variance=dict(collection.smoothness_variances),
                mode="smoothness",
            ))
        stiffness = merge_stiffness(*specs)

    lines = (
        collection.scene_graph.line_spec(collection.lines)
        if collection.lines else None
    )

    solver = collection.solver
    new_attrs, results = solver.execute(
        scene, attrs, solve_attributes, options,
        lens=lens, marker_mask=marker_mask, stiffness=stiffness,
        lines=lines,
    )
    # v2 semantics: solve results persist on the Collection (the
    # reference's mmSolver_v2 writes typed results onto the Collection
    # node instead of returning strings; ref: MMSolver2Cmd.cpp:103-148,
    # adjust_results_setSolveData.cpp, _execute/main.py:128-155).
    collection.last_results = results
    return new_attrs, results


def combine_results(result_lists) -> dict:
    """Merge SolveResults like the reference's solveresult helpers
    (ref: _api/solveresult.py combine_timer_stats/merge_frame_error_list).
    """
    merged = {
        "success": all(r.success for r in result_lists),
        "error_final": (
            result_lists[-1].error_final if result_lists else None
        ),
        "total_iterations": sum(r.iterations for r in result_lists),
        "total_function_evals": sum(
            r.function_evals for r in result_lists
        ),
        "total_solve_seconds": sum(
            r.timer.solve_seconds for r in result_lists
        ),
        "per_frame_error": {},
    }
    for r in result_lists:
        merged["per_frame_error"].update(r.per_frame_error.as_dict())
    return merged
