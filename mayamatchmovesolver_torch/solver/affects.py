"""Marker <-> attribute relationship analysis.

Copy of mayamatchmovesolver_tpu/solver/affects.py (numpy only; it walks
this package's scene-graph nodes), the counterpart of the reference's
affects system
(ref: src/mmSolver/adjust/adjust_relationships.cpp:369-565
findMarkerToAttributeRelationship / findErrorToParameterRelationship,
the mmSolverAffects command MMSolverAffectsCmd.cpp:214, and the Python
plug-graph walker python/mmSolver/utils/nodeaffects.py:331-403).

The reference asks Maya which plugs affect which marker transforms; here
the scene graph is explicit, so the rule set is direct:

an attribute affects a marker iff it lives on
  * the marker itself (position/weight/enable),
  * the marker's bundle or any ancestor of it,
  * the marker's camera or any ancestor of it (transform attrs),
  * the marker's camera's intrinsic or lens attributes.

The result feeds problem validation, the used/unused split
(ref: splitUsedMarkersAndAttributes, adjust_base.cpp:574) and the
error->parameter sparsity mask (the reference's errorToParamList
bitmap, adjust_solveFunc.cpp:187-226 — which in this framework is also
the exact sparsity pattern of the analytic Jacobian).
"""

import numpy as np


def _ancestors_inclusive(node):
    out = []
    cur = node
    while cur is not None:
        out.append(cur)
        cur = getattr(cur, "parent", None)
    return out


def marker_attr_affects(markers, attrs):
    """(M, A) bool: does attrs[a] affect markers[m]?

    (ref: getMarkerToAttributeRelationship,
    adjust_relationships.cpp:475.)
    """
    matrix = np.zeros((len(markers), len(attrs)), dtype=bool)
    for mi, marker in enumerate(markers):
        nodes = {id(marker)}
        for node in _ancestors_inclusive(marker.bundle):
            nodes.add(id(node))
        for node in _ancestors_inclusive(marker.camera):
            nodes.add(id(node))
        for ai, attr in enumerate(attrs):
            matrix[mi, ai] = id(attr.node) in nodes
    return matrix


def split_used_markers_and_attributes(markers, attrs):
    """Partition into (used, unused) like the reference
    (ref: splitUsedMarkersAndAttributes, adjust_base.cpp:574):
    a marker is used if at least one attr affects it; an attr is used
    if it affects at least one marker."""
    matrix = marker_attr_affects(markers, attrs)
    used_markers = [m for i, m in enumerate(markers) if matrix[i].any()]
    unused_markers = [
        m for i, m in enumerate(markers) if not matrix[i].any()
    ]
    used_attrs = [a for j, a in enumerate(attrs) if matrix[:, j].any()]
    unused_attrs = [
        a for j, a in enumerate(attrs) if not matrix[:, j].any()
    ]
    return used_markers, unused_markers, used_attrs, unused_attrs


def error_to_parameter_matrix(markers, attrs, num_frames,
                              param_codes=None, param_frames=None):
    """Expand the marker/attr matrix to the (errors x parameters) mask.

    (ref: findErrorToParameterRelationship,
    adjust_relationships.cpp:565.)  Errors are (marker, frame, xy)
    triples flattened marker-major; parameters follow the
    build_problem layout (animated attrs expand per frame).
    Returns (M*F*2, P) bool.
    """
    m_a = marker_attr_affects(markers, attrs)
    num_markers = len(markers)

    cols = []  # one (attr index, frame or None) per parameter
    for ai, attr in enumerate(attrs):
        if attr.code % 2 == 1:
            for f in range(num_frames):
                cols.append((ai, f))
        else:
            cols.append((ai, None))

    out = np.zeros((num_markers * num_frames * 2, len(cols)), dtype=bool)
    for pi, (ai, pf) in enumerate(cols):
        for mi in range(num_markers):
            if not m_a[mi, ai]:
                continue
            for f in range(num_frames):
                if pf is not None and pf != f:
                    # An animated parameter only affects its own frame
                    # (ref: adjust_relationships.cpp:565 expansion).
                    continue
                base = (mi * num_frames + f) * 2
                out[base: base + 2, pi] = True
    return out


def affects_summary_string(markers, attrs):
    """Human-readable summary, the spirit of
    `mmSolverAffects -mode returnString` (MMSolverAffectsCmd.cpp)."""
    matrix = marker_attr_affects(markers, attrs)
    lines = []
    for mi, marker in enumerate(markers):
        hit = [attrs[j] for j in np.nonzero(matrix[mi])[0]]
        lines.append(
            "%s: %s"
            % (
                marker.name,
                ", ".join(
                    "%s.%s" % (a.node.name, a.name) for a in hit
                ) or "(none)",
            )
        )
    return "\n".join(lines)
