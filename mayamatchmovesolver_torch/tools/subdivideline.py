"""Subdivide-line data capability.

The reference tool inserts a new marker in the middle of each selected
line segment and rebuilds the line's member list
(ref: python/mmSolver/tools/subdivideline/lib.py:85-121 subdivide_line
— returns (all markers of the new line, newly created markers);
_create_new_marker_pair places the new marker at the segment average).
Here lines are scene-graph LineNodes: the new markers are created with
the averaged animated 2D positions of their segment endpoints (and a
bundle midway between the endpoint bundles), and a new LineNode with
the interleaved member order replaces the old constraint.

Port of mayamatchmovesolver_tpu/tools/subdivideline.py: a copy of the
reference's host code.
"""

import numpy as np


def _marker_value_arrays(sg, marker):
    """Per-frame (tx, ty, weight, enable) arrays for a marker."""
    n = sg.num_frames
    out = {}
    for ch in ("tx", "ty", "weight", "enable"):
        attr = marker.attr(ch)
        vals = np.array([
            sg.get_value(attr, frame=f) for f in range(n)
        ], float)
        out[ch] = vals
    return out


def subdivide_line(sg, line, markers=None, name_prefix=None):
    """Insert a midpoint marker between each consecutive marker pair.

    sg: the SceneGraph that owns the line.  markers: the subset whose
    segments to subdivide (default: all consecutive pairs, like
    selecting the whole line).  Returns (new_line, all_markers,
    new_markers) — the counterpart of the reference's
    (all_mkr_list, new_mkr_list) plus the rebuilt line node.
    """
    members = list(line.markers)
    if markers is None:
        markers = members
    chosen = set(id(m) for m in markers)
    prefix = name_prefix or (line.name + "_sub")

    all_markers = []
    new_markers = []
    counter = 0
    for i, mkr in enumerate(members):
        all_markers.append(mkr)
        if i + 1 >= len(members):
            break
        nxt = members[i + 1]
        if id(mkr) not in chosen or id(nxt) not in chosen:
            continue
        a = _marker_value_arrays(sg, mkr)
        b = _marker_value_arrays(sg, nxt)
        mid_tx = 0.5 * (a["tx"] + b["tx"])
        mid_ty = 0.5 * (a["ty"] + b["ty"])
        mid_w = 0.5 * (a["weight"] + b["weight"])
        mid_en = np.minimum(a["enable"], b["enable"])

        bnd_pos = []
        for ch in ("tx", "ty", "tz"):
            pa = float(sg.get_value(mkr.bundle.attr(ch)))
            pb = float(sg.get_value(nxt.bundle.attr(ch)))
            bnd_pos.append(0.5 * (pa + pb))
        counter += 1
        bnd = sg.create_bundle(
            "%s_bnd_%d" % (prefix, counter),
            tx=bnd_pos[0], ty=bnd_pos[1], tz=bnd_pos[2],
        )
        new_mkr = sg.create_marker(
            "%s_mkr_%d" % (prefix, counter),
            camera=mkr.camera, bundle=bnd, group=mkr.group,
            tx=mid_tx, ty=mid_ty, weight=mid_w, enable=mid_en,
        )
        all_markers.append(new_mkr)
        new_markers.append(new_mkr)

    new_line = sg.create_line(
        "%s_line_%d" % (prefix, len(sg._lines)), all_markers,
        weight=line.weight,
    )
    return new_line, all_markers, new_markers
