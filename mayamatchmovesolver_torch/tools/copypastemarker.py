"""Copy/paste-marker data capability.

The reference tool saves the selected markers to a temporary .uv file
(uvtrack format) and puts the path on the clipboard for third-party
software (ref: python/mmSolver/tools/copypastemarker/tool.py, which
routes through tools/savemarkerfile/lib.py), and loadmarker pastes
them back.  Here copy produces the uvtrack file/text directly from the
scene graph and paste instantiates markers from it — the same
round-trip minus the OS clipboard.

Port of mayamatchmovesolver_tpu/tools/copypastemarker.py: a copy of the
reference's host code, on the port's SceneGraph, io.uvtrack and
io.markerdata.
"""

import json
import os
import tempfile


from mayamatchmovesolver_torch.io import markerdata as markerdata_mod
from mayamatchmovesolver_torch.io import uvtrack


def marker_to_marker_data(sg, marker, uv_from_marker_space=True):
    """SceneGraph MarkerNode -> io.MarkerData (UV [0, 1] space, like
    the reference's savemarkerfile which shifts marker space by +0.5)."""
    md = markerdata_mod.MarkerData(name=marker.name)
    offset = 0.5 if uv_from_marker_space else 0.0
    frames = sg.frames
    for fi, frame in enumerate(frames):
        md.x.set_value(int(frame),
                       float(sg.get_value(marker.attr("tx"), frame=fi))
                       + offset)
        md.y.set_value(int(frame),
                       float(sg.get_value(marker.attr("ty"), frame=fi))
                       + offset)
        md.weight.set_value(
            int(frame),
            float(sg.get_value(marker.attr("weight"), frame=fi)),
        )
        md.enable.set_value(
            int(frame),
            int(float(sg.get_value(marker.attr("enable"), frame=fi))
                > 0.5),
        )
    if marker.bundle is not None:
        md.bundle_x = float(sg.get_value(marker.bundle.attr("tx")))
        md.bundle_y = float(sg.get_value(marker.bundle.attr("ty")))
        md.bundle_z = float(sg.get_value(marker.bundle.attr("tz")))
    return md


def copy_markers_to_file(sg, markers, file_path=None, version=4):
    """Write markers to a uvtrack file; returns the path (a fresh temp
    .uv file when none is given — the reference's clipboard payload,
    copypastemarker/tool.py)."""
    mkr_data = [marker_to_marker_data(sg, m) for m in markers]
    if file_path is None:
        fd, file_path = tempfile.mkstemp(
            suffix=".uv", prefix="mmtpu_marker_"
        )
        os.close(fd)
    uvtrack.write(file_path, mkr_data, version=version)
    return file_path


def copy_markers_to_string(sg, markers, version=4):
    """The uvtrack JSON text itself (versions 2-4)."""
    if version < 2:
        raise ValueError("string copy requires a JSON version (2-4)")
    path = copy_markers_to_file(sg, markers, version=version)
    try:
        with open(path) as f:
            return f.read()
    finally:
        os.unlink(path)


def paste_markers(sg, camera, source):
    """Create markers (+bundles) in `sg` under `camera` from a uvtrack
    file path or JSON text (the loadmarker half of the round-trip).

    Returns [(MarkerNode, BundleNode), ...]."""
    from mayamatchmovesolver_torch.io.markerdata import markers_to_scene

    if os.path.exists(source):
        _, mkr_data = uvtrack.parse(source)
    else:
        data = json.loads(source)
        fd, tmp = tempfile.mkstemp(suffix=".uv")
        os.close(fd)
        try:
            with open(tmp, "w") as f:
                json.dump(data, f)
            _, mkr_data = uvtrack.parse(tmp)
        finally:
            os.unlink(tmp)
    # Avoid duplicate node names on repeated pastes.
    existing = set(sg._names)
    for i, md in enumerate(mkr_data):
        base = md.name or ("marker%d" % i)
        name = base
        n = 1
        while name in existing or ("%s_bnd" % name) in existing:
            name = "%s_paste%d" % (base, n)
            n += 1
        md.name = name
        existing.add(name)
    return markers_to_scene(mkr_data, sg, camera)
