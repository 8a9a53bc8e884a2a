"""uvtrack marker format: versions 1-4, read and write.

Re-implementation of the reference's LoaderUVTrack
(ref: python/mmSolver/utils/loadmarker/formats/uvtrack.py:396-578):
  v1 — ASCII: count, then per-point name/frame-count/rows
       "frame u v weight"
  v2 — JSON {'version':2, 'points':[{'name','id','set_name','per_frame':
       [{'frame','pos':[u,v],'weight'}]}]}
  v3 — + 'pos_dist' distorted positions and '3d' bundle data
  v4 — + 'camera' block with film back + per-frame focal length
All positions are UV space [0,1], v up.

A copy of mayamatchmovesolver_tpu/io/uvtrack.py (host code, no tensors):
the port imports nothing of the JAX package.
"""

import json

from mayamatchmovesolver_torch.io.markerdata import (
    FileInfo,
    MarkerData,
    fill_occluded_frames,
)


class ParserError(Exception):
    pass


def determine_format_version(file_path):
    """v1 is plain ASCII (first token an int); v2+ are JSON with a
    'version' key (ref: uvtrack.py determine_format_version)."""
    with open(file_path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except ValueError:
        return 1
    if isinstance(data, dict):
        return int(data.get("version", 2))
    return 1


def parse_v1(file_path):
    """(ref: uvtrack.py:396-468.)"""
    with open(file_path) as f:
        lines = f.readlines()
    if not lines:
        raise OSError("No contents in the file: %s" % file_path)
    num_points = int(lines[0])
    if num_points < 1:
        raise ParserError("No points exist.")
    mkr_data_list = []
    idx = 1
    for _ in range(num_points):
        name = lines[idx].strip()
        md = MarkerData(name=name)
        idx += 1
        num_frames = int(lines[idx])
        if num_frames <= 0:
            idx += 1
            continue
        frames = []
        j = num_frames
        while j > 0:
            idx += 1
            line = lines[idx].strip()
            if not line:
                break
            j -= 1
            split = line.split()
            if len(split) != 4:
                raise ParserError(
                    "File invalid, there must be 4 numbers in a line: %r"
                    % line
                )
            frame = int(split[0])
            md.x.set_value(frame, float(split[1]))
            md.y.set_value(frame, float(split[2]))
            md.weight.set_value(frame, float(split[3]))
            frames.append(frame)
        fill_occluded_frames(md, frames)
        mkr_data_list.append(md)
        idx += 1
    return FileInfo(marker_undistorted=True), mkr_data_list


def _parse_points_json(data, undistorted=True, with_3d_pos=False):
    pos_key = "pos" if undistorted else "pos_dist"
    out = []
    for point in data.get("points", []):
        md = MarkerData(
            name=point.get("name", ""),
            id=point.get("id"),
            group_name=point.get("set_name", ""),
        )
        if with_3d_pos and isinstance(point.get("3d"), dict):
            p3 = point["3d"]
            md.bundle_x = p3.get("x")
            md.bundle_y = p3.get("y")
            md.bundle_z = p3.get("z")
            md.bundle_lock_x = p3.get("x_lock")
            md.bundle_lock_y = p3.get("y_lock")
            md.bundle_lock_z = p3.get("z_lock")
        frames = []
        for fd in point.get("per_frame", []):
            frame = fd["frame"]
            pos = fd.get(pos_key) or fd.get("pos")
            if pos is None:
                continue
            md.x.set_value(frame, pos[0])
            md.y.set_value(frame, pos[1])
            md.weight.set_value(frame, fd.get("weight", 1.0))
            md.enable.set_value(frame, 1)
            frames.append(frame)
        if not frames:
            continue
        fill_occluded_frames(md, frames)
        out.append(md)
    return out


def _parse_camera_fov_v4(data):
    """(ref: uvtrack.py:365-394.)"""
    import math

    camera = data.get("camera", {})
    if not camera:
        return None
    film_back_x, film_back_y = camera["film_back_cm"]
    fov = []
    for fd in camera.get("per_frame", []):
        focal_cm = fd["focal_length_cm"]
        angle_x = math.degrees(
            2.0 * math.atan(film_back_x / (2.0 * focal_cm))
        )
        angle_y = math.degrees(
            2.0 * math.atan(film_back_y / (2.0 * focal_cm))
        )
        fov.append((fd["frame"], angle_x, angle_y))
    return fov


def parse(file_path, undistorted=True, with_3d_pos=True):
    """Parse any uvtrack version; returns (FileInfo, [MarkerData])."""
    version = determine_format_version(file_path)
    if version == 1:
        return parse_v1(file_path)
    with open(file_path) as f:
        data = json.load(f)
    if version == 2:
        info = FileInfo(marker_undistorted=True)
        points = _parse_points_json(data, True, False)
    elif version == 3:
        info = FileInfo(marker_distorted=True, marker_undistorted=True,
                        bundle_positions=True)
        points = _parse_points_json(data, undistorted, with_3d_pos)
    elif version == 4:
        info = FileInfo(
            marker_distorted=True,
            marker_undistorted=True,
            bundle_positions=True,
            camera_field_of_view=_parse_camera_fov_v4(data),
        )
        points = _parse_points_json(data, undistorted, with_3d_pos)
    else:
        raise ParserError("Unknown uvtrack version: %r" % version)
    return info, points


def write_v4(file_path, mkr_data_list, camera_block=None):
    """Write uvtrack v4 JSON (the savemarkerfile capability;
    ref: python/mmSolver/tools/savemarkerfile)."""
    points = []
    for md in mkr_data_list:
        per_frame = []
        for frame in md.x.get_times():
            if md.enable.get_value(frame, 1) in (0, 0.0, False):
                continue
            per_frame.append(
                {
                    "frame": int(frame),
                    "pos": [md.x.get_value(frame),
                            md.y.get_value(frame)],
                    "pos_dist": [md.x.get_value(frame),
                                 md.y.get_value(frame)],
                    "weight": md.weight.get_value(frame, 1.0),
                }
            )
        entry = {
            "name": md.name,
            "id": md.id,
            "set_name": md.group_name,
            "per_frame": per_frame,
        }
        if md.bundle_x is not None:
            entry["3d"] = {
                "x": md.bundle_x,
                "y": md.bundle_y,
                "z": md.bundle_z,
                "x_lock": md.bundle_lock_x,
                "y_lock": md.bundle_lock_y,
                "z_lock": md.bundle_lock_z,
            }
        points.append(entry)
    data = {
        "version": 4,
        "num_points": len(points),
        "is_undistorted": None,  # deprecated field, kept for parity
        "points": points,
    }
    if camera_block is not None:
        data["camera"] = camera_block
    with open(file_path, "w") as f:
        json.dump(data, f, indent=1)


def _point_entry(md, version):
    """One point's JSON entry for the given format version."""
    per_frame = []
    for frame in md.x.get_times():
        if md.enable.get_value(frame, 1) in (0, 0.0, False):
            continue
        row = {
            "frame": int(frame),
            "pos": [md.x.get_value(frame), md.y.get_value(frame)],
            "weight": md.weight.get_value(frame, 1.0),
        }
        if version >= 3:
            row["pos_dist"] = list(row["pos"])
        per_frame.append(row)
    entry = {
        "name": md.name,
        "id": md.id,
        "set_name": md.group_name,
        "per_frame": per_frame,
    }
    if version >= 3 and md.bundle_x is not None:
        entry["3d"] = {
            "x": md.bundle_x,
            "y": md.bundle_y,
            "z": md.bundle_z,
            "x_lock": md.bundle_lock_x,
            "y_lock": md.bundle_lock_y,
            "z_lock": md.bundle_lock_z,
        }
    return entry


def write_v1(file_path, mkr_data_list):
    """ASCII v1: the format the 3DE/SynthEyes exporter scripts emit
    (ref: uvtrack.py v1 docstring; share/3dequalizer exporters)."""
    lines = ["%d\n" % len(mkr_data_list)]
    for md in mkr_data_list:
        frames = [
            f for f in md.x.get_times()
            if md.enable.get_value(f, 1) not in (0, 0.0, False)
        ]
        lines.append("%s\n" % (md.name or ""))
        lines.append("%d\n" % len(frames))
        for f in frames:
            lines.append(
                "%d %.15g %.15g %.15g\n"
                % (int(f), md.x.get_value(f), md.y.get_value(f),
                   md.weight.get_value(f, 1.0))
            )
    with open(file_path, "w") as fobj:
        fobj.writelines(lines)


def _write_json(file_path, mkr_data_list, version, camera_block=None,
                is_undistorted=None):
    points = [_point_entry(md, version) for md in mkr_data_list]
    data = {
        "version": int(version),
        "num_points": len(points),
        "is_undistorted": is_undistorted,
        "points": points,
    }
    if camera_block is not None and version >= 4:
        data["camera"] = camera_block
    with open(file_path, "w") as f:
        json.dump(data, f, indent=1)


def write_v2(file_path, mkr_data_list, is_undistorted=True):
    """JSON v2 (ref: uvtrack.py format-2 docstring — no 3D, no
    pos_dist; is_undistorted still meaningful)."""
    _write_json(file_path, mkr_data_list, 2,
                is_undistorted=bool(is_undistorted))


def write_v3(file_path, mkr_data_list):
    """JSON v3 (ref: uvtrack.py format-3 docstring — pos+pos_dist,
    optional '3d' bundle block)."""
    _write_json(file_path, mkr_data_list, 3)


def write(file_path, mkr_data_list, version=4, camera_block=None):
    """Write any uvtrack version (exporter-side parity with the
    reference's share/ 3DE/Blender/SynthEyes scripts, which emit this
    family of formats)."""
    version = int(version)
    if version == 1:
        write_v1(file_path, mkr_data_list)
    elif version == 2:
        write_v2(file_path, mkr_data_list)
    elif version == 3:
        write_v3(file_path, mkr_data_list)
    elif version == 4:
        write_v4(file_path, mkr_data_list, camera_block=camera_block)
    else:
        raise ValueError("unknown uvtrack version: %r" % version)
