"""Marker deviation curves: the data behind the reference's "Show
Deviation Curves" tool and the per-marker deviation attributes baked
onto marker nodes after every solve
(ref: python/mmSolver/_api/marker.py deviation attrs — 'deviation',
'averageDeviation', 'maximumDeviation', 'frameDeviation';
python/mmSolver/tools/showdeviationcurves/tool.py).

A SolverResult already carries per-frame and per-marker deviation
(solver/results.py FrameErrorList); this module turns them into the
statistics and export formats the reference surfaces.

Port of mayamatchmovesolver_tpu/tools/deviation.py: a copy of the
reference's host code.
"""

import csv
import json

import numpy as np


def deviation_stats(result):
    """Per-marker average / max / worst-frame statistics from a
    SolverResult (ref: marker.py get_average_deviation /
    get_maximum_deviation)."""
    stats = {}
    for name, curve in result.per_marker_error.items():
        if not curve.frames:
            stats[name] = {
                "average": float("nan"),
                "maximum": float("nan"),
                "worst_frame": None,
            }
            continue
        errors = np.asarray(curve.errors, np.float64)
        worst = int(np.argmax(errors))
        stats[name] = {
            "average": float(errors.mean()),
            "maximum": float(errors.max()),
            "worst_frame": int(curve.frames[worst]),
        }
    return stats


def worst_markers(result, count=5):
    """Markers sorted by average deviation, worst first — the triage
    list the deviation UI presents."""
    stats = deviation_stats(result)
    ranked = sorted(
        (s["average"], name)
        for name, s in stats.items()
        if np.isfinite(s["average"])
    )
    return [name for _, name in reversed(ranked)][:count]


def write_deviation_json(file_path, result):
    """Deviation curves + stats as JSON (per-frame solve error plus
    each marker's curve)."""
    out = {
        "error_final": result.error_final,
        "per_frame": {
            "frames": list(result.per_frame_error.frames),
            "errors": [float(e) for e in result.per_frame_error.errors],
        },
        "per_marker": {
            name: {
                "frames": list(curve.frames),
                "errors": [float(e) for e in curve.errors],
            }
            for name, curve in result.per_marker_error.items()
        },
        "stats": deviation_stats(result),
    }
    with open(file_path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def write_deviation_csv(file_path, result):
    """Deviation curves as CSV (frame, marker..., columns) for
    spreadsheet triage."""
    names = sorted(result.per_marker_error.keys())
    frames = sorted(
        {f for c in result.per_marker_error.values() for f in c.frames}
        | set(result.per_frame_error.frames)
    )
    by_marker = {
        name: dict(zip(curve.frames, curve.errors))
        for name, curve in result.per_marker_error.items()
    }
    per_frame = dict(zip(result.per_frame_error.frames,
                         result.per_frame_error.errors))
    with open(file_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "solve_error"] + names)
        for frame in frames:
            row = [frame, per_frame.get(frame, "")]
            for name in names:
                v = by_marker.get(name, {}).get(frame, "")
                row.append(v)
            w.writerow(row)
    return frames, names
