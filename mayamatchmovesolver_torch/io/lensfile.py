"""Nuke-script lens file parser (3DE/Nuke interop).

Port of mayamatchmovesolver_tpu/io/lensfile.py (ref:
lib/cppbind/mmlens/src/lens_io.rs:433-856 — a line-by-line Nuke .nk
parser supporting LD_3DE* nodes with static or animated
`{{curve x<frame> <value> ...}}` knobs, stacked into multi-layer
DistortionLayers; also the loadlens tool capability, ref:
python/mmSolver/tools/loadlens).  Parsing and writing are host code;
the models and film back a LensLayers hands out are tensors on the
device the caller names, or, with no device, Python floats.

Output: LensLayers — per-layer model type + per-frame parameter dicts +
shared camera (film back) parameters.

A lens file's export path to ST maps is

    layers = parse(path)
    st_map = ops.stmap.stmap(layers.models_at(frame), layers.film_back(),
                             width, height, direction, device=device)

whose models and film back are Python floats: the ST-map wrapper packs
them with no device-to-host read, and a stack of N 3DE layers is N
kernel launches on a CUDA device.  models_at is the span
"lensfile.models_at" (utils/profiler.py: an operator record under a
running torch.profiler capture, and logged on the host clock while spans
are on) and counts its calls in profiler.counters["lensfile.models_at"]
and the models it returns in profiler.counters["lensfile.layers"].
"""

import dataclasses
from typing import Dict, List, Tuple

from mayamatchmovesolver_torch.models import scenelens, tde
from mayamatchmovesolver_torch.models.base import FilmBack
from mayamatchmovesolver_torch.utils import profiler
from mayamatchmovesolver_torch.utils.profiler import span

# Nuke node class name -> our model type
# (ref: lib/cppbind/mmlens/src/constants.rs:68-90).
NODE_TYPE_MAP = {
    "LD_3DE_Classic_LD_Model": scenelens.LENS_MODEL_CLASSIC,
    "LD_3DE4_Radial_Standard_Degree_4": scenelens.LENS_MODEL_RADIAL_DEG4,
    "LD_3DE4_Anamorphic_Standard_Degree_4":
        scenelens.LENS_MODEL_ANAMORPHIC_DEG4,
    "LD_3DE4_Anamorphic_Rescaled_Degree_4":
        scenelens.LENS_MODEL_ANAMORPHIC_DEG4_RESCALED,
}

# Nuke knob name -> model parameter field, per model
# (ref: lens_io.rs get_animated_knob_value_f64 call sites).
KNOB_MAP = {
    scenelens.LENS_MODEL_CLASSIC: {
        "Distortion": "distortion",
        "Anamorphic_Squeeze": "anamorphic_squeeze",
        "Curvature_X": "curvature_x",
        "Curvature_Y": "curvature_y",
        "Quartic_Distortion": "quartic_distortion",
    },
    scenelens.LENS_MODEL_RADIAL_DEG4: {
        "Distortion_Degree_2": "degree2_distortion",
        "U_Degree_2": "degree2_u",
        "V_Degree_2": "degree2_v",
        "Quartic_Distortion_Degree_4": "degree4_distortion",
        "U_Degree_4": "degree4_u",
        "V_Degree_4": "degree4_v",
        "Phi_Cylindric_Direction": "cylindric_direction",
        "B_Cylindric_Bending": "cylindric_bending",
    },
    scenelens.LENS_MODEL_ANAMORPHIC_DEG4: {
        "Cx02_Degree_2": "degree2_cx02",
        "Cy02_Degree_2": "degree2_cy02",
        "Cx22_Degree_2": "degree2_cx22",
        "Cy22_Degree_2": "degree2_cy22",
        "Cx04_Degree_4": "degree4_cx04",
        "Cy04_Degree_4": "degree4_cy04",
        "Cx24_Degree_4": "degree4_cx24",
        "Cy24_Degree_4": "degree4_cy24",
        "Cx44_Degree_4": "degree4_cx44",
        "Cy44_Degree_4": "degree4_cy44",
        "Lens_Rotation": "lens_rotation",
        "Squeeze_X": "squeeze_x",
        "Squeeze_Y": "squeeze_y",
    },
}
KNOB_MAP[scenelens.LENS_MODEL_ANAMORPHIC_DEG4_RESCALED] = dict(
    KNOB_MAP[scenelens.LENS_MODEL_ANAMORPHIC_DEG4], Rescale="rescale"
)

# Camera parameter knobs (ref: lens_io.rs:799-824).
_CAMERA_KNOBS = {
    "tde4_focal_length_cm": 3.5,
    "tde4_filmback_width_cm": 3.6,
    "tde4_filmback_height_cm": 2.4,
    "tde4_lens_center_offset_x_cm": 0.0,
    "tde4_lens_center_offset_y_cm": 0.0,
    "tde4_pixel_aspect": 1.0,
}


# FilmBack's fields, in order, as camera knobs.
_FILM_BACK_KNOBS = (
    "tde4_filmback_width_cm",
    "tde4_filmback_height_cm",
    "tde4_lens_center_offset_x_cm",
    "tde4_lens_center_offset_y_cm",
    "tde4_pixel_aspect",
)


@dataclasses.dataclass
class LensLayer:
    model_type: str
    # knob field -> {frame: value} (static values use frame key None).
    parameters: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    frame_range: Tuple[int, int] = (1, 1)

    def value_at(self, field, frame, default=0.0):
        """The knob's value at `frame`: a static knob's value, or an
        animated knob's key at that exact frame, never interpolated.  A
        frame with no key of its own takes the first key's value where it
        lies before the first key, and the last key's otherwise (before
        the curve, past it, or in a gap between keys).  `default` where
        the file has no such knob."""
        curve = self.parameters.get(field)
        if not curve:
            return default
        if None in curve:
            return curve[None]
        if frame in curve:
            return curve[frame]
        # Hold nearest frame (the reference indexes exact frames; we
        # clamp for robustness).
        frames = sorted(curve)
        if frame < frames[0]:
            return curve[frames[0]]
        return curve[frames[-1]]

    def model_at(self, frame, *, device, dtype=None):
        """The layer's model at `frame` (value_at): scalar tensors on
        `device`, or Python floats where `device` is None."""
        cls = scenelens._MODEL_CLASSES[self.model_type]
        values = {
            field: float(self.value_at(field, frame, default))
            for field, default in scenelens._MODEL_FIELDS[self.model_type]
        }
        if device is None:
            return cls(**values)
        return cls.create(device=device, dtype=dtype, **values)


@dataclasses.dataclass
class LensLayers:
    """Multi-layer distortion with shared camera parameters
    (ref: DistortionLayers, lib/cppbind/mmlens/src/distortion_layers.rs:255)."""

    layers: List[LensLayer] = dataclasses.field(default_factory=list)
    camera: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(_CAMERA_KNOBS)
    )

    def frame_range(self):
        if not self.layers:
            return (1, 1)
        lo = min(layer.frame_range[0] for layer in self.layers)
        hi = max(layer.frame_range[1] for layer in self.layers)
        return lo, hi

    def models_at(self, frame):
        """Every layer's model at `frame` (LensLayer.value_at), in stack
        order, with Python float fields: what ops/stmap.py::stmap takes,
        with film_back(), for the whole stack."""
        with span("lensfile.models_at"):
            models = [layer.model_at(frame, device=None)
                      for layer in self.layers]
        profiler.counters["lensfile.models_at"] += 1
        profiler.counters["lensfile.layers"] += len(models)
        return models

    def film_back(self, *, device=None, dtype=None):
        """The camera's film back: scalar tensors on `device`, or Python
        floats where `device` is None."""
        values = [float(self.camera[k]) for k in _FILM_BACK_KNOBS]
        if device is None:
            return FilmBack(*values)
        return FilmBack.create(*values, device=device, dtype=dtype)

    def distort(self, frame, xy_marker):
        """Apply all layers in order, on the points' device and in their
        dtype (ref: the reference chains lens models via
        m_inputLensModel, lens_model.h:36-120)."""
        on = dict(device=xy_marker.device, dtype=xy_marker.dtype)
        fb = self.film_back(**on)
        out = xy_marker
        for layer in self.layers:
            out = tde.distort(layer.model_at(frame, **on), fb, out)
        return out

    def undistort(self, frame, xy_marker):
        on = dict(device=xy_marker.device, dtype=xy_marker.dtype)
        fb = self.film_back(**on)
        out = xy_marker
        for layer in reversed(self.layers):
            out = tde.undistort(layer.model_at(frame, **on), fb, out)
        return out


def _parse_knob_words(words, idx):
    """Parse one knob value: scalar, or '{{curve x1 0.3 x2 0.4 }}'.

    Returns (value_dict, next_idx) where value_dict maps frame->value
    (static scalar uses key None).  (ref: parse_knob_value_curve,
    lens_io.rs:172-290.)
    """
    word = words[idx]
    if word.startswith("{{curve"):
        idx += 1
        curve = {}
        frame = None
        while idx < len(words):
            w = words[idx].rstrip("}")
            closing = words[idx].endswith("}}") or words[idx] == "}}"
            if w.startswith("x"):
                try:
                    frame = int(float(w[1:]))
                except ValueError:
                    frame = None
            elif w:
                try:
                    value = float(w)
                except ValueError:
                    value = None
                if value is not None:
                    if frame is None:
                        frame = 1 if not curve else max(curve) + 1
                    curve[frame] = value
                    frame = None
            idx += 1
            if closing:
                break
        return curve, idx
    try:
        return {None: float(word)}, idx + 1
    except ValueError:
        return {None: 0.0}, idx + 1


def parse_string(text) -> LensLayers:
    out = LensLayers()
    current = None
    scope = 0
    for line in text.splitlines():
        words = line.split()
        if not words:
            continue
        if scope == 0:
            for w in words:
                if w in NODE_TYPE_MAP:
                    current = LensLayer(model_type=NODE_TYPE_MAP[w])
                if w.startswith("{"):
                    scope += 1
            continue
        # Inside a node body.
        if words[0].startswith("}"):
            scope -= 1
            if current is not None:
                frames = [
                    f
                    for curve in current.parameters.values()
                    for f in curve
                    if f is not None
                ]
                if frames:
                    current.frame_range = (min(frames), max(frames))
                out.layers.append(current)
                current = None
            continue
        knob = words[0]
        if len(words) < 2:
            continue
        value, _ = _parse_knob_words(words, 1)
        if knob in _CAMERA_KNOBS:
            out.camera[knob] = value.get(None, list(value.values())[0])
        elif current is not None:
            field_map = KNOB_MAP[current.model_type]
            if knob in field_map:
                current.parameters[field_map[knob]] = value
    return out


def parse(file_path) -> LensLayers:
    with open(file_path) as f:
        return parse_string(f.read())


def _number(value):
    """A knob value as text that parses back to the same float: %g where
    that holds, else the shortest repr that does."""
    text = "%g" % value
    return text if float(text) == value else repr(float(value))


def write_string(layers: LensLayers) -> str:
    """Write the Nuke-script lens format back out (savelensfile
    capability; ref: python/mmSolver/tools/savelensfile).  Every value
    reads back as the same float."""
    reverse_types = {v: k for k, v in NODE_TYPE_MAP.items()}
    lines = []
    for layer in layers.layers:
        lines.append("%s {" % reverse_types[layer.model_type])
        field_to_knob = {
            v: k for k, v in KNOB_MAP[layer.model_type].items()
        }
        for cam_knob, default in _CAMERA_KNOBS.items():
            lines.append(
                " %s %s" % (cam_knob,
                            _number(layers.camera.get(cam_knob, default)))
            )
        for field, curve in layer.parameters.items():
            knob = field_to_knob.get(field, field)
            if None in curve:
                lines.append(" %s %s" % (knob, _number(curve[None])))
            else:
                parts = " ".join(
                    "x%d %s" % (f, _number(v))
                    for f, v in sorted(curve.items())
                )
                lines.append(" %s {{curve %s }}" % (knob, parts))
        lines.append("}")
    return "\n".join(lines) + "\n"


def write(file_path, layers: LensLayers):
    with open(file_path, "w") as f:
        f.write(write_string(layers))
