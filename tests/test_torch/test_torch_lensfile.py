"""The torch port's Nuke lens-file reader and writer, and
attach_lens_file, against the JAX package.

Parsing is host code carried over: the lens-file texts of
tests/test_io/test_lensfile.py (static and animated knobs, two layers)
and a few harder ones must parse to the same layers, word for word,
and write_string(parse_string(x)) must round-trip.  Models built from a
layer, and the layered distortion, agree at 1e-12 (float64).
attach_lens_file must bake to the same attribute values (exactly: they
are copied, not computed), with animated knobs held at the nearest frame
outside the file's range.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.io.lensfile as t_lensfile
import mayamatchmovesolver_tpu.io.lensfile as j_lensfile
from _torch_port_cases import PACKAGES, to_numpy

SAMPLE = """
LD_3DE_Classic_LD_Model {
 direction undistort
 tde4_focal_length_cm 3.5
 tde4_filmback_width_cm 3.6
 tde4_filmback_height_cm 2.4
 tde4_lens_center_offset_x_cm 0
 tde4_lens_center_offset_y_cm 0
 tde4_pixel_aspect 1
 Distortion {{curve x1 0.1 x2 0.15 x3 0.2 }}
 Anamorphic_Squeeze 1.1
 Curvature_X 0.05
 Curvature_Y -0.02
 Quartic_Distortion 0.01
 name lens1
}
LD_3DE4_Radial_Standard_Degree_4 {
 Distortion_Degree_2 0.08
 U_Degree_2 0.01
 Phi_Cylindric_Direction 15.0
 B_Cylindric_Bending 0.05
 name lens2
}
"""

# Three layers: an animated anamorphic lens whose curve starts late (frame
# 3) and has a gap, a rescaled anamorphic lens, and a classic lens with a
# curve without frame numbers; a non-square pixel and an offset centre.
HARD = """
set cut_paste_input [stack 0]
LD_3DE4_Anamorphic_Standard_Degree_4 {
 tde4_filmback_width_cm 2.2
 tde4_filmback_height_cm 1.85
 tde4_lens_center_offset_x_cm 0.03
 tde4_lens_center_offset_y_cm -0.01
 tde4_pixel_aspect 2
 Cx02_Degree_2 {{curve x3 0.01 x4 0.02 x6 0.03 }}
 Cy02_Degree_2 -0.015
 Cx22_Degree_2 0.004
 Lens_Rotation {{curve x3 1.5 x6 2.5 }}
 Squeeze_X 1.02
 Squeeze_Y 0.99
 Unknown_Knob 12
 selected true
}
LD_3DE4_Anamorphic_Rescaled_Degree_4 {
 Cx02_Degree_2 0.02
 Cy44_Degree_4 0.001
 Rescale 1.05
}
LD_3DE_Classic_LD_Model {
 Distortion {{curve 0.02 0.03 0.04 }}
 Quartic_Distortion notanumber
}
"""

TEXTS = {"sample": SAMPLE, "hard": HARD, "empty": "",
         "no_lens": "Blur {\n size 2\n}\n"}


def _as_plain(layers):
    return dataclasses.asdict(layers)


@pytest.mark.parametrize("name", list(TEXTS))
def test_parse_string_matches(name):
    got = t_lensfile.parse_string(TEXTS[name])
    want = j_lensfile.parse_string(TEXTS[name])
    assert _as_plain(got) == _as_plain(want)
    assert got.frame_range() == want.frame_range()
    assert [type(l).__name__ for l in got.layers] == ["LensLayer"] * len(
        want.layers)


def test_parsed_values():
    layers = t_lensfile.parse_string(SAMPLE)
    l0, l1 = layers.layers
    assert (l0.model_type, l1.model_type) == ("tde_classic",
                                              "tde_radial_std_deg4")
    assert l0.frame_range == (1, 3)
    assert l0.value_at("distortion", 2) == 0.15
    assert l0.value_at("distortion", 99) == 0.2  # clamped hold
    assert l0.value_at("distortion", -4) == 0.1
    assert l0.value_at("anamorphic_squeeze", 1) == 1.1
    assert l0.value_at("missing", 1, default=7.0) == 7.0
    assert l1.value_at("cylindric_direction", 1) == 15.0
    assert layers.camera["tde4_focal_length_cm"] == 3.5
    hard = t_lensfile.parse_string(HARD)
    assert [l.model_type for l in hard.layers] == [
        "tde_anamorphic_std_deg4", "tde_anamorphic_std_deg4_rescaled",
        "tde_classic"]
    assert hard.layers[0].parameters["degree2_cx02"] == {3: 0.01, 4: 0.02,
                                                         6: 0.03}
    assert hard.layers[2].parameters["distortion"] == {1: 0.02, 2: 0.03,
                                                       3: 0.04}
    assert hard.layers[2].parameters["quartic_distortion"] == {None: 0.0}
    assert hard.camera["tde4_pixel_aspect"] == 2.0
    assert hard.frame_range() == (1, 6)


@pytest.mark.parametrize("name", ["sample", "hard"])
def test_write_string_round_trips(name, tmp_path):
    layers = t_lensfile.parse_string(TEXTS[name])
    text = t_lensfile.write_string(layers)
    assert text == j_lensfile.write_string(
        j_lensfile.parse_string(TEXTS[name]))
    again = t_lensfile.parse_string(text)
    assert _as_plain(again) == _as_plain(layers)
    assert t_lensfile.write_string(again) == text
    # Through a file, and into the other package.
    path = tmp_path / "lens.nk"
    t_lensfile.write(path, layers)
    assert _as_plain(t_lensfile.parse(path)) == _as_plain(layers)
    assert _as_plain(j_lensfile.parse(path)) == _as_plain(layers)


@pytest.mark.parametrize("frame", [1, 4, 5, 9])
def test_models_and_layered_distortion_match(frame):
    t_layers = t_lensfile.parse_string(HARD)
    j_layers = j_lensfile.parse_string(HARD)
    for t_layer, j_layer in zip(t_layers.layers, j_layers.layers):
        got = t_layer.model_at(frame, device="cpu", dtype=torch.float64)
        want = j_layer.model_at(frame)
        assert type(got).__name__ == type(want).__name__
        for f in dataclasses.fields(got):
            value = getattr(got, f.name)
            assert value.dtype == torch.float64 and value.shape == ()
            assert float(value) == float(getattr(want, f.name)), f.name
    t_fb = t_layers.film_back(device="cpu", dtype=torch.float64)
    j_fb = j_layers.film_back()
    for f in dataclasses.fields(t_fb):
        assert float(getattr(t_fb, f.name)) == float(getattr(j_fb, f.name))
    pts = np.array([[0.2, 0.1], [-0.3, 0.25], [0.0, 0.0]])
    d = t_layers.distort(frame, torch.as_tensor(pts))
    np.testing.assert_allclose(
        to_numpy(d), np.asarray(j_layers.distort(frame, jnp.asarray(pts))),
        rtol=0, atol=1e-12)
    u = t_layers.undistort(frame, d)
    np.testing.assert_allclose(
        to_numpy(u),
        np.asarray(j_layers.undistort(frame, jnp.asarray(to_numpy(d)))),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_numpy(u), pts, atol=1e-8)


def _attached(pkg, text, first_frame=1, last_frame=8):
    scene_mod, lens_mod = PACKAGES[pkg]
    lensfile = t_lensfile if pkg == "torch" else j_lensfile
    sg = scene_mod.SceneGraph(frame_range=(first_frame, last_frame))
    cam = sg.create_camera("cam", tz=10.0, focal_length_mm=35.0)
    sg.create_marker("m", camera=cam, bundle=sg.create_bundle("b", tz=-5.0))
    created = lens_mod.attach_lens_file(sg, cam, lensfile.parse_string(text))
    if pkg == "torch":
        scene, attrs = sg.bake(device="cpu")
        return created, attrs, lens_mod.bake_scene_lens(sg, device="cpu")
    scene, attrs = sg.bake()
    return created, attrs, lens_mod.bake_scene_lens(sg)


@pytest.mark.parametrize("name,frames", [("sample", (1, 8)), ("hard", (1, 8)),
                                         ("hard", (4, 5))])
def test_attach_lens_file_bakes_the_same_attributes(name, frames):
    t_created, t_attrs, t_lens = _attached("torch", TEXTS[name], *frames)
    j_created, j_attrs, j_lens = _attached("jax", TEXTS[name], *frames)
    assert [sorted(c) for c in t_created] == [sorted(c) for c in j_created]
    for t_layer, j_layer in zip(t_created, j_created):
        for key, attr in j_layer.items():
            assert t_layer[key].code == attr.code, key
            assert t_layer[key].name == attr.name, key
    np.testing.assert_array_equal(to_numpy(t_attrs.static_values),
                                  np.asarray(j_attrs.static_values))
    np.testing.assert_array_equal(to_numpy(t_attrs.anim_values),
                                  np.asarray(j_attrs.anim_values))
    assert t_lens.model_types == j_lens.model_types
    np.testing.assert_array_equal(to_numpy(t_lens.param_codes),
                                  np.asarray(j_lens.param_codes))


def test_attach_lens_file_holds_animated_knobs_outside_the_range(tmp_path):
    """The hard file's first curve runs over frames 3..6 with a gap at 5;
    on a scene of frames 1..8 it becomes an animated attribute held at
    the nearest key outside the file's range."""
    scene_mod, lens_mod = PACKAGES["torch"]
    path = tmp_path / "hard.nk"
    path.write_text(HARD)
    sg = scene_mod.SceneGraph(frame_range=(1, 8))
    cam = sg.create_camera("cam", tz=10.0)
    sg.create_marker("m", camera=cam, bundle=sg.create_bundle("b", tz=-5.0))
    created = lens_mod.attach_lens_file(sg, cam, str(path))
    assert len(created) == 3 and len(cam.lens_layers) == 3
    _, attrs = sg.bake(device="cpu")
    cx02 = created[0]["degree2_cx02"]
    assert cx02.code % 2 == 1  # animated
    np.testing.assert_array_equal(
        to_numpy(attrs.anim_values[cx02.code // 2]),
        [0.01, 0.01, 0.01, 0.02, 0.03, 0.03, 0.03, 0.03])
    squeeze = created[0]["squeeze_x"]
    assert squeeze.code % 2 == 0  # static
    assert float(attrs.static_values[squeeze.code // 2]) == 1.02
    for layer in created:
        pa = layer["pixel_aspect"]
        assert float(attrs.static_values[pa.code // 2]) == 2.0
    assert cam.attrs["lens2_distortion"] is created[2]["distortion"]
