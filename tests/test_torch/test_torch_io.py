"""Agreement of the port's file formats with the JAX package's.

The port's io/ modules (markerdata, uvtrack, tdetxt, pftrack2dt, rz2,
formatmanager, _piz, _pxr24_b44, exr, image) and native.py are copies
of the reference's host code, apart from markers_to_scene, which fills
the port's SceneGraph.  Here:

  * every case of the reference's own tests/test_io files for those
    modules runs twice: as written, and with its module globals (mmio,
    exr, image, _piz, pb and the native-library probe) bound to the
    port's modules;
  * both packages write byte-identical EXR files (every codec, float
    and half, scanline, tiled and multi-part) and uvtrack files (v1-v4);
  * both parsers read every marker format into equal MarkerData;
  * markers_to_scene of one parsed file into either package's
    SceneGraph bakes to equal attributes (1e-12);
  * the port's PIZ Huffman codec, native where the library is built,
    writes what the reference's Python codec writes.
"""

import dataclasses
import importlib
import inspect
import itertools
import os
import types

import numpy as np
import pytest
import torch

import mayamatchmovesolver_torch.io as t_io
import mayamatchmovesolver_torch.io._piz as t_piz
import mayamatchmovesolver_torch.io._pxr24_b44 as t_pb
import mayamatchmovesolver_torch.io.exr as t_exr
import mayamatchmovesolver_torch.io.image as t_image
import mayamatchmovesolver_torch.scene as t_scene
import mayamatchmovesolver_tpu.io as j_io
import mayamatchmovesolver_tpu.io._piz as j_piz
import mayamatchmovesolver_tpu.io.exr as j_exr
import mayamatchmovesolver_tpu.scene as j_scene
from _torch_port_cases import jax_fields, to_numpy
from mayamatchmovesolver_tpu.core.constants import FilmFit

IO = {"jax": j_io, "torch": t_io}
EXR = {"jax": j_exr, "torch": t_exr}


def _port_native_or_skip():
    from mayamatchmovesolver_torch import native

    if not native.has_huffman():
        pytest.skip("native library unavailable")
    return native


# The reference's test modules and, for each, what its module globals
# become on the port's side.
PORT_GLOBALS = {
    "test_marker_formats": {"mmio": t_io},
    "test_exr_image": {"exr": t_exr, "image": t_image},
    "test_exr_golden": {"exr": t_exr},
    "test_exr_piz": {"exr": t_exr, "_piz": t_piz,
                     "_native_or_skip": _port_native_or_skip},
    "test_exr_pxr24_b44": {"exr": t_exr, "pb": t_pb},
}


def _reference_cases():
    """(module, test name, arguments) for every case of the reference's
    files, their parametrize marks expanded."""
    for mod_name in PORT_GLOBALS:
        module = importlib.import_module("tests.test_io." + mod_name)
        for name, fn in vars(module).items():
            if not (name.startswith("test_")
                    and isinstance(fn, types.FunctionType)):
                continue
            grids = [{}]
            for mark in getattr(fn, "pytestmark", []):
                if mark.name != "parametrize":
                    continue
                argnames, argvalues = mark.args[:2]
                names = [a.strip() for a in argnames.split(",")]
                rows = [dict(zip(names, v if len(names) > 1 else (v,)))
                        for v in argvalues]
                grids = [{**g, **r} for g, r in itertools.product(grids,
                                                                   rows)]
            for kwargs in grids:
                case_id = "%s::%s" % (mod_name, name)
                if kwargs:
                    case_id += "[%s]" % "-".join(str(v)
                                                 for v in kwargs.values())
                yield pytest.param(module, name, kwargs, id=case_id)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("module,name,kwargs", list(_reference_cases()))
def test_reference_io_case(module, name, kwargs, pkg, tmp_path):
    fn = getattr(module, name)
    if pkg == "torch":
        port = dict(fn.__globals__)
        port.update(PORT_GLOBALS[module.__name__.rsplit(".", 1)[1]])
        fn = types.FunctionType(fn.__code__, port, fn.__name__,
                                fn.__defaults__, fn.__closure__)
    if "tmp_path" in inspect.signature(fn).parameters:
        kwargs = dict(kwargs, tmp_path=tmp_path)
    fn(**kwargs)


def _image(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _write_both(tmp_path, write):
    """Run `write(exr_module, path)` for both packages; the two files'
    bytes."""
    blobs = []
    for pkg in ("jax", "torch"):
        path = str(tmp_path / ("%s.exr" % pkg))
        write(EXR[pkg], path)
        with open(path, "rb") as f:
            blobs.append(f.read())
    return blobs


COMPRESSIONS = ["NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24", "B44", "B44A"]


@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
@pytest.mark.parametrize("codec", COMPRESSIONS)
def test_exr_scanline_bytes_equal(tmp_path, codec, half):
    img = _image((37, 29, 4), 0)
    jax_bytes, torch_bytes = _write_both(
        tmp_path, lambda exr, path: exr.write_pixels(
            path, img, compression=getattr(exr, "COMPRESSION_" + codec),
            half_precision=half))
    assert jax_bytes == torch_bytes


@pytest.mark.parametrize("codec", ["NONE", "ZIP", "PIZ", "PXR24", "B44A"])
def test_exr_tiled_bytes_equal(tmp_path, codec):
    img = _image((70, 50, 4), 1)
    jax_bytes, torch_bytes = _write_both(
        tmp_path, lambda exr, path: exr.write_pixels_tiled(
            path, img, tile_size=(32, 16),
            compression=getattr(exr, "COMPRESSION_" + codec),
            half_precision=codec.startswith("B44")))
    assert jax_bytes == torch_bytes


def test_exr_multipart_bytes_equal(tmp_path):
    beauty, depth = _image((20, 30, 3), 2), _image((40, 10, 4), 3)
    jax_bytes, torch_bytes = _write_both(
        tmp_path, lambda exr, path: exr.write_pixels_multipart(
            path, [("beauty", beauty), ("depth", depth)],
            compression=exr.COMPRESSION_PIZ))
    assert jax_bytes == torch_bytes


def _marker_data(pkg, seed=5, markers=3, frames=6):
    """Seeded MarkerData of either package: frame 3 of marker 1 disabled,
    bundles on the even markers."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(markers):
        md = IO[pkg].MarkerData(name="mk%d" % i, id="%04d" % i,
                                group_name="grp")
        for frame in range(1, frames + 1):
            md.x.set_value(frame, float(rng.uniform(0.1, 0.9)))
            md.y.set_value(frame, float(rng.uniform(0.1, 0.9)))
            md.weight.set_value(frame, float(rng.uniform(0.5, 1.0)))
            md.enable.set_value(frame, 0 if (i, frame) == (1, 3) else 1)
        if i % 2 == 0:
            md.bundle_x, md.bundle_y, md.bundle_z = (
                float(v) for v in rng.uniform(-3.0, 3.0, 3))
            md.bundle_lock_x = md.bundle_lock_y = md.bundle_lock_z = True
        out.append(md)
    return out


CAMERA_BLOCK = {"resolution": [1920, 1080], "film_back_cm": [3.6, 2.4],
                "per_frame": [{"frame": 1, "focal_length_cm": 3.5}]}


@pytest.mark.parametrize("version", [1, 2, 3, 4])
def test_uvtrack_write_bytes_equal(tmp_path, version):
    blobs = []
    for pkg in ("jax", "torch"):
        path = str(tmp_path / ("%s.uv" % pkg))
        IO[pkg].uvtrack.write(path, _marker_data(pkg), version=version,
                              camera_block=CAMERA_BLOCK)
        with open(path, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]


def _write_marker_file(tmp_path, fmt):
    """One file of each format the registry reads; returns its path."""
    rng = np.random.RandomState(9)
    if fmt.startswith("uv"):
        path = str(tmp_path / "t.uv")
        j_io.uvtrack.write(path, _marker_data("jax"), version=int(fmt[2]),
                           camera_block=CAMERA_BLOCK)
        return path
    px = rng.uniform(10.0, 1900.0, (2, 4, 2))
    if fmt == "txt":
        path = str(tmp_path / "t.txt")
        lines = ["2"]
        for m in range(2):
            lines += ["track_%d" % m, "0", "4"]
            lines += ["%d %.6f %.6f" % (f + 1, *px[m, f]) for f in range(4)]
    elif fmt == "2dt":
        path = str(tmp_path / "t.2dt")
        lines = []
        for m in range(2):
            lines += ['"tracker%d"' % m, "1", "4"]
            lines += ["%d %.6f %.6f 0.1" % (f + 1, *px[m, f])
                      for f in range(4)]
    else:
        path = str(tmp_path / "t.rz2")
        lines = ["imageSequence", "{",
                 '1920 1080 f( "/tmp/img.#.jpg" ) b( 1 5 1 )', "}"]
        for m in range(2):
            lines += ['pointTrack "pt%d"' % m, "{"]
            lines += ["%d %.6f %.6f" % (f + 1, *px[m, f]) for f in range(4)]
            lines += ["}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _fields(obj):
    """A MarkerData or FileInfo as a dict, keyframe channels as dicts."""
    return {f.name: (getattr(obj, f.name).values()
                     if f.name in ("x", "y", "weight", "enable")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("fmt", ["uv1", "uv2", "uv3", "uv4", "txt", "2dt",
                                 "rz2"])
def test_parsers_give_equal_marker_data(tmp_path, fmt):
    path = _write_marker_file(tmp_path, fmt)
    (j_info, j_data), (t_info, t_data) = (
        IO[pkg].read(path, image_width=1920, image_height=1080)
        for pkg in ("jax", "torch"))
    assert type(t_data[0]) is t_io.MarkerData
    assert _fields(t_info) == _fields(j_info)
    assert [_fields(md) for md in t_data] == [_fields(md) for md in j_data]
    assert len(t_data) == (3 if fmt.startswith("uv") else 2)


def test_markers_to_scene_bakes_equal_attributes(tmp_path):
    path = _write_marker_file(tmp_path, "uv4")
    baked = {}
    for pkg, scene_mod in (("jax", j_scene), ("torch", t_scene)):
        _, mkr_data = IO[pkg].read(path)
        sg = scene_mod.SceneGraph(frame_range=(1, 6))
        cam = sg.create_camera(
            "cam", film_fit=FilmFit.HORIZONTAL, tz=np.linspace(10, 11, 6),
            focal_length_mm=35.0, sensor_width_mm=36.0,
            sensor_height_mm=24.0, render_width=1920, render_height=1080)
        created = IO[pkg].markers_to_scene(mkr_data, sg, cam)
        assert [m.name for m, _ in created] == ["mk0", "mk1", "mk2"]
        baked[pkg] = (sg.bake(device="cpu") if pkg == "torch"
                      else sg.bake())
    (j_sc, j_at), (t_sc, t_at) = baked["jax"], baked["torch"]
    for want, got in ((j_sc, t_sc), (j_at, t_at)):
        for name, value in jax_fields(want).items():
            np.testing.assert_allclose(to_numpy(getattr(got, name)), value,
                                       rtol=0, atol=1e-12, err_msg=name)
    assert t_at.static_values.dtype == torch.float64


@pytest.mark.parametrize("case", ["random", "run", "sparse", "single"])
def test_port_huffman_writes_what_the_python_codec_writes(case):
    """The port's codec as exr uses it (native where the library is
    built, else Python) against the reference's Python codec: the same
    blob, and each decodes the other's."""
    rng = np.random.RandomState(4)
    data = {
        "random": rng.randint(0, 2000, 5000),
        "run": np.full(3000, 7),
        "sparse": np.concatenate([rng.randint(0, 65536, 300),
                                  np.zeros(700, int)]),
        "single": np.array([65535]),
    }[case].astype(np.uint16)
    reference = j_piz.huf_compress(data, use_native=False)
    port = t_piz.huf_compress(data)
    assert port == reference
    np.testing.assert_array_equal(t_piz.huf_uncompress(reference, data.size),
                                  data)
    np.testing.assert_array_equal(
        j_piz.huf_uncompress(port, data.size, use_native=False), data)


def test_piz_reaches_the_ports_native_module(monkeypatch):
    import mayamatchmovesolver_torch.native as t_native

    assert os.path.samefile(os.path.dirname(t_native._LIB_PATH),
                            os.path.join(os.path.dirname(__file__), "..",
                                         "..", "native"))
    monkeypatch.setattr(t_native, "huf_compress", lambda data: b"port")
    monkeypatch.setattr(t_native, "huf_uncompress", lambda blob, n: "port")
    assert t_piz.huf_compress(np.arange(4, dtype=np.uint16)) == b"port"
    assert t_piz.huf_uncompress(b"\0" * 20, 4) == "port"
