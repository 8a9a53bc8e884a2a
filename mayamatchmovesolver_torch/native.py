"""ctypes binding to the native C++ runtime (native/libmmtpu_native.so).

The native library provides the thread-pooled lens-distortion ST-map
engine and uncompressed EXR writer (the reference's rayon/mmimage role;
ref: lib/cppbind/mmlens/src/distortion_process.rs,
lib/rust/mmimage/src/lib.rs).  Auto-builds with make on first use if a
toolchain is present; everything degrades to the Python paths when the
library is unavailable.

A copy of mayamatchmovesolver_tpu/native.py (host code, no tensors): the
port imports nothing of the JAX package.  It binds the same library,
built by `make -C native` from the repo's own native/src.  The port uses
it for the PIZ Huffman codec of io/_piz.py only; its ST maps come from
the CUDA kernel of ops/stmap.py.
"""

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmmtpu_native.so")

_lib = None
_load_error = None


def _build():
    subprocess.run(
        ["make", "-C", _NATIVE_DIR],
        check=True,
        capture_output=True,
        timeout=300,
    )


def load(auto_build=True):
    """Load (building if needed) the native library; returns it or None."""
    global _lib, _load_error
    if _lib is not None:
        return _lib
    if _load_error is not None and not auto_build:
        return None
    try:
        if not os.path.exists(_LIB_PATH) and auto_build:
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
    except (OSError, subprocess.SubprocessError) as e:
        _load_error = e
        return None

    lib.mmtpu_stmap_classic.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.mmtpu_stmap_radial_deg4.argtypes = lib.mmtpu_stmap_classic.argtypes
    lib.mmtpu_stmap_anamorphic_deg4.argtypes = (
        lib.mmtpu_stmap_classic.argtypes
    )
    lib.mmtpu_exr_write_rgba.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.mmtpu_exr_write_rgba.restype = ctypes.c_int
    try:
        lib.mmtpu_huf_compress.argtypes = [
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long,
        ]
        lib.mmtpu_huf_compress.restype = ctypes.c_long
        lib.mmtpu_huf_uncompress.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_long,
        ]
        lib.mmtpu_huf_uncompress.restype = ctypes.c_int
    except AttributeError:
        # Older prebuilt library without the PIZ entry points; the
        # Python codec in io/_piz.py remains the fallback.
        pass
    _lib = lib
    return lib


def available():
    return load() is not None


def _as_double_ptr(values):
    arr = np.ascontiguousarray(values, dtype=np.float64)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def stmap_classic(lens_params, camera_params, width, height,
                  direction="distort", n_threads=0):
    """Native classic-model ST map -> (H, W, 4) float32.

    lens_params: (distortion, squeeze, curv_x, curv_y, quartic).
    camera_params: (fbw_cm, fbh_cm, lco_x_cm, lco_y_cm, pixel_aspect).
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _load_error)
    out = np.empty((height, width, 4), np.float32)
    lens_arr, lens_ptr = _as_double_ptr(lens_params)
    cam_arr, cam_ptr = _as_double_ptr(camera_params)
    lib.mmtpu_stmap_classic(
        lens_ptr, cam_ptr, width, height,
        1 if direction == "distort" else 0, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def stmap_radial_deg4(lens_params, camera_params, width, height,
                      direction="distort", n_threads=0):
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _load_error)
    out = np.empty((height, width, 4), np.float32)
    lens_arr, lens_ptr = _as_double_ptr(lens_params)
    cam_arr, cam_ptr = _as_double_ptr(camera_params)
    lib.mmtpu_stmap_radial_deg4(
        lens_ptr, cam_ptr, width, height,
        1 if direction == "distort" else 0, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def stmap_anamorphic_deg4(lens_params, camera_params, width, height,
                          direction="distort", n_threads=0):
    """Native anamorphic-deg4 ST map -> (H, W, 4) float32.

    lens_params: the 13 Parameters3deAnamorphicStdDeg4 values (cx02,
    cy02, cx22, cy22, cx04, cy04, cx24, cy24, cx44, cy44, rotation_deg,
    squeeze_x, squeeze_y) plus an optional trailing rescale (the
    Rescaled variant; defaults to 1).
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _load_error)
    lens_params = list(lens_params)
    if len(lens_params) == 13:
        lens_params.append(1.0)
    if len(lens_params) != 14:
        raise ValueError("expected 13 or 14 lens parameters")
    out = np.empty((height, width, 4), np.float32)
    lens_arr, lens_ptr = _as_double_ptr(lens_params)
    cam_arr, cam_ptr = _as_double_ptr(camera_params)
    lib.mmtpu_stmap_anamorphic_deg4(
        lens_ptr, cam_ptr, width, height,
        1 if direction == "distort" else 0, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def exr_write_rgba(path, image):
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _load_error)
    image = np.ascontiguousarray(image, dtype=np.float32)
    if image.ndim != 3 or image.shape[2] != 4:
        raise ValueError("image must be (H, W, 4)")
    rc = lib.mmtpu_exr_write_rgba(
        path.encode(),
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        image.shape[1],
        image.shape[0],
    )
    if rc != 0:
        raise OSError("native EXR write failed: %s" % path)


def has_huffman():
    """True if the loaded library exposes the PIZ Huffman codec."""
    lib = load()
    return lib is not None and hasattr(lib, "mmtpu_huf_compress")


def huf_compress(data):
    """Native PIZ Huffman compress (uint16 array -> bytes blob in the
    ImfHuf layout), or None if the native codec is unavailable."""
    lib = load()
    if lib is None or not hasattr(lib, "mmtpu_huf_compress"):
        return None
    data = np.ascontiguousarray(data, dtype=np.uint16)
    if data.size == 0:
        return b""
    # Worst case: every symbol emits a <=58-bit code + full table.
    cap = 20 + (1 << 16) + data.size * 8 + 64
    out = np.empty(cap, np.uint8)
    n = lib.mmtpu_huf_compress(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        data.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if n < 0:
        return None
    return out[:n].tobytes()


def huf_uncompress(blob, n_out):
    """Native PIZ Huffman uncompress -> uint16 array, or None if the
    native codec is unavailable.  Raises ValueError on corrupt data."""
    lib = load()
    if lib is None or not hasattr(lib, "mmtpu_huf_uncompress"):
        return None
    if n_out == 0:
        return np.zeros(0, np.uint16)
    blob_arr = np.frombuffer(blob, np.uint8)
    out = np.empty(n_out, np.uint16)
    rc = lib.mmtpu_huf_uncompress(
        blob_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        blob_arr.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        n_out,
    )
    if rc != 0:
        raise ValueError("native huffman decode failed (code %d)" % rc)
    return out
