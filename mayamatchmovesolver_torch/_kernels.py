"""Build and load the port's CUDA kernels.

Each kernel source in csrc/ has a plain C interface.  At first use it is
compiled by nvcc into a shared library under build/kernels/ at the
repository root, named by a hash of the source and the flags, and loaded
with ctypes.  Nothing is built at import time.  The callers pass device
pointers and the stream as integers; launch calls an entry point with the
tensors' device current and turns its CUDA error code into an exception.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

from mayamatchmovesolver_torch.models.base import DISTORT_INVERSE_ITERATIONS

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "kernels"

# No --use_fast_math: the kernels are held to their plain PyTorch
# versions at 2e-5.  The fixed point's iteration count is a compile-time
# constant of the kernels (its loop unrolls), taken from models/base.py.
# --resource-usage makes ptxas report registers and spills a kernel; build
# keeps that report beside the library.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--resource-usage",
    "-DMMSOLVER_DISTORT_ITERATIONS=%d" % DISTORT_INVERSE_ITERATIONS,
)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from csrc/ at first use"
    )


def library_path(name):
    """Where the library built from csrc/<name>.cu lives."""
    source = (CSRC / (name + ".cu")).read_bytes()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / ("%s_%s.so" % (name, key[:16]))


def resource_usage_path(name):
    """Where build keeps ptxas's report (registers, stack, spills of every
    kernel) of csrc/<name>.cu."""
    return library_path(name).with_suffix(".ptxas.txt")


def build(name):
    """Compile csrc/<name>.cu if its library is missing; return the path.

    The library is written under a temporary name and renamed into
    place, so a concurrent or interrupted build never leaves a partial
    file at the final path.
    """
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / (name + ".cu"))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed (%d) building %s:\n%s\n%s"
                % (proc.returncode, name, " ".join(cmd), proc.stderr)
            )
        resource_usage_path(name).write_text(proc.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


@functools.lru_cache(maxsize=None)
def load(name):
    """The ctypes library of csrc/<name>.cu, built on first use."""
    return ctypes.CDLL(str(build(name)))


@functools.lru_cache(maxsize=None)
def stmap_functions():
    """(mmsolver_stmap, mmsolver_stmap_layer) from csrc/stmap.cu, with
    their C signatures set.  Both take the map's device pointer, width,
    height, distort flag, the number of layers, their model kinds and
    their fields' records (host memory), the device buffer the pack
    kernel writes the parameters to and the stream, and return the
    launches' CUDA error code."""
    lib = load("stmap")
    functions = (lib.mmsolver_stmap, lib.mmsolver_stmap_layer)
    for fn in functions:
        fn.argtypes = [
            ctypes.c_void_p,  # map (device, float4 per pixel)
            ctypes.c_int,  # width
            ctypes.c_int,  # height
            ctypes.c_int,  # distort
            ctypes.c_int,  # layers
            ctypes.c_void_p,  # model kinds (host ints)
            ctypes.c_void_p,  # field records (host)
            ctypes.c_void_p,  # parameters (device floats)
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
    return functions


@functools.lru_cache(maxsize=None)
def warp_function():
    """mmsolver_warp from csrc/warp.cu, with its C signature set: the
    image's device pointer, height, width, channels and strides, the
    map's device pointer, height, width and strides, the output's device
    pointer, the dtype code and the stream; it returns the launch's CUDA
    error code."""
    fn = load("warp").mmsolver_warp
    strides = [ctypes.c_longlong] * 3  # row, column, channel, in elements
    fn.argtypes = [
        ctypes.c_void_p,  # image (device)
        ctypes.c_int,  # height
        ctypes.c_int,  # width
        ctypes.c_int,  # channels
        *strides,
        ctypes.c_void_p,  # map (device)
        ctypes.c_int,  # output height
        ctypes.c_int,  # output width
        *strides,
        ctypes.c_void_p,  # output (device, contiguous)
        ctypes.c_int,  # dtype: 0 float32, 1 float64
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return fn


def launch(device, function, *args):
    """function(*args), a C entry point of csrc/ that launches on a stream
    of the CUDA `device`, with that device current (a kernel launches on
    the current device).  Raises RuntimeError where it returns a CUDA
    error code other than 0."""
    if device.index == torch.cuda.current_device():
        err = function(*args)
    else:
        with torch.cuda.device(device):
            err = function(*args)
    if err != 0:
        raise RuntimeError("%s failed: CUDA error %d" % (function.__name__,
                                                         err))
