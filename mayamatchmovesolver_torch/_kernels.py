"""Build and load the port's CUDA kernels.

Each kernel source in csrc/ has a plain C interface.  At first use it is
compiled by nvcc into a shared library under build/kernels/ at the
repository root, named by a hash of the source and the flags, and loaded
with ctypes.  Nothing is built at import time, and nothing here touches
torch: the callers pass device pointers and the stream as integers.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "kernels"

# IEEE division and square root (no --use_fast_math): the kernels are
# held to their plain PyTorch versions at 2e-5.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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
def stmap_function():
    """mmsolver_stmap from csrc/stmap.cu, with its C signature set."""
    fn = load("stmap").mmsolver_stmap
    fn.argtypes = [
        ctypes.c_void_p,  # out (device, float4 per pixel)
        ctypes.c_int,  # width
        ctypes.c_int,  # height
        ctypes.c_int,  # core id
        ctypes.c_int,  # distort
        ctypes.c_int,  # fixed-point iterations
        ctypes.c_void_p,  # host parameter floats
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return fn
