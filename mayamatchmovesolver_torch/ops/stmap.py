"""Lens distortion ST-map generation.

Port of mayamatchmovesolver_tpu/ops/stmap.py (ref:
lib/cppbind/mmlens/src/distortion_process.rs:26-70): for every pixel of
the output image, where it samples in the input (distort or undistort),
as an RGBA float32 ST-map (R=S, G=T, B=0, A=1).

  stmap_torch — the plain PyTorch version, any model type, any device.
  stmap_cuda  — the Hopper kernel (csrc/stmap.cu) for the four 3DE
                models; counts its launches in stmap_cuda.launches.
  stmap       — the dispatcher: the kernel on a CUDA device, the plain
                version on the CPU and for Passthrough.  There is no
                fallback: on CUDA it launches the kernel or raises.
  stmap_stack — a lens-layer stack: the first layer through stmap, each
                further layer point-wise in plain PyTorch.
"""

import ctypes
import dataclasses

import numpy as np
import torch

from mayamatchmovesolver_torch import _kernels
from mayamatchmovesolver_torch.models import base as lens_base
from mayamatchmovesolver_torch.models import tde

# Core ids of csrc/stmap.cu.
_CORE_CLASSIC = 0
_CORE_RADIAL_DEG4 = 1
_CORE_ANAMORPHIC_DEG4 = 2


def stmap_torch(model, film_back, width, height, direction="distort", *,
                device, dtype=torch.float32):
    """Whole-image ST map in plain PyTorch (any model type).

    Pixel centers sample at (x+0.5)/w, (y+0.5)/h in unit space, like the
    reference's image loops.  The grid is built in `dtype` on `device`;
    the model's and film back's tensors must lie on `device` too.
    Returns (H, W, 4) float32.
    """
    ys = (torch.arange(height, dtype=dtype, device=device) + 0.5) / height
    xs = (torch.arange(width, dtype=dtype, device=device) + 0.5) / width
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    pts_marker = torch.stack([grid_x - 0.5, grid_y - 0.5], dim=-1)
    if direction == "distort":
        out = tde.distort(model, film_back, pts_marker)
    else:
        out = tde.undistort(model, film_back, pts_marker)
    out_unit = out + 0.5
    rgba = torch.cat(
        [
            out_unit,
            torch.zeros_like(out_unit[..., :1]),
            torch.ones_like(out_unit[..., :1]),
        ],
        dim=-1,
    )
    return rgba.to(torch.float32)


def _to_host(obj):
    """A copy of a model or film back whose fields are float64 CPU scalar
    tensors, fetched in one device-to-host transfer."""
    names = [f.name for f in dataclasses.fields(obj)]
    if not names:
        return obj
    device = next((getattr(obj, n).device for n in names
                   if isinstance(getattr(obj, n), torch.Tensor)), "cpu")
    values = torch.stack([
        torch.as_tensor(getattr(obj, n), dtype=torch.float64,
                        device=device).detach().reshape(())
        for n in names
    ]).cpu()
    return type(obj)(*values)


def _model_kernel_config(model, film_back):
    """(core id, coefficients, pre, post) for the uniform
    undistort(xy) = post @ core(pre @ xy) structure, all float64 numpy
    computed on the host like the reference's _model_kernel_config.
    `model` and `film_back` are host copies (_to_host)."""
    eye = np.eye(2)
    if isinstance(model, tde.TdeClassic):
        ld, sq, cx, cy, qu = (float(v) for v in (
            model.distortion, model.anamorphic_squeeze, model.curvature_x,
            model.curvature_y, model.quartic_distortion))
        coeffs = [ld / sq, (ld + cx) / sq, ld + cy, ld, qu / sq, qu]
        return _CORE_CLASSIC, coeffs, eye, eye
    if isinstance(model, tde.TdeRadialStdDeg4):
        coeffs = [float(v) for v in (
            model.degree2_distortion, model.degree2_u, model.degree2_v,
            model.degree4_distortion, model.degree4_u, model.degree4_v)]
        post = tde._cylindric_matrix(
            model.cylindric_direction, model.cylindric_bending).numpy()
        return _CORE_RADIAL_DEG4, coeffs, eye, post
    if isinstance(model, tde.TdeAnamorphicStdDeg4):
        coeffs = [float(v) for v in (
            model.degree2_cx02, model.degree2_cy02, model.degree2_cx22,
            model.degree2_cy22, model.degree4_cx04, model.degree4_cy04,
            model.degree4_cx24, model.degree4_cy24, model.degree4_cx44,
            model.degree4_cy44)]
        _, rescale = tde._pixel_aspect_and_rescale(model, film_back)
        a, b = tde._anamorphic_matrices(
            model, film_back.pixel_aspect, rescale)
        return (
            _CORE_ANAMORPHIC_DEG4, coeffs,
            np.linalg.inv(b.numpy()), a.numpy(),
        )
    raise TypeError("no CUDA ST-map kernel for %r" % (type(model),))


def _kernel_params(model, film_back, direction):
    """(core id, the 27 host floats csrc/stmap.cu reads)."""
    film_back = _to_host(film_back)
    core_id, coeffs, pre, post = _model_kernel_config(
        _to_host(model), film_back)
    if direction == "distort":
        m_in, m_out = np.linalg.inv(post), np.linalg.inv(pre)
    else:
        m_in, m_out = pre, post
    fbw, fbh, lcox, lcoy = (float(v) for v in (
        film_back.film_back_width_cm, film_back.film_back_height_cm,
        film_back.lens_center_offset_x_cm,
        film_back.lens_center_offset_y_cm))
    radius = (fbw * fbw + fbh * fbh) ** 0.5 * 0.5
    values = np.zeros(27, np.float64)
    values[:len(coeffs)] = coeffs
    values[10:14] = np.asarray(m_in).reshape(4)
    values[14:18] = np.asarray(m_out).reshape(4)
    values[18:23] = [fbw, fbh, lcox, lcoy, radius]
    return core_id, values.astype(np.float32)


def stmap_cuda(model, film_back, width, height, direction="distort", *,
               device):
    """ST map by the Hopper kernel (csrc/stmap.cu) for the four 3DE
    models; returns (H, W, 4) float32 on the CUDA `device`.

    Raises unless `device` is a CUDA device; builds the kernel at first
    use.  The kernel takes no tensor input: it writes the contiguous
    float32 output allocated here.  Each launch adds one to
    stmap_cuda.launches.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("stmap_cuda needs a CUDA device, got %s" % device)
    if direction not in ("distort", "undistort"):
        raise ValueError("direction must be 'distort' or 'undistort'")
    width, height = int(width), int(height)
    if width <= 0 or height <= 0:
        raise ValueError("image size must be positive: %dx%d"
                         % (width, height))
    core_id, params = _kernel_params(model, film_back, direction)
    out = torch.empty((height, width, 4), dtype=torch.float32, device=device)
    fn = _kernels.stmap_function()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            out.data_ptr(), width, height, core_id,
            int(direction == "distort"),
            lens_base.DISTORT_INVERSE_ITERATIONS,
            params.ctypes.data_as(ctypes.c_void_p), stream,
        )
    if err != 0:
        raise RuntimeError("stmap kernel launch failed: CUDA error %d" % err)
    stmap_cuda.launches += 1
    return out


stmap_cuda.launches = 0


def stmap(model, film_back, width, height, direction="distort", *, device):
    """ST map on `device`: the CUDA kernel for the 3DE models on a CUDA
    device, the plain version on the CPU and for Passthrough (which has
    no kernel, as in the reference's dispatcher).  `model` may be a
    list or tuple of models — a lens-layer stack chained like the
    reference's m_inputLensModel list (ref:
    lib/cppbind/mmlens/src/distortion_layers.rs:255); see stmap_stack."""
    if isinstance(model, (list, tuple)):
        return stmap_stack(model, film_back, width, height, direction,
                           device=device)
    device = torch.device(device)
    if device.type == "cuda" and not isinstance(model, tde.Passthrough):
        return stmap_cuda(model, film_back, width, height, direction,
                          device=device)
    if device.type in ("cpu", "cuda"):
        return stmap_torch(model, film_back, width, height, direction,
                           device=device)
    raise ValueError("stmap runs on 'cpu' or 'cuda', got %s" % device)


def stmap_stack(models, film_back, width, height, direction="distort", *,
                device):
    """ST map for a multi-layer lens stack, (H, W, 4) float32 on `device`.

    The first layer runs through stmap — on a CUDA device the hand
    kernel, with no fallback.  Each further layer is applied point-wise
    to the previous layer's output coordinates in plain PyTorch, in the
    film back's dtype (the reference does this part outside its kernel
    too; it chains per-point virtual calls, lens_model.h:36-120).
    Distortion applies the layers in order, undistortion the inverses in
    reverse; an empty stack is Passthrough; channels 2 and 3 carry
    through.
    """
    models = list(models)
    if not models:
        return stmap(tde.Passthrough(), film_back, width, height, direction,
                     device=device)
    if direction != "distort":
        models = models[::-1]
    out = stmap(models[0], film_back, width, height, direction,
                device=device)
    work = torch.as_tensor(film_back.film_back_width_cm).dtype
    for model in models[1:]:
        pts_marker = out[..., :2].to(work) - 0.5
        if direction == "distort":
            mapped = tde.distort(model, film_back, pts_marker)
        else:
            mapped = tde.undistort(model, film_back, pts_marker)
        out = torch.cat(
            [(mapped + 0.5).to(torch.float32), out[..., 2:]], dim=-1
        )
    return out
