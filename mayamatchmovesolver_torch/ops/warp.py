"""Image warping: apply an ST map (or a lens model directly) to pixels.

Port of mayamatchmovesolver_tpu/ops/warp.py: a bilinear resample driven
by an ST map or by a 3DE lens model — the gather-heavy companion of the
ST-map kernel (ops/stmap.py), with the reference's own gather arithmetic
(not grid_sample, whose edge and alignment rules differ).

  _bilinear_sample — the plain PyTorch version, any device.
  warp_image       — on a CUDA device one launch of the hand kernel
                     (csrc/warp.cu, mmsolver_warp), counted in
                     profiler.counters["warp.launches"]; elsewhere
                     _bilinear_sample.  There is no fallback: on CUDA the
                     kernel runs or the call raises.  The call is the
                     span "warp.call", the launch inside it the span
                     "warp.launch" (utils/profiler.py): under a running
                     torch.profiler capture both are operator records,
                     and the kernel is put down to "warp.launch".

The image and the map are both float32, both float64, or a float16 image
(a half-float plate) with a float32 map; the result takes their promoted
dtype, float32 for the last, as _bilinear_sample's arithmetic does: each
half tap is widened exactly, then blended in float32.  On a CUDA device
the last pairing is the kernel's half instantiation, also counted in
profiler.counters["warp.half_launches"].

Conventions match the ST maps this package writes: an ST map pixel
(s, t) holds the [0, 1] UV of the SOURCE sample for that destination
pixel, v up, pixel centers at half-integers.
"""

import torch

from mayamatchmovesolver_torch import _kernels
from mayamatchmovesolver_torch.utils import profiler
from mayamatchmovesolver_torch.utils.profiler import span

# csrc/warp.cu's mmsolver_warp: the dtype codes of the (image, map)
# pairings it takes.
_DTYPES = {(torch.float32, torch.float32): 0,
           (torch.float64, torch.float64): 1,
           (torch.float16, torch.float32): 2}
_HALF = _DTYPES[torch.float16, torch.float32]
# Sizes travel to the kernel as C ints.
_INT_MAX = 2 ** 31 - 1


def _bilinear_sample(image, u, v):
    """Sample image (H, W, C) at continuous UV in [0, 1] (v up), edge
    clamped; u/v may have any broadcastable shape."""
    h, w = image.shape[0], image.shape[1]
    u, v = torch.broadcast_tensors(u, v)
    # UV -> continuous pixel coords (pixel centers at half-integers;
    # v up -> row 0 is the TOP of the image, so flip).
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    top = image[y0i, x0i] * (1.0 - fx) + image[y0i, x1i] * fx
    bottom = image[y1i, x0i] * (1.0 - fx) + image[y1i, x1i] * fx
    return top * (1.0 - fy) + bottom * fy


def _launch_args(image, stmap, out):
    """The arguments of csrc/warp.cu's mmsolver_warp for CUDA tensors, on
    their device's current stream.  They hold addresses into the three
    tensors, which the caller keeps alive."""
    return (image.data_ptr(), *image.shape, *image.stride(),
            stmap.data_ptr(), *stmap.shape[:2], *stmap.stride(),
            out.data_ptr(), _DTYPES[image.dtype, stmap.dtype],
            torch.cuda.current_stream(image.device).cuda_stream)


def _warp_cuda(image, stmap):
    """warp_image by the kernel (csrc/warp.cu): the image (H, W, C >= 1)
    and the map (H', W', >= 2) on one CUDA device, both float32, both
    float64, or a float16 image with a float32 map, at any strides;
    returns a new contiguous (H', W', C) tensor of their promoted dtype
    (torch.result_type, which is the map's in each of these pairings).
    Raises ValueError for anything else.  Each launch adds one to
    profiler.counters["warp.launches"], and one of the half instantiation
    to profiler.counters["warp.half_launches"] too."""
    if not (image.is_cuda and stmap.is_cuda
            and image.device == stmap.device):
        raise ValueError("the CUDA warp needs the image and the map on one "
                         "CUDA device, got %s and %s"
                         % (image.device, stmap.device))
    code = _DTYPES.get((image.dtype, stmap.dtype))
    if code is None:
        raise ValueError("the CUDA warp takes a float32 or float64 image "
                         "and a map of the same dtype, or a float16 image "
                         "and a float32 map, got %s and %s"
                         % (image.dtype, stmap.dtype))
    if image.dim() != 3 or image.numel() == 0:
        raise ValueError("the image must be a non-empty (H, W, C), got %s"
                         % (tuple(image.shape),))
    if stmap.dim() != 3 or stmap.shape[2] < 2 or stmap.numel() == 0:
        raise ValueError("the map must be a non-empty (H', W', >=2), got %s"
                         % (tuple(stmap.shape),))
    if max(image.shape + stmap.shape) > _INT_MAX:
        raise ValueError("a side of the image or the map exceeds %d"
                         % _INT_MAX)
    out = torch.empty((stmap.shape[0], stmap.shape[1], image.shape[2]),
                      dtype=stmap.dtype, device=image.device)
    with span("warp.launch"):
        _kernels.launch(image.device, _kernels.warp_function(),
                        *_launch_args(image, stmap, out))
    profiler.counters["warp.launches"] += 1
    if code == _HALF:
        profiler.counters["warp.half_launches"] += 1
    return out


def warp_image(image, stmap):
    """Resample image through an ST map (the compositor STMap-node
    semantics the maps are produced for), on the image's device.

    image: (H, W, C) float; stmap: (H', W', >=2) — channels 0/1 are the
    source UV per destination pixel.  Returns (H', W', C) in their
    promoted dtype (a float16 image through a float32 map gives float32).
    On a CUDA device this is one launch of the kernel (_warp_cuda), which
    raises ValueError for what it does not take; elsewhere
    _bilinear_sample.  The call is the span "warp.call", and on a CUDA
    device the launch inside it "warp.launch" (utils/profiler.py)."""
    with span("warp.call"):
        if image.is_cuda or stmap.is_cuda:
            return _warp_cuda(image, stmap)
        return _bilinear_sample(image, stmap[..., 0], stmap[..., 1])


def warp_image_with_lens(image, model, film_back, direction="distort",
                         out_width=None, out_height=None):
    """Warp pixels directly through a lens model: builds the ST map with
    ops/stmap.py::stmap on the image's device (on a CUDA device the hand
    kernel) and samples the image through it.

    direction='distort' produces the distorted (through-the-lens)
    image from an undistorted source; 'undistort' removes distortion
    from a scanned plate."""
    from mayamatchmovesolver_torch.ops import stmap as stmap_mod

    h = int(out_height or image.shape[0])
    w = int(out_width or image.shape[1])
    st = stmap_mod.stmap(model, film_back, w, h, direction=direction,
                         device=image.device)
    return warp_image(image, st)
