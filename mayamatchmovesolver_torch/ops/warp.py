"""Image warping: apply an ST map (or a lens model directly) to pixels.

Port of mayamatchmovesolver_tpu/ops/warp.py: a bilinear resample driven
by an ST map or by a 3DE lens model — the gather-heavy companion of the
ST-map kernel (ops/stmap.py), in plain tensor code with the reference's
own gather arithmetic (not grid_sample, whose edge and alignment rules
differ).

Conventions match the ST maps this package writes: an ST map pixel
(s, t) holds the [0, 1] UV of the SOURCE sample for that destination
pixel, v up, pixel centers at half-integers.
"""

import torch

from mayamatchmovesolver_torch.utils.profiler import span


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


def warp_image(image, stmap):
    """Resample image through an ST map (the compositor STMap-node
    semantics the maps are produced for), on the image's device.

    image: (H, W, C) float; stmap: (H', W', >=2) — channels 0/1 are the
    source UV per destination pixel.  Returns (H', W', C).  The call is
    the span "warp.call" (utils/profiler.py)."""
    with span("warp.call"):
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
