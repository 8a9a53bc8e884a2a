"""csrc/stmap.cu's arithmetic in float32 numpy.

The CUDA kernels cannot run on the CPU; this transcription of their
per-pixel code, step for step, lets the CPU tests hold the host-side
parameter packing and the kernels' arithmetic to the plain versions.  It
has to change together with csrc/stmap.cu.
"""

import numpy as np

import mayamatchmovesolver_torch.models as t_models
import mayamatchmovesolver_torch.ops.stmap as t_stmap


def _fma(a, b, c):
    """A float32 fused multiply-add: the product of two float32 is exact
    in float64, so only the sum rounds before the result does."""
    wide = (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64))
    return wide.astype(np.float32)


def _emulate_kernel(core_id, params, distort, iterations, *, size=None,
                    source=None):
    """csrc/stmap.cu's per-pixel arithmetic, transcribed step for step to
    float32 numpy over the whole image, reading the same 22 host
    parameters.  The point comes from the pixel index of a `size` =
    (width, height) image, or (FROM_MAP) from S and T of the (H, W, 4)
    map `source`, whose channels 2 and 3 carry through."""
    f = np.float32
    p = params.astype(np.float32)
    c, a_in, b_in, a_out, b_out = p[:10], p[10:14], p[14:16], p[16:20], p[20:]

    def displace(x, y, ax, ay, neg):
        """(ax, ay) + h(x, y), or with neg (ax, ay) - h(x, y)."""
        sx, sy = (-x, -y) if neg else (x, y)
        x2, y2 = x * x, y * y
        r2 = x2 + y2
        if core_id == t_stmap._CORE_CLASSIC:
            r4 = r2 * r2
            gx = _fma(c[0], x2, _fma(c[1], y2, c[4] * r4))
            gy = _fma(c[2], x2, _fma(c[3], y2, c[5] * r4))
            return _fma(sx, gx, ax), _fma(sy, gy, ay)
        if core_id == t_stmap._CORE_RADIAL_DEG4:
            sxy = (sx + sx) * y
            g = r2 * _fma(c[3], r2, c[0])
            u, v = _fma(c[4], r2, c[1]), _fma(c[5], r2, c[2])
            wx, wy = _fma(f(2), x2, r2), _fma(f(2), y2, r2)
            if neg:
                wx, wy = -wx, -wy
            return (_fma(sxy, v, _fma(wx, u, _fma(sx, g, ax))),
                    _fma(sxy, u, _fma(wy, v, _fma(sy, g, ay))))
        d = x2 - y2
        gx = _fma(r2, _fma(c[4], r2, _fma(c[6], d, c[0])),
                  d * _fma(c[8], d, c[2]))
        gy = _fma(r2, _fma(c[5], r2, _fma(c[7], d, c[1])),
                  d * _fma(c[9], d, c[3]))
        return _fma(sx, gx, ax), _fma(sy, gy, ay)

    if source is None:
        width, height = size
        v, u = np.meshgrid(np.arange(height, dtype=f),
                           np.arange(width, dtype=f), indexing="ij")
        rest = np.stack([np.zeros_like(u), np.ones_like(u)], axis=-1)
    else:
        source = np.asarray(source, f)
        u, v, rest = source[..., 0], source[..., 1], source[..., 2:]
    tx = _fma(a_in[0], u, _fma(a_in[1], v, b_in[0]))
    ty = _fma(a_in[2], u, _fma(a_in[3], v, b_in[1]))
    if distort:
        qx, qy = tx, ty
        for _ in range(iterations + 1):
            qx, qy = displace(qx, qy, tx, ty, True)
    else:
        qx, qy = displace(tx, ty, tx, ty, False)
    s = _fma(a_out[0], qx, _fma(a_out[1], qy, b_out[0]))
    t = _fma(a_out[2], qx, _fma(a_out[3], qy, b_out[1]))
    return np.concatenate([np.stack([s, t], axis=-1), rest], axis=-1)


def emulated_map(model, fb, width, height, direction, source=None):
    """The map the kernel's arithmetic gives for a torch model: from the
    pixel index, or with `source` the layer variant on that map."""
    core_id, params = t_stmap._kernel_params(
        model, fb, direction, None if source is not None else (width, height))
    assert params.shape == (22,) and params.dtype == np.float32
    return _emulate_kernel(
        core_id, params, direction == "distort",
        t_models.base.DISTORT_INVERSE_ITERATIONS,
        size=(width, height), source=source)


def emulated_stack(models, fb, width, height, direction):
    """A lens stack as the CUDA route of stmap_stack runs it: the first
    layer from the pixel index, each further one from the map."""
    models = list(models) if direction == "distort" else list(models)[::-1]
    out = None
    for model in models:
        out = emulated_map(model, fb, width, height, direction, source=out)
    return out
