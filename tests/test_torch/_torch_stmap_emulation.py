"""csrc/stmap.cu's arithmetic on the CPU: its pack kernel in Python
floats (float64), its map kernel and its fused undistort stack kernel in
float32 numpy.

The CUDA kernels cannot run on the CPU; these transcriptions of
pack_params_kernel (the lens's fields folded into the 22 floats a layer)
and of the map kernels' per-pixel code, step for step, let the CPU tests
hold the kernels' arithmetic, fed the fields as the wrapper hands them
(ops/stmap.py::_lens_fields), to the plain versions.  They have to
change together with csrc/stmap.cu.
"""

import math

import numpy as np

import mayamatchmovesolver_torch.models as t_models
import mayamatchmovesolver_torch.ops.stmap as t_stmap

# csrc/stmap.cu's Core and Model enums.
CLASSIC, RADIAL_DEG4, ANAMORPHIC_DEG4 = 0, 1, 2
TDE_ANAMORPHIC_DEG4_RESCALED = 3
MAX_COEFFS = 10
DEG2RAD = math.pi / 180.0

# 2x2 matrices are ((m00, m01), (m10, m11)) of Python floats, the
# kernel's row-major Mat2.
IDENTITY2 = ((1.0, 0.0), (0.0, 1.0))


def matmul2(a, b):
    (a00, a01), (a10, a11) = a
    (b00, b01), (b10, b11) = b
    return ((a00 * b00 + a01 * b10, a00 * b01 + a01 * b11),
            (a10 * b00 + a11 * b10, a10 * b01 + a11 * b11))


def inverse2(m):
    (a, b), (c, d) = m
    det = a * d - b * c
    return ((d / det, -b / det), (-c / det, a / det))


def cylindric_matrix(phi_deg, b):
    """The radial model's post matrix, as pack_params_kernel makes it."""
    q = math.sqrt(1.0 + b)
    c, s = math.cos(phi_deg * DEG2RAD), math.sin(phi_deg * DEG2RAD)
    m01 = (q - 1.0 / q) * c * s
    return ((c * c * q + s * s / q, m01), (m01, c * c / q + s * s * q))


def anamorphic_matrices(lens_rotation, squeeze_x, squeeze_y, pixel_aspect,
                        rescale=None):
    """(A, B) with A = R(rot) @ Sx @ Sy [@ Rescale] @ Pa and
    B = Pa [@ Rescale] @ R(rot), as pack_params_kernel makes them; the
    rescale extender scales x only, like squeeze_x."""
    c = math.cos(lens_rotation * DEG2RAD)
    s = math.sin(lens_rotation * DEG2RAD)
    rot = ((c, -s), (s, c))
    x_scale = pixel_aspect if rescale is None else rescale * pixel_aspect
    a = matmul2(rot, ((squeeze_x * x_scale, 0.0), (0.0, squeeze_y)))
    b = matmul2(((x_scale, 0.0), (0.0, 1.0)), rot)
    return a, b


def kernel_config(kind, v, fb):
    """(core, coefficients, pre, post) of pack_params_kernel for a layer
    of Model `kind` with fields `v` (dataclass order) and film back
    fields `fb` (width, height, offset x, y, pixel aspect):
    undistort(xy) = post @ core(pre @ xy), the coefficients those of the
    displacement polynomial h = core - identity."""
    if kind == CLASSIC:
        ld, sq, qu = v[0], v[1], v[4]
        return (CLASSIC, [ld / sq, (ld + v[2]) / sq, ld + v[3], ld,
                          qu / sq, qu], IDENTITY2, IDENTITY2)
    if kind == RADIAL_DEG4:
        return RADIAL_DEG4, list(v[:6]), IDENTITY2, cylindric_matrix(v[6],
                                                                     v[7])
    # cos(2 phi) * r^2 = d and cos(4 phi) * r^4 = 2 d^2 - r^4 with
    # d = x^2 - y^2: the r^4 term takes c04 - c44, the d^2 term 2 c44.
    coeffs = list(v[:4]) + [v[4] - v[8], v[5] - v[9], v[6], v[7],
                            2.0 * v[8], 2.0 * v[9]]
    a, b = anamorphic_matrices(
        v[10], v[11], v[12], fb[4],
        v[13] if kind == TDE_ANAMORPHIC_DEG4_RESCALED else None)
    return ANAMORPHIC_DEG4, coeffs, inverse2(b), a


def pack_params(kind, v, fb, distort, size):
    """(core, the 22 float32) pack_params_kernel writes for a layer:
    kernel_config's, both affine maps folded in float64 around the core,
    rounded once.  `size` is (width, height) where the layer's source
    point is the pixel index (col, row), None where it is (S, T) of a
    previous layer's map:

      core input  = a_in  @ source + b_in   (source -> unit -> dn -> m_in)
      (S, T)      = a_out @ core output + b_out   (m_out -> dn -> unit)
    """
    core, coeffs, pre, post = kernel_config(kind, v, fb)
    m_in, m_out = (inverse2(post), inverse2(pre)) if distort else (pre, post)
    fbw, fbh, lcox, lcoy = fb[:4]
    radius = math.hypot(fbw, fbh) * 0.5
    # unit = source * scale + shift: a pixel's centre, or S and T as is.
    if size is None:
        scale_x = scale_y = 1.0
        shift_x = shift_y = 0.0
    else:
        scale_x, scale_y = 1.0 / size[0], 1.0 / size[1]
        shift_x, shift_y = 0.5 * scale_x, 0.5 * scale_y
    # dn = source * dn_scale + dn_shift.
    dn_scale_x, dn_scale_y = scale_x * fbw / radius, scale_y * fbh / radius
    dn_shift_x = ((shift_x - 0.5) * fbw - lcox) / radius
    dn_shift_y = ((shift_y - 0.5) * fbh - lcoy) / radius
    (i00, i01), (i10, i11) = m_in
    (o00, o01), (o10, o11) = m_out
    to_s, to_t = radius / fbw, radius / fbh
    frames = [
        i00 * dn_scale_x, i01 * dn_scale_y, i10 * dn_scale_x,
        i11 * dn_scale_y,
        i00 * dn_shift_x + i01 * dn_shift_y,
        i10 * dn_shift_x + i11 * dn_shift_y,
        o00 * to_s, o01 * to_s, o10 * to_t, o11 * to_t,
        0.5 + lcox / fbw, 0.5 + lcoy / fbh,
    ]
    params = coeffs + [0.0] * (MAX_COEFFS - len(coeffs)) + frames
    return core, np.array(params, np.float32)


def layer_fields(model, fb):
    """(Model kind, the model's fields, the film back's five) as Python
    floats, in the order the wrapper hands them to the pack kernel."""
    values, _ = t_stmap._lens_fields(fb, [model])
    values = [float(x) for x in values]
    return t_stmap._model_kind(model), values[5:], values[:5]


def kernel_params(model, fb, direction, size):
    """pack_params of a torch model and film back (see pack_params)."""
    kind, v, fb_values = layer_fields(model, fb)
    return pack_params(kind, v, fb_values, direction == "distort", size)


def _fma(a, b, c):
    """A float32 fused multiply-add: the product of two float32 is exact
    in float64, so only the sum rounds before the result does."""
    wide = (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64))
    return wide.astype(np.float32)


def _displace(core_id, c, x, y, ax, ay, neg):
    """csrc/stmap.cu's displace: (ax, ay) + h(x, y), or with neg
    (ax, ay) - h(x, y), for the core `core_id` and coefficients `c`."""
    f = np.float32
    sx, sy = (-x, -y) if neg else (x, y)
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    if core_id == CLASSIC:
        r4 = r2 * r2
        gx = _fma(c[0], x2, _fma(c[1], y2, c[4] * r4))
        gy = _fma(c[2], x2, _fma(c[3], y2, c[5] * r4))
        return _fma(sx, gx, ax), _fma(sy, gy, ay)
    if core_id == RADIAL_DEG4:
        rr = _fma(x, x, y2)
        g = _fma(c[3], rr, c[0])
        u, v = _fma(c[4], rr, c[1]), _fma(c[5], rr, c[2])
        s = _fma(x, u, y * v)
        k = _fma(f(2), s, rr * g)
        srr = -rr if neg else rr
        return _fma(sx, k, _fma(srr, u, ax)), _fma(sy, k, _fma(srr, v, ay))
    d = x2 - y2
    gx = _fma(r2, _fma(c[4], r2, _fma(c[6], d, c[0])),
              d * _fma(c[8], d, c[2]))
    gy = _fma(r2, _fma(c[5], r2, _fma(c[7], d, c[1])),
              d * _fma(c[9], d, c[3]))
    return _fma(sx, gx, ax), _fma(sy, gy, ay)


def _frame_in(p, u, v):
    """csrc/stmap.cu's frame_in: the source point to the core's input."""
    a_in, b_in = p[10:14], p[14:16]
    return (_fma(a_in[0], u, _fma(a_in[1], v, b_in[0])),
            _fma(a_in[2], u, _fma(a_in[3], v, b_in[1])))


def _frame_out(p, qx, qy):
    """csrc/stmap.cu's frame_out: the core's output to S and T."""
    a_out, b_out = p[16:20], p[20:]
    return (_fma(a_out[0], qx, _fma(a_out[1], qy, b_out[0])),
            _fma(a_out[2], qx, _fma(a_out[3], qy, b_out[1])))


def _source_point(size, source):
    """(u, v, channels 2 and 3) of a thread's first point: the pixel index
    of a `size` = (width, height) image with [0, 1], or S and T of the
    (H, W, 4) map `source` with its own channels 2 and 3."""
    f = np.float32
    if source is None:
        width, height = size
        v, u = np.meshgrid(np.arange(height, dtype=f),
                           np.arange(width, dtype=f), indexing="ij")
        return u, v, np.stack([np.zeros_like(u), np.ones_like(u)], axis=-1)
    source = np.asarray(source, f)
    return source[..., 0], source[..., 1], source[..., 2:]


def _texels(s, t, rest):
    return np.concatenate([np.stack([s, t], axis=-1), rest], axis=-1)


def _emulate_kernel(core_id, params, distort, iterations, *, size=None,
                    source=None):
    """csrc/stmap.cu's per-pixel arithmetic, transcribed step for step to
    float32 numpy over the whole image, reading the 22 parameters of
    pack_params.  The point comes from the pixel index of a `size` =
    (width, height) image, or (FROM_MAP) from S and T of the (H, W, 4)
    map `source`, whose channels 2 and 3 carry through."""
    p = params.astype(np.float32)
    u, v, rest = _source_point(size, source)
    tx, ty = _frame_in(p, u, v)
    if distort:
        qx, qy = tx, ty
        for _ in range(iterations + 1):
            qx, qy = _displace(core_id, p[:10], qx, qy, tx, ty, True)
    else:
        qx, qy = _displace(core_id, p[:10], tx, ty, tx, ty, False)
    return _texels(*_frame_out(p, qx, qy), rest)


# csrc/stmap.cu's CORE_BITS: the bits of a layer's core id in the fused
# stack kernel's `cores`.
CORE_BITS = 2


def stack_cores(core_ids):
    """The `cores` argument csrc/stmap.cu's launch hands stmap_stack_kernel
    for layers of these core ids: CORE_BITS a layer, the first lowest."""
    cores = 0
    for layer, core_id in enumerate(core_ids):
        cores |= core_id << (CORE_BITS * layer)
    return cores


def _emulate_stack_kernel(cores, layers, params, *, size=None, source=None):
    """csrc/stmap.cu's stmap_stack_kernel, transcribed step for step to
    float32 numpy over the whole image: the first point as _emulate_kernel
    takes it, then `layers` layers of undistort, layer i's core read from
    the bits of `cores` and its 22 floats from params[i], the point
    handed from each layer's frame_out to the next one's frame_in."""
    u, v, rest = _source_point(size, source)
    for layer in range(layers):
        p = params[layer].astype(np.float32)
        core_id = (cores >> (CORE_BITS * layer)) & ((1 << CORE_BITS) - 1)
        tx, ty = _frame_in(p, u, v)
        qx, qy = _displace(core_id, p[:10], tx, ty, tx, ty, False)
        u, v = _frame_out(p, qx, qy)
    return _texels(u, v, rest)


def emulated_map(model, fb, width, height, direction, source=None):
    """The map the kernel's arithmetic gives for a torch model: from the
    pixel index, or with `source` the layer variant on that map."""
    core_id, params = kernel_params(
        model, fb, direction, None if source is not None else (width, height))
    assert params.shape == (22,) and params.dtype == np.float32
    return _emulate_kernel(
        core_id, params, direction == "distort",
        t_models.base.DISTORT_INVERSE_ITERATIONS,
        size=(width, height), source=source)


def emulated_stack(models, fb, width, height, direction):
    """A lens stack a launch a layer: the first layer from the pixel
    index, each further one from the map (the CUDA route of stmap_stack
    for a distort stack; emulated_launches for any)."""
    models = list(models) if direction == "distort" else list(models)[::-1]
    out = None
    for model in models:
        out = emulated_map(model, fb, width, height, direction, source=out)
    return out


def emulated_launches(models, fb, width, height, direction, source=None):
    """A lens stack as csrc/stmap.cu's launch maps it: the layers in
    application order, one pack for every _PACK_LAYERS of them, and for
    each pack an undistort stack of two or more in one
    stmap_stack_kernel launch (ops/stmap.py::_fused_stack), any other
    one launch a layer; the first point from the pixel index, or with
    `source` from that map."""
    models = list(models) if direction == "distort" else list(models)[::-1]
    out = source
    for first in range(0, len(models), t_stmap._PACK_LAYERS):
        chunk = models[first:first + t_stmap._PACK_LAYERS]
        if not t_stmap._fused_stack(direction, len(chunk)):
            for model in chunk:
                out = emulated_map(model, fb, width, height, direction,
                                   source=out)
            continue
        packed = [kernel_params(model, fb, direction,
                                (width, height) if out is None and i == 0
                                else None)
                  for i, model in enumerate(chunk)]
        out = _emulate_stack_kernel(
            stack_cores([core for core, _ in packed]), len(chunk),
            [params for _, params in packed], size=(width, height),
            source=out)
    return out
