"""Lens distortion ST-map generation.

Port of mayamatchmovesolver_tpu/ops/stmap.py (ref:
lib/cppbind/mmlens/src/distortion_process.rs:26-70): for every pixel of
the output image, where it samples in the input (distort or undistort),
as an RGBA float32 ST-map (R=S, G=T, B=0, A=1).

  stmap_torch       — the plain PyTorch version, any model type, any
                      device.
  stmap_cuda        — the Hopper kernel (csrc/stmap.cu, mmsolver_stmap)
                      for the four 3DE models; counts its launches in
                      profiler.counters["stmap.launches"].
  stmap_layer_torch — one further layer of a lens stack applied to a
                      map, plain PyTorch, any device.
  stmap_layer_cuda  — the same by the kernel's layer variant
                      (mmsolver_stmap_layer), in place; counts its
                      launches in profiler.counters["stmap_layer.launches"].
  stmap             — the dispatcher: the kernel on a CUDA device, the
                      plain version on the CPU and for Passthrough.
  stmap_stack_torch — a lens-layer stack in plain PyTorch, any device.
  stmap_stack       — a lens-layer stack: on a CUDA device one kernel
                      launch a 3DE layer, on the CPU stmap_stack_torch.

There is no fallback: on CUDA a 3DE layer launches its kernel or raises.

The kernels' parameters fold the direction, the film back and the image
size into two affine maps around the polynomial core: 22 floats a layer,
computed in float64.  Where that happens follows from where the lens's
fields are (_packs_on_device):

  * every field a Python number (io/lensfile.py's models_at and
    film_back): on the host (_host_values reads nothing, _pack_params),
    the floats handed to the kernel by value;
  * any field a tensor on the map's CUDA device (a solved lens, or models
    made on the card): on the device, by csrc/stmap.cu's pack kernel,
    which reads the fields where they lie (_field_records), and the map
    kernel reads its floats from there; nothing comes back to the host,
    so the host does not wait for the card;
  * CPU tensors, or tensors on another device: on the host after one
    transfer (_host_values), as by value.

A CUDA call is the span "stmap.call" (utils/profiler.py).  On the host
paths it holds "stmap.host_read" (the transfer, counted in
profiler.counters["host_reads"]), "stmap.pack" (the host arithmetic) and
"stmap.launch" (the output's allocation and the launch); on the device
path only "stmap.launch" (the field records, the allocations and the
launches), and each launch of the pack kernel counts in
profiler.counters["stmap.device_packs"].
"""

import array
import dataclasses
import functools
import math
import struct

import numpy as np
import torch

from mayamatchmovesolver_torch import _kernels
from mayamatchmovesolver_torch.models import base, tde
from mayamatchmovesolver_torch.utils import profiler
from mayamatchmovesolver_torch.utils.profiler import span

# Core ids of csrc/stmap.cu.
_CORE_CLASSIC = 0
_CORE_RADIAL_DEG4 = 1
_CORE_ANAMORPHIC_DEG4 = 2
# csrc/stmap.cu's StmapParams holds 22 floats: 10 coefficients, then
# a_in (4), b_in (2), a_out (4), b_out (2).
_MAX_COEFFS = 10
_PARAM_COUNT = _MAX_COEFFS + 12
# csrc/stmap.cu's pack kernel: its Model kinds (a subclass before its
# base), a model's fields padded to _MODEL_FIELDS records, and at most
# _PACK_LAYERS layers a launch.
_MODEL_KINDS = ((tde.TdeClassic, 0), (tde.TdeRadialStdDeg4, 1),
                (tde.TdeAnamorphicStdDeg4Rescaled, 3),
                (tde.TdeAnamorphicStdDeg4, 2))
_MODEL_FIELDS = 14
_PACK_LAYERS = 8
# csrc/stmap.cu's Field: the host value, the device address of the
# field's one element (0: the value is the field), whether that element
# is a double, and 4 bytes of padding.
_FIELD = "dQii"
_PADDING = [0.0] * _MODEL_FIELDS
# Whether the element the pack kernel reads at a field's address is a
# double, for the element types it reads.
_IS_DOUBLE = {torch.float32: 0, torch.float64: 1}


def stmap_torch(model, film_back, width, height, direction="distort", *,
                device, dtype=torch.float32):
    """Whole-image ST map in plain PyTorch (any model type).

    Pixel centers sample at (x+0.5)/w, (y+0.5)/h in unit space, like the
    reference's image loops.  The grid is built in `dtype` on `device`;
    the model's and film back's tensors must lie on `device` too, and
    their Python float fields become tensors of `dtype` there.
    Returns (H, W, 4) float32.
    """
    model = base.as_tensors(model, device=device, dtype=dtype)
    film_back = base.as_tensors(film_back, device=device, dtype=dtype)
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


def stmap_layer_torch(st_map, model, film_back, direction="distort"):
    """One further lens layer applied point-wise to the (H, W, 4) map of
    the layers before it, in plain PyTorch on the map's device and in the
    film back's dtype (torch's default float type for Python floats): S
    and T are mapped, channels 2 and 3 carry through.  Returns a new
    float32 map."""
    work = torch.as_tensor(film_back.film_back_width_cm).dtype
    model = base.as_tensors(model, device=st_map.device, dtype=work)
    film_back = base.as_tensors(film_back, device=st_map.device, dtype=work)
    pts_marker = st_map[..., :2].to(work) - 0.5
    if direction == "distort":
        mapped = tde.distort(model, film_back, pts_marker)
    else:
        mapped = tde.undistort(model, film_back, pts_marker)
    return torch.cat(
        [(mapped + 0.5).to(torch.float32), st_map[..., 2:]], dim=-1
    )


def _host_values(*objs):
    """The fields of models and film backs as Python floats, one
    {name: value} an object, after one device-to-host transfer for all
    of them (none where every field already is a Python number)."""
    names = [[f.name for f in dataclasses.fields(obj)] for obj in objs]
    values = [getattr(obj, n) for obj, ns in zip(objs, names) for n in ns]
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    if tensors:
        first = tensors[0]
        if any(t.dtype != first.dtype or t.device != first.device
               for t in tensors):
            tensors = [t.to(device=first.device, dtype=torch.float64)
                       for t in tensors]
        with span("stmap.host_read"), torch.no_grad():
            # reshape: every field is one number, or this raises.
            stacked = torch.stack(tensors).reshape(len(tensors))
            fetched = iter(stacked.cpu().tolist())
        profiler.counters["host_reads"] += 1
        values = [next(fetched) if isinstance(v, torch.Tensor) else v
                  for v in values]
    flat = iter(values)
    return [{n: float(next(flat)) for n in ns} for ns in names]


@functools.lru_cache(maxsize=None)
def _field_names(cls):
    """The names of a model's or film back's fields, in the order of
    dataclasses.fields, which is the order csrc/stmap.cu reads them in."""
    return tuple(f.name for f in dataclasses.fields(cls))


def _lens_fields(film_back, layers):
    """(values, devices): the fields of a film back and its 3DE layers as
    csrc/stmap.cu's pack kernel reads them, the film back's five, then
    each layer's in dataclass order padded with zeros to _MODEL_FIELDS;
    and the device of each field that is a tensor, None for a Python
    number."""
    values = [getattr(film_back, n) for n in _field_names(type(film_back))]
    for model in layers:
        names = _field_names(type(model))
        values += [getattr(model, n) for n in names]
        values += _PADDING[len(names):]
    return values, [v.device if isinstance(v, torch.Tensor) else None
                    for v in values]


def _packs_on_device(field_devices, map_device):
    """Whether the kernels' parameters are packed on the map's CUDA device
    `map_device` (csrc/stmap.cu's pack kernel): where a field is a tensor
    there and none is a tensor on another CUDA device.  `field_devices`
    holds a field's device where it is a tensor, None where it is a
    Python number (_lens_fields).  Python numbers and CPU tensors among
    them ride along as host values.  Otherwise the host packs: with no
    read where every field is a Python number, after one read where a
    field is a tensor (_host_values)."""
    cuda = set(field_devices)
    cuda.discard(None)
    cuda = {d for d in cuda if d.type == "cuda"}
    if not cuda:
        return False
    if map_device.index is None:
        map_device = torch.device(map_device.type,
                                  torch.cuda.current_device())
    return cuda == {map_device}


def _model_kind(model):
    """csrc/stmap.cu's Model kind of a 3DE model."""
    for cls, kind in _MODEL_KINDS:
        if isinstance(model, cls):
            return kind
    raise TypeError("no CUDA ST-map kernel for %r" % (type(model),))


def _field_records(values, devices, device, keep):
    """The flat values of csrc/stmap.cu's Field records of _lens_fields'
    `values` and `devices`: a tensor on `device` by the address of its
    element, a Python number or a tensor elsewhere (a CPU tensor,
    _packs_on_device) by its value.  A tensor on `device` of neither
    float32 nor float64 is converted to float64 there and the copy
    appended to `keep`, which the caller holds until the launch is
    queued.  Raises ValueError for a tensor that is not one number."""
    out = []
    for v, d in zip(values, devices):
        if d is None:
            out += (float(v), 0, 0, 0)
            continue
        if v.numel() != 1:
            raise ValueError("a lens field holds %d numbers, not one"
                             % v.numel())
        if d != device:
            out += (float(v), 0, 0, 0)
            continue
        is_double = _IS_DOUBLE.get(v.dtype)
        if is_double is None:
            v, is_double = v.to(torch.float64), 1
            keep.append(v)
        out += (0.0, v.data_ptr(), is_double, 0)
    return out


@functools.lru_cache(maxsize=None)
def _records(layers):
    """The struct packing the film back's and `layers` models' Field
    records, each model padded to _MODEL_FIELDS."""
    return struct.Struct("<" + _FIELD * (5 + layers * _MODEL_FIELDS))


def _packed_launch_args(st_map, layers, film_back, direction, from_pixels,
                        params, keep, fields=None):
    """(C entry point, its arguments) of csrc/stmap.cu's packed launch of
    up to _PACK_LAYERS 3DE layers (in application order) on the (H, W, 4)
    float32 CUDA map `st_map`, on its device's current stream: the pack
    kernel writes each layer's floats to the device address `params`
    onward, then one map launch a layer reads them there, the first from
    the pixel index where `from_pixels`, every other in place.  `fields`
    is _lens_fields' pair where the caller has it.  The arguments hold
    the host records themselves; device copies that a field needed
    (_field_records) go to `keep`."""
    device = st_map.device
    values, devices = fields or _lens_fields(film_back, layers)
    records = _field_records(values, devices, device, keep)
    kinds = array.array("i", [_model_kind(m) for m in layers])
    height, width = st_map.shape[:2]
    function = _kernels.stmap_packed_functions()[not from_pixels]
    # The raw stream of torch.cuda.current_stream(device).cuda_stream,
    # without making a Stream object (a few microseconds a call).
    return function, (st_map.data_ptr(), width, height,
                      int(direction == "distort"), len(layers),
                      kinds.tobytes(), _records(len(layers)).pack(*records),
                      params, torch._C._cuda_getCurrentRawStream(
                          device.index))


def _launch_packed(st_map, layers, film_back, direction, from_pixels,
                   fields=None):
    """The lens stack `layers` (3DE models, in application order) on the
    (H, W, 4) float32 CUDA map `st_map` with its parameters packed on the
    map's device (_packed_launch_args), into a buffer allocated here: one
    pack launch for every _PACK_LAYERS layers.  `fields` is _lens_fields'
    pair of a stack of at most _PACK_LAYERS layers where the caller has
    it.  Nothing is read back to the host and nothing waits.  Counts the
    launches."""
    device = st_map.device
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch_packed(st_map, layers, film_back, direction,
                                  from_pixels, fields)
    params = torch.empty(len(layers) * _PARAM_COUNT, dtype=torch.float32,
                         device=device)
    keep = []
    for first in range(0, len(layers), _PACK_LAYERS):
        function, args = _packed_launch_args(
            st_map, layers[first:first + _PACK_LAYERS], film_back,
            direction, from_pixels and first == 0,
            params.data_ptr() + 4 * _PARAM_COUNT * first, keep,
            fields if len(layers) <= _PACK_LAYERS else None)
        err = function(*args)
        if err != 0:
            raise RuntimeError("stmap kernel launch failed: CUDA error %d"
                               % err)
        profiler.counters["stmap.device_packs"] += 1
    profiler.counters["stmap.launches"] += int(from_pixels)
    profiler.counters["stmap_layer.launches"] += len(layers) - from_pixels


# 2x2 matrices on the host are ((m00, m01), (m10, m11)) of Python floats:
# at this size numpy's calls cost more than the arithmetic.

_IDENTITY2 = ((1.0, 0.0), (0.0, 1.0))


def _matmul2(a, b):
    (a00, a01), (a10, a11) = a
    (b00, b01), (b10, b11) = b
    return ((a00 * b00 + a01 * b10, a00 * b01 + a01 * b11),
            (a10 * b00 + a11 * b10, a10 * b01 + a11 * b11))


def _inverse2(m):
    (a, b), (c, d) = m
    det = a * d - b * c
    return ((d / det, -b / det), (-c / det, a / det))


def _cylindric_matrix(phi_deg, b):
    """tde._cylindric_matrix in Python floats."""
    q = math.sqrt(1.0 + b)
    c = math.cos(phi_deg * tde.DEG2RAD)
    s = math.sin(phi_deg * tde.DEG2RAD)
    m01 = (q - 1.0 / q) * c * s
    return ((c * c * q + s * s / q, m01), (m01, c * c / q + s * s * q))


def _anamorphic_matrices(lens_rotation, squeeze_x, squeeze_y, pixel_aspect,
                         rescale=None):
    """tde._anamorphic_matrices in Python floats: (A, B) with
    A = R(rot) @ Sx @ Sy [@ Rescale] @ Pa and B = Pa [@ Rescale] @ R(rot).
    The rescale extender scales x only, like squeeze_x."""
    c = math.cos(lens_rotation * tde.DEG2RAD)
    s = math.sin(lens_rotation * tde.DEG2RAD)
    rot = ((c, -s), (s, c))
    x_scale = pixel_aspect if rescale is None else rescale * pixel_aspect
    a = _matmul2(rot, ((squeeze_x * x_scale, 0.0), (0.0, squeeze_y)))
    b = _matmul2(((x_scale, 0.0), (0.0, 1.0)), rot)
    return a, b


def _model_kernel_config(model, values, film_back_values):
    """(core id, coefficients, pre, post) for the uniform
    undistort(xy) = post @ core(pre @ xy) structure, in Python floats
    (float64) on the host like the reference's _model_kernel_config.
    `values` and `film_back_values` are the model's and the film back's
    fields (_host_values).  The coefficients are those of csrc/stmap.cu's
    displacement polynomial h = core - identity."""
    v = values
    if isinstance(model, tde.TdeClassic):
        ld, sq, qu = v["distortion"], v["anamorphic_squeeze"], \
            v["quartic_distortion"]
        coeffs = [ld / sq, (ld + v["curvature_x"]) / sq,
                  ld + v["curvature_y"], ld, qu / sq, qu]
        return _CORE_CLASSIC, coeffs, _IDENTITY2, _IDENTITY2
    if isinstance(model, tde.TdeRadialStdDeg4):
        coeffs = [v["degree2_distortion"], v["degree2_u"], v["degree2_v"],
                  v["degree4_distortion"], v["degree4_u"], v["degree4_v"]]
        post = _cylindric_matrix(v["cylindric_direction"],
                                 v["cylindric_bending"])
        return _CORE_RADIAL_DEG4, coeffs, _IDENTITY2, post
    if isinstance(model, tde.TdeAnamorphicStdDeg4):
        # cos(2 phi) * r^2 = d and cos(4 phi) * r^4 = 2 d^2 - r^4 with
        # d = x^2 - y^2: the r^4 term takes c04 - c44, the d^2 term 2 c44.
        coeffs = [v["degree2_cx02"], v["degree2_cy02"],
                  v["degree2_cx22"], v["degree2_cy22"],
                  v["degree4_cx04"] - v["degree4_cx44"],
                  v["degree4_cy04"] - v["degree4_cy44"],
                  v["degree4_cx24"], v["degree4_cy24"],
                  2.0 * v["degree4_cx44"], 2.0 * v["degree4_cy44"]]
        a, b = _anamorphic_matrices(
            v["lens_rotation"], v["squeeze_x"], v["squeeze_y"],
            film_back_values["pixel_aspect"], v.get("rescale"))
        return _CORE_ANAMORPHIC_DEG4, coeffs, _inverse2(b), a
    raise TypeError("no CUDA ST-map kernel for %r" % (type(model),))


def _pack_params(model, values, film_back_values, direction, size):
    """(core id, the 22 host floats csrc/stmap.cu reads) from
    host values.  `size` is (width, height) where the kernel's source
    point is the pixel index (col, row), None where it is (S, T) of a
    previous layer's map.  Both affine maps are folded in float64:

      core input  = a_in  @ source + b_in   (source -> unit -> dn -> m_in)
      (S, T)      = a_out @ core output + b_out   (m_out -> dn -> unit)
    """
    core_id, coeffs, pre, post = _model_kernel_config(
        model, values, film_back_values)
    if direction == "distort":
        m_in, m_out = _inverse2(post), _inverse2(pre)
    else:
        m_in, m_out = pre, post
    fb = film_back_values
    fbw, fbh = fb["film_back_width_cm"], fb["film_back_height_cm"]
    lcox, lcoy = fb["lens_center_offset_x_cm"], fb["lens_center_offset_y_cm"]
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
    params = coeffs + [0.0] * (_MAX_COEFFS - len(coeffs)) + frames
    return core_id, np.array(params, np.float32)


def _kernel_params(model, film_back, direction, size, host_values=None):
    """_pack_params of a model and film back given as tensors, or from
    `host_values` = (the film back's, the model's) where the caller has
    fetched them already (_host_values)."""
    fb_values, values = host_values or _host_values(film_back, model)
    with span("stmap.pack"):
        return _pack_params(model, values, fb_values, direction, size)


def _launch_args(st_map, core_id, direction, params):
    """The arguments of either C entry point of csrc/stmap.cu for the
    (H, W, 4) CUDA map, on its device's current stream.  They hold
    addresses into `st_map` and `params`, which the caller keeps alive."""
    height, width = st_map.shape[:2]
    return (st_map.data_ptr(), width, height, core_id,
            int(direction == "distort"), params.ctypes.data,
            torch.cuda.current_stream(st_map.device).cuda_stream)


def _launch(function, st_map, core_id, direction, params):
    """One launch of a C entry point of csrc/stmap.cu on the (H, W, 4)
    CUDA map's device, on the current stream."""
    if st_map.device.index != torch.cuda.current_device():
        with torch.cuda.device(st_map.device):
            return _launch(function, st_map, core_id, direction, params)
    err = function(*_launch_args(st_map, core_id, direction, params))
    if err != 0:
        raise RuntimeError("stmap kernel launch failed: CUDA error %d" % err)


def _checked_size(width, height, direction):
    """(width, height) as ints; raises ValueError for a size that is not
    positive or a direction that is neither 'distort' nor 'undistort'."""
    if direction not in ("distort", "undistort"):
        raise ValueError("direction must be 'distort' or 'undistort'")
    width, height = int(width), int(height)
    if width <= 0 or height <= 0:
        raise ValueError("image size must be positive: %dx%d"
                         % (width, height))
    return width, height


def _packed_map(layers, film_back, width, height, direction, device,
                fields):
    """A new (H, W, 4) float32 map on the CUDA `device` made by the lens
    stack `layers` with its parameters packed there (_launch_packed, with
    _lens_fields' `fields`); the span "stmap.launch"."""
    with span("stmap.launch"):
        out = torch.empty((height, width, 4), dtype=torch.float32,
                          device=device)
        _launch_packed(out, layers, film_back, direction, True, fields)
    return out


def stmap_cuda(model, film_back, width, height, direction="distort", *,
               device, host_values=None):
    """ST map by the Hopper kernel (csrc/stmap.cu) for the four 3DE
    models; returns (H, W, 4) float32 on the CUDA `device`.

    Raises unless `device` is a CUDA device; builds the kernel at first
    use.  The kernel takes no tensor input: it writes the contiguous
    float32 output allocated here.  A lens with a field on `device` is
    packed there (_launch_packed); otherwise, or where `host_values` is
    given, on the host, where `host_values` spares the device-to-host
    transfer (see _kernel_params).  Each launch adds one to
    profiler.counters["stmap.launches"].
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("stmap_cuda needs a CUDA device, got %s" % device)
    width, height = _checked_size(width, height, direction)
    with span("stmap.call"):
        if host_values is None:
            fields = _lens_fields(film_back, [model])
            if _packs_on_device(fields[1], device):
                return _packed_map([model], film_back, width, height,
                                   direction, device, fields)
        core_id, params = _kernel_params(model, film_back, direction,
                                         (width, height), host_values)
        with span("stmap.launch"):
            out = torch.empty((height, width, 4), dtype=torch.float32,
                              device=device)
            _launch(_kernels.stmap_functions()[0], out, core_id, direction,
                    params)
    profiler.counters["stmap.launches"] += 1
    return out


def stmap_layer_cuda(st_map, model, film_back, direction="distort", *,
                     host_values=None):
    """One further 3DE lens layer applied to `st_map` in place by the
    kernel's layer variant (csrc/stmap.cu, mmsolver_stmap_layer): every
    texel's (S, T) is mapped, channels 2 and 3 stay.  Returns `st_map`.

    `st_map` must be a contiguous float32 (H, W, 4) tensor on a CUDA
    device; anything else raises.  The parameters are packed as by
    stmap_cuda, on the map's device or on the host.  Each launch adds one
    to profiler.counters["stmap_layer.launches"].
    """
    if not isinstance(st_map, torch.Tensor) or not st_map.is_cuda:
        raise ValueError("stmap_layer_cuda needs a map on a CUDA device")
    if st_map.dtype != torch.float32:
        raise ValueError("the map must be float32, got %s" % st_map.dtype)
    if st_map.dim() != 3 or st_map.shape[2] != 4 or st_map.numel() == 0:
        raise ValueError("the map must be (H, W, 4), got %s"
                         % (tuple(st_map.shape),))
    if not st_map.is_contiguous():
        raise ValueError("the map must be contiguous")
    if direction not in ("distort", "undistort"):
        raise ValueError("direction must be 'distort' or 'undistort'")
    with span("stmap.call"):
        if host_values is None:
            fields = _lens_fields(film_back, [model])
            if _packs_on_device(fields[1], st_map.device):
                with span("stmap.launch"):
                    _launch_packed(st_map, [model], film_back, direction,
                                   False, fields)
                return st_map
        core_id, params = _kernel_params(model, film_back, direction, None,
                                         host_values)
        with span("stmap.launch"):
            _launch(_kernels.stmap_functions()[1], st_map, core_id,
                    direction, params)
    profiler.counters["stmap_layer.launches"] += 1
    return st_map


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


def _in_application_order(models, direction):
    """Distortion applies the layers in order, undistortion the inverses
    in reverse."""
    models = list(models)
    return models if direction == "distort" else models[::-1]


def stmap_stack_torch(models, film_back, width, height,
                      direction="distort", *, device):
    """ST map for a multi-layer lens stack in plain PyTorch on `device`:
    the first layer by stmap_torch, each further one by
    stmap_layer_torch.  An empty stack is Passthrough."""
    models = _in_application_order(models, direction) or [tde.Passthrough()]
    out = stmap_torch(models[0], film_back, width, height, direction,
                      device=device)
    for model in models[1:]:
        out = stmap_layer_torch(out, model, film_back, direction)
    return out


def stmap_stack(models, film_back, width, height, direction="distort", *,
                device):
    """ST map for a multi-layer lens stack, (H, W, 4) float32 on `device`.

    Distortion applies the layers in order, undistortion the inverses in
    reverse (the reference chains per-point virtual calls,
    lens_model.h:36-120); an empty stack is Passthrough; channels 2 and 3
    carry through.  On the CPU this is stmap_stack_torch.  On a CUDA
    device every 3DE layer is one kernel launch — the first writes the
    map from the pixel index (stmap_cuda's kernel), each further one
    maps it in place (stmap_layer_cuda's) — with the parameters of all
    layers packed in one launch on the device where a field lies there,
    else on the host after at most one device-to-host transfer (see
    stmap_cuda); a Passthrough layer is the identity and launches
    nothing; there is no fallback.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return stmap_stack_torch(models, film_back, width, height, direction,
                                 device=device)
    if device.type != "cuda":
        raise ValueError("stmap runs on 'cpu' or 'cuda', got %s" % device)
    layers = [m for m in _in_application_order(models, direction)
              if not isinstance(m, tde.Passthrough)]
    if not layers:
        return stmap(tde.Passthrough(), film_back, width, height, direction,
                     device=device)
    with span("stmap.call"):
        fields = _lens_fields(film_back, layers)
        if _packs_on_device(fields[1], device):
            return _packed_map(layers, film_back,
                               *_checked_size(width, height, direction),
                               direction, device, fields)
        fb_values, *layer_values = _host_values(film_back, *layers)
        out = stmap_cuda(layers[0], film_back, width, height, direction,
                         device=device,
                         host_values=(fb_values, layer_values[0]))
        for model, values in zip(layers[1:], layer_values[1:]):
            stmap_layer_cuda(out, model, film_back, direction,
                             host_values=(fb_values, values))
    return out
