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
                      launch a 3DE layer, or one for an undistort stack
                      (counted also in
                      profiler.counters["stmap.stack_launches"]); on the
                      CPU stmap_stack_torch.

There is no fallback: on CUDA a 3DE layer launches its kernel or raises.

The kernels' parameters fold the direction, the film back and the image
size into two affine maps around the polynomial core: 22 floats a layer,
computed in float64 on the map's device by csrc/stmap.cu's pack kernel
(one launch for up to _PACK_LAYERS layers), where the map launches that
follow read them (_launch_packed).  The pack kernel takes each field of
the film back and the layers as a record made from where the field lies
(_field_records):

  * a tensor on the map's device (a solved lens, or models made on the
    card): the address of its element, read there by the pack kernel;
  * a Python number (io/lensfile.py's models_at and film_back) or a CPU
    tensor: its value;
  * a tensor on another device: its value too, read with every other
    such field in one device-to-host transfer (_host_values), the only
    case in which the host waits for a device.

A CUDA call is the span "stmap.call" (utils/profiler.py), which holds
"stmap.launch" (the records, the allocations and the launches); inside
it a transfer is "stmap.host_read", counted in
profiler.counters["host_reads"], and each launch of the pack kernel
counts in profiler.counters["stmap.device_packs"].  Under a running
torch.profiler capture the spans are operator records, so the pack and
map kernels are put down to "stmap.launch"; while spans are on each is
also logged on the host clock (profiler.span_log).
"""

import array
import dataclasses
import functools
import struct

import torch

from mayamatchmovesolver_torch import _kernels
from mayamatchmovesolver_torch.models import base, tde
from mayamatchmovesolver_torch.utils import profiler
from mayamatchmovesolver_torch.utils.profiler import span

# csrc/stmap.cu's StmapParams holds 22 floats: 10 coefficients, then
# a_in (4), b_in (2), a_out (4), b_out (2).
_PARAM_COUNT = 22
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


def _host_values(tensors):
    """The Python floats of one-number tensors, after one device-to-host
    transfer for all of them: the span "stmap.host_read", counted in
    profiler.counters["host_reads"]."""
    first = tensors[0]
    if any(t.dtype != first.dtype or t.device != first.device
           for t in tensors):
        tensors = [t.to(device=first.device, dtype=torch.float64)
                   for t in tensors]
    with span("stmap.host_read"), torch.no_grad():
        # reshape: every tensor is one number, or this raises.
        values = torch.cat([t.reshape(1) for t in tensors]).cpu().tolist()
    profiler.counters["host_reads"] += 1
    return values


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


def _model_kind(model):
    """csrc/stmap.cu's Model kind of a 3DE model."""
    for cls, kind in _MODEL_KINDS:
        if isinstance(model, cls):
            return kind
    raise TypeError("no CUDA ST-map kernel for %r" % (type(model),))


def _field_records(values, devices, device, keep):
    """The flat values of csrc/stmap.cu's Field records of _lens_fields'
    `values` and `devices`, from where each field lies: a tensor on the
    map's device `device` by the address of its element; a Python number
    or a CPU tensor by its value; a tensor on another device by its value
    too, read with every other such field in one transfer (_host_values).
    A tensor on `device` of neither float32 nor float64 is converted to
    float64 there and the copy appended to `keep`, which the caller holds
    until the launch is queued.  Raises ValueError for a tensor that is
    not one number."""
    out, elsewhere = [], []
    for v, d in zip(values, devices):
        if d is None:
            out += (float(v), 0, 0, 0)
            continue
        if v.numel() != 1:
            raise ValueError("a lens field holds %d numbers, not one"
                             % v.numel())
        if d == device:
            is_double = _IS_DOUBLE.get(v.dtype)
            if is_double is None:
                v, is_double = v.to(torch.float64), 1
                keep.append(v)
            out += (0.0, v.data_ptr(), is_double, 0)
        elif d.type == "cpu":
            out += (float(v), 0, 0, 0)
        else:
            elsewhere.append(len(out))
            out += (v, 0, 0, 0)
    if elsewhere:
        read = _host_values([out[at] for at in elsewhere])
        for at, value in zip(elsewhere, read):
            out[at] = value
    return out


@functools.lru_cache(maxsize=None)
def _records(layers):
    """The struct packing the film back's and `layers` models' Field
    records, each model padded to _MODEL_FIELDS."""
    return struct.Struct("<" + _FIELD * (5 + layers * _MODEL_FIELDS))


def _packed_launch_args(st_map, layers, direction, from_pixels, records,
                        params):
    """(C entry point, its arguments) of csrc/stmap.cu's launch of up to
    _PACK_LAYERS 3DE layers `layers` (in application order) on the
    (H, W, 4) float32 CUDA map `st_map`, on its device's current stream:
    the pack kernel writes each layer's floats, from the film back's and
    these layers' Field records `records` (_field_records), to the device
    address `params` onward, then one map launch a layer reads them
    there, the first from the pixel index where `from_pixels`, every
    other in place.  The arguments hold the packed records themselves."""
    kinds = array.array("i", [_model_kind(m) for m in layers])
    height, width = st_map.shape[:2]
    function = _kernels.stmap_functions()[not from_pixels]
    # The raw stream of torch.cuda.current_stream(device).cuda_stream,
    # without making a Stream object (a few microseconds a call).
    return function, (st_map.data_ptr(), width, height,
                      int(direction == "distort"), len(layers),
                      kinds.tobytes(), _records(len(layers)).pack(*records),
                      params, torch._C._cuda_getCurrentRawStream(
                          st_map.device.index))


def _fused_stack(direction, layers):
    """Whether csrc/stmap.cu's launch maps a pack launch's `layers` layers
    in one stmap_stack_kernel launch: an undistort stack of two or more,
    its points chained in registers and the map written once.  Else it
    launches the map kernel once a layer."""
    return direction == "undistort" and layers >= 2


def _launch_packed(st_map, layers, film_back, direction, from_pixels):
    """The lens stack `layers` (3DE models, in application order) on the
    (H, W, 4) float32 CUDA map `st_map`, its parameters packed on the
    map's device (_packed_launch_args) into a buffer allocated here: one
    pack launch for every _PACK_LAYERS layers, from the records of the
    whole stack (at most one read to the host, _field_records), then the
    map launches (_fused_stack).  Counts the launches."""
    device = st_map.device
    keep = []
    records = _field_records(*_lens_fields(film_back, layers), device, keep)
    params = torch.empty(len(layers) * _PARAM_COUNT, dtype=torch.float32,
                         device=device)
    head, per_layer = 4 * 5, 4 * _MODEL_FIELDS
    for first in range(0, len(layers), _PACK_LAYERS):
        chunk = layers[first:first + _PACK_LAYERS]
        at = head + per_layer * first
        from_pixel = int(from_pixels and first == 0)
        function, args = _packed_launch_args(
            st_map, chunk, direction, from_pixel,
            records[:head] + records[at:at + per_layer * len(chunk)],
            params.data_ptr() + 4 * _PARAM_COUNT * first)
        _kernels.launch(device, function, *args)
        profiler.counters["stmap.device_packs"] += 1
        # A launch from the pixel index counts in "stmap.launches", one
        # from a map in "stmap_layer.launches"; a fused stack is one of
        # either, counted also in "stmap.stack_launches".
        fused = _fused_stack(direction, len(chunk))
        profiler.counters["stmap.launches"] += from_pixel
        profiler.counters["stmap_layer.launches"] += (
            (1 if fused else len(chunk)) - from_pixel)
        profiler.counters["stmap.stack_launches"] += int(fused)


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


def _packed_map(layers, film_back, width, height, direction, device):
    """A new (H, W, 4) float32 map on the CUDA `device` made by the lens
    stack `layers` (_launch_packed); the span "stmap.launch"."""
    with span("stmap.launch"):
        out = torch.empty((height, width, 4), dtype=torch.float32,
                          device=device)
        _launch_packed(out, layers, film_back, direction, True)
    return out


def stmap_cuda(model, film_back, width, height, direction="distort", *,
               device):
    """ST map by the Hopper kernel (csrc/stmap.cu) for the four 3DE
    models; returns (H, W, 4) float32 on the CUDA `device`.

    Raises unless `device` is a CUDA device; builds the kernel at first
    use.  The kernel takes no tensor input: it writes the contiguous
    float32 output allocated here, after the pack kernel has folded the
    lens's fields where they lie (_launch_packed).  Each launch adds one
    to profiler.counters["stmap.launches"].
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("stmap_cuda needs a CUDA device, got %s" % device)
    width, height = _checked_size(width, height, direction)
    with span("stmap.call"):
        return _packed_map([model], film_back, width, height, direction,
                           device)


def stmap_layer_cuda(st_map, model, film_back, direction="distort"):
    """One further 3DE lens layer applied to `st_map` in place by the
    kernel's layer variant (csrc/stmap.cu, mmsolver_stmap_layer): every
    texel's (S, T) is mapped, channels 2 and 3 stay.  Returns `st_map`.

    `st_map` must be a contiguous float32 (H, W, 4) tensor on a CUDA
    device; anything else raises.  The parameters are packed as by
    stmap_cuda.  Each launch adds one to
    profiler.counters["stmap_layer.launches"].
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
    with span("stmap.call"), span("stmap.launch"):
        _launch_packed(st_map, [model], film_back, direction, False)
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
    device, after one pack launch for every _PACK_LAYERS layers (see
    stmap_cuda), a distort stack is one kernel launch a 3DE layer — the
    first writes the map from the pixel index (stmap_cuda's kernel),
    each further one maps it in place (stmap_layer_cuda's) — and an
    undistort stack of two or more is one launch for those layers,
    which chains them in registers and writes the map once, bit-equal
    to a launch a layer (_fused_stack); a Passthrough layer is the
    identity and launches nothing; there is no fallback.
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
    width, height = _checked_size(width, height, direction)
    with span("stmap.call"):
        return _packed_map(layers, film_back, width, height, direction,
                           device)
