"""What the ST-map wrapper hands csrc/stmap.cu's pack kernel for a lens.

The pack kernel reads each model's fields in the order of
dataclasses.fields, padded to the same count, as csrc/stmap.cu's Field
records.  How ops/stmap.py::_field_records makes each field's record
follows from where the field lies and the map's device alone: a tensor
on the map's device by its element's address (checked here with CPU
tensors and the CPU, or a device named in a case, as the map's device:
only the records take them), a Python number or a CPU tensor by its
value, a tensor on another device by its value read in one transfer for
all such fields.  _launch_packed hands those records to the C entry
points through _kernels.launch, checked here with stand-ins.  The
kernels themselves run on the card: tests/test_torch/test_torch_cuda.py
holds their floats to the CPU transcription.  Imports nothing of jax.
"""

import contextlib
import dataclasses
import struct

import pytest
import torch

import mayamatchmovesolver_torch.models as t_models
import mayamatchmovesolver_torch.ops.stmap as t_stmap
from _torch_stmap_models import MODELS, torch_model
from mayamatchmovesolver_torch.utils.profiler import counters

CPU = torch.device("cpu")
CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)

# (field devices, map device, each field's record: "v" its value, "a" the
# address of its element, "r" its value read to the host with the other
# "r" fields in one transfer).
CHOICES = {
    "python_numbers": ([None] * 10, CUDA0, "v" * 10),
    "cpu_tensors": ([CPU] * 10, CUDA0, "v" * 10),
    "cpu_tensors_and_numbers": ([CPU, None] * 5, CUDA0, "v" * 10),
    "on_the_map_device": ([CUDA0] * 10, CUDA0, "a" * 10),
    "on_it_and_numbers": ([CUDA0] * 5 + [None] * 5, CUDA0, "a" * 5 + "v" * 5),
    "on_it_and_cpu": ([CUDA0, CPU] * 5, CUDA0, "av" * 5),
    "one_field_on_it": ([None] * 9 + [CUDA1], CUDA1, "v" * 9 + "a"),
    "on_another_card": ([CUDA1] * 10, CUDA0, "r" * 10),
    "on_two_cards": ([CUDA0] * 5 + [CUDA1] * 5, CUDA0, "a" * 5 + "r" * 5),
    "no_fields": ([], CUDA0, ""),
}


@pytest.mark.parametrize("case", list(CHOICES))
def test_packs_on_device_from_where_the_fields_lie(case):
    """Each field's record from where it lies (the devices of the case;
    the values CPU tensors, which stand in for a card's, or Python
    numbers), and one read where any field lies on another card."""
    devices, map_device, want = CHOICES[case]
    values = [0.25 * i + 0.5 if d is None else torch.tensor(
        0.25 * i + 0.5, dtype=(torch.float32, torch.float64)[i % 2])
        for i, d in enumerate(devices)]
    reads = counters["host_reads"]
    records = t_stmap._field_records(values, devices, map_device, [])
    assert counters["host_reads"] == reads + ("r" in want)
    records = list(zip(*[iter(records)] * 4))
    assert len(records) == len(want)
    for i, (how, v, record) in enumerate(zip(want, values, records)):
        if how == "a":
            assert record == (0.0, v.data_ptr(), i % 2, 0), i
        else:
            assert record == (0.25 * i + 0.5, 0, 0, 0), i


def test_lens_fields_in_the_order_the_pack_kernel_reads():
    """The film back's five fields, then each layer's in the order of
    dataclasses.fields padded with zeros to _MODEL_FIELDS; the device of
    each tensor, None for each Python number and padding."""
    classic, fb = torch_model("classic")
    radial, _ = torch_model("radial_deg4")
    radial = dataclasses.replace(radial, degree2_u=0.01)
    values, devices = t_stmap._lens_fields(fb, [classic, radial])
    pad = t_stmap._MODEL_FIELDS
    assert len(values) == len(devices) == 5 + 2 * pad
    for obj, at in ((fb, 0), (classic, 5), (radial, 5 + pad)):
        for i, f in enumerate(dataclasses.fields(obj)):
            want = getattr(obj, f.name)
            assert values[at + i] is want, f.name
            assert devices[at + i] == (
                want.device if isinstance(want, torch.Tensor) else None)
    assert values[5 + 5:5 + pad] == [0.0] * (pad - 5)
    assert devices[5 + 5:5 + pad] == [None] * (pad - 5)
    assert devices[5 + pad + 1] is None  # degree2_u, a Python number
    assert values[5 + pad + 8:] == [0.0] * (pad - 8)
    assert t_stmap._lens_fields(fb, []) == (
        [getattr(fb, f.name) for f in dataclasses.fields(fb)], [CPU] * 5)


@pytest.mark.parametrize("name", list(MODELS))
def test_field_records_follow_the_fields(name):
    """Every other field a Python number, the rest float32 and float64
    tensors on the map's device (here the CPU, which only the records can
    take): numbers by value, tensors by address and element type, the
    padding by value; and the model's kind."""
    model, fb = torch_model(name)
    fields = dataclasses.fields(model)
    assert len(fields) <= t_stmap._MODEL_FIELDS
    given = {}
    for i, f in enumerate(fields):
        value = float(getattr(model, f.name))
        given[f.name] = value if i % 2 else torch.tensor(
            value, dtype=(torch.float32, torch.float64)[i % 4 == 0])
    mixed = type(model)(**given)
    keep = []
    values, devices = t_stmap._lens_fields(fb, [mixed])
    records = t_stmap._field_records(values, devices, CPU, keep)
    assert keep == [] and len(records) == 4 * (5 + t_stmap._MODEL_FIELDS)
    records = list(zip(*[iter(records)] * 4))
    for f, record in zip(fields, records[5:]):
        v = given[f.name]
        if isinstance(v, torch.Tensor):
            assert record == (0.0, v.data_ptr(),
                              int(v.dtype == torch.float64), 0), f.name
        else:
            assert record == (v, 0, 0, 0), f.name
    assert records[5 + len(fields):] == [(0.0, 0, 0, 0)] * (
        t_stmap._MODEL_FIELDS - len(fields))
    kind = dict(classic=0, radial_deg4=1, anamorphic_deg4=2,
                anamorphic_deg4_rescaled=3)[name]
    assert t_stmap._model_kind(mixed) == kind


def test_field_records_take_values_of_tensors_elsewhere():
    """A lens of CPU tensors beside a map on a card: each field by its
    value."""
    model, fb = torch_model("classic")
    values, devices = t_stmap._lens_fields(fb, [model])
    records = t_stmap._field_records(values, devices, CUDA0, [])
    assert records == [x for v in values for x in (float(v), 0, 0, 0)]


def test_field_records_convert_other_element_types():
    model, fb = torch_model("classic")
    half = dataclasses.replace(model, distortion=torch.tensor(
        0.25, dtype=torch.float16))
    keep = []
    records = t_stmap._field_records(*t_stmap._lens_fields(fb, [half]), CPU,
                                     keep)
    assert len(keep) == 1 and keep[0].dtype == torch.float64
    assert float(keep[0]) == 0.25
    assert records[4 * 5:4 * 6] == [0.0, keep[0].data_ptr(), 1, 0]


@pytest.mark.parametrize("field", [torch.zeros(2), torch.zeros(1, 3),
                                   torch.zeros(0)])
@pytest.mark.parametrize("device", [CPU, CUDA0])
def test_field_records_refuse_a_field_that_is_not_one_number(field, device):
    model, fb = torch_model("classic")
    bad = dataclasses.replace(model, curvature_x=field)
    with pytest.raises(ValueError, match="%d numbers, not one"
                       % field.numel()):
        t_stmap._field_records(*t_stmap._lens_fields(fb, [bad]), device, [])


def test_field_records_pack_to_the_kernels_layout():
    """csrc/stmap.cu's Field is 24 bytes: the value, the address, the
    element type and padding; a launch's records are the film back's five
    then _MODEL_FIELDS a layer."""
    assert struct.calcsize("<" + t_stmap._FIELD) == 24
    model, fb = torch_model("classic")
    records = t_stmap._field_records(*t_stmap._lens_fields(fb, [model]),
                                     CPU, [])
    packed = t_stmap._records(1).pack(*records)
    assert len(packed) == 24 * (5 + t_stmap._MODEL_FIELDS)
    value, address, is_double, _ = struct.unpack_from("<dQii", packed,
                                                      24 * 5)
    assert (value, address, is_double) == (
        0.0, model.distortion.data_ptr(), 0)
    assert struct.unpack_from("<dQii", packed, len(packed) - 24) == (
        0.0, 0, 0, 0)


def test_model_kind_refuses_what_has_no_kernel():
    with pytest.raises(TypeError, match="no CUDA ST-map kernel"):
        t_stmap._model_kind(t_models.Passthrough())


ENTRIES = ("mmsolver_stmap", "mmsolver_stmap_layer")


def _stand_in_launches(monkeypatch):
    """The C entry points and _kernels.launch replaced by stand-ins (a CPU
    map then takes them): returns the list each launch's (device, entry
    point, arguments) is appended to."""
    calls = []
    monkeypatch.setattr(t_stmap._kernels, "stmap_functions",
                        lambda: ENTRIES)
    monkeypatch.setattr(t_stmap._kernels, "launch",
                        lambda device, function, *args: calls.append(
                            (device, function, args)))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 7, raising=False)
    return calls


@pytest.mark.parametrize("from_pixels", [True, False])
@pytest.mark.parametrize("count", [1, 8, 9, 17])
def test_launch_packed_hands_each_launch_its_records(monkeypatch, count,
                                                     from_pixels):
    """_launch_packed with stand-ins for the C entry points and a CPU map
    (which only the stand-ins take): one launch for every _PACK_LAYERS
    layers, each with the film back's records and its own layers', their
    kinds and its slice of one parameter buffer; only the first from the
    pixel index, and only where the map is made from it."""
    calls = _stand_in_launches(monkeypatch)
    names = list(MODELS)
    layers = [torch_model(names[i % 4])[0] for i in range(count)]
    _, fb = torch_model("classic")
    st_map = torch.zeros(3, 5, 4)
    before = counters.copy()
    t_stmap._launch_packed(st_map, layers, fb, "undistort", from_pixels)
    chunks = [layers[i:i + 8] for i in range(0, count, 8)]
    assert len(calls) == len(chunks)
    records = t_stmap._field_records(*t_stmap._lens_fields(fb, layers),
                                     CPU, [])
    params = calls[0][2][7]
    for n, ((device, function, args), chunk) in enumerate(zip(calls,
                                                              chunks)):
        assert device == CPU
        assert function == ENTRIES[not (from_pixels and n == 0)]
        at = 4 * (5 + t_stmap._MODEL_FIELDS * 8 * n)
        want = records[:4 * 5] + records[
            at:at + 4 * t_stmap._MODEL_FIELDS * len(chunk)]
        assert args[:5] == (st_map.data_ptr(), 5, 3, 0, len(chunk))
        assert args[5] == struct.pack("<%di" % len(chunk), *[
            t_stmap._model_kind(m) for m in chunk])
        assert args[6] == t_stmap._records(len(chunk)).pack(*want)
        assert args[7] == params + 4 * t_stmap._PARAM_COUNT * 8 * n
        assert args[8] == 7
    # Each undistort chunk is one map launch: of the fused stack kernel
    # where it has two or more layers.
    for key, n in (("stmap.device_packs", len(chunks)),
                   ("stmap.launches", int(from_pixels)),
                   ("stmap_layer.launches", len(chunks) - from_pixels),
                   ("stmap.stack_launches",
                    sum(len(chunk) > 1 for chunk in chunks)),
                   ("host_reads", 0)):
        assert counters[key] == before[key] + n, key


# (direction, layers, from the pixel index) of a call, and what it adds
# to the counters: packs, stmap.launches, stmap_layer.launches,
# stmap.stack_launches.
COUNTED_CALLS = {
    "one_layer": ("undistort", 1, True, (1, 1, 0, 0)),
    "one_layer_on_a_map": ("distort", 1, False, (1, 0, 1, 0)),
    "distort_stack": ("distort", 3, True, (1, 1, 2, 0)),
    "distort_stack_on_a_map": ("distort", 3, False, (1, 0, 3, 0)),
    "undistort_stack_of_2": ("undistort", 2, True, (1, 1, 0, 1)),
    "undistort_stack_of_2_on_a_map": ("undistort", 2, False, (1, 0, 1, 1)),
    "undistort_stack_of_9": ("undistort", 9, True, (2, 1, 1, 1)),
    "undistort_stack_of_9_on_a_map": ("undistort", 9, False, (2, 0, 2, 1)),
}


@pytest.mark.parametrize("case", list(COUNTED_CALLS))
def test_launch_packed_counts_each_kind_of_call(monkeypatch, case):
    """What each kind of call adds to the counters, with stand-ins for
    the C entry points: a launch from the pixel index counts in
    stmap.launches, one from a map in stmap_layer.launches; an undistort
    pack of two or more layers is one launch (csrc/stmap.cu's fused
    stack kernel), counted also in stmap.stack_launches; the rest one
    launch a layer; no host read."""
    direction, count, from_pixels, want = COUNTED_CALLS[case]
    calls = _stand_in_launches(monkeypatch)
    names = list(MODELS)
    layers = [torch_model(names[i % 4])[0] for i in range(count)]
    _, fb = torch_model("classic")
    before = counters.copy()
    t_stmap._launch_packed(torch.zeros(3, 5, 4), layers, fb, direction,
                           from_pixels)
    keys = ("stmap.device_packs", "stmap.launches", "stmap_layer.launches",
            "stmap.stack_launches")
    assert tuple(counters[k] - before[k] for k in keys) == want
    assert counters["host_reads"] == before["host_reads"]
    assert [args[4] for _, _, args in calls] == [
        min(count - i, 8) for i in range(0, count, 8)]


@pytest.mark.parametrize("current", [0, 1])
def test_kernels_launch_makes_the_device_current_and_raises(monkeypatch,
                                                            current):
    """_kernels.launch, the ST map's and the warp's one launch helper,
    with a stand-in C entry point: called with the map's device current,
    entered only where another is current; a nonzero CUDA error code is
    a RuntimeError naming the entry point."""
    entered, calls = [], []

    def mmsolver_stmap(*args):
        calls.append(args)
        return args[0]

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", lambda device: (
        entered.append(device) or contextlib.nullcontext()))
    t_stmap._kernels.launch(CUDA1, mmsolver_stmap, 0, "x")
    assert calls == [(0, "x")]
    assert entered == ([] if current == CUDA1.index else [CUDA1])
    with pytest.raises(RuntimeError,
                       match="mmsolver_stmap failed: CUDA error 700"):
        t_stmap._kernels.launch(CUDA1, mmsolver_stmap, 700)
