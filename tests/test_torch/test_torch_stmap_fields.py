"""Where the ST-map wrapper packs a lens's kernel parameters, and what it
hands csrc/stmap.cu's pack kernel when it packs them on the device.

The choice (ops/stmap.py::_packs_on_device) is a pure function of the
fields' devices and the map's: the device where a field is a tensor on
the map's CUDA device and none on another CUDA device, the host
otherwise.  The pack kernel reads each model's fields in the order of
dataclasses.fields, padded to the same count, as csrc/stmap.cu's Field
records: a tensor on the map's device by its element's address
(checked here with CPU tensors and the CPU as the map's device, which
only the records can take), a Python number or a tensor elsewhere by
its value.  The kernel itself runs on the card:
tests/test_torch/test_torch_cuda.py holds its floats to the host's.
Imports nothing of jax.
"""

import dataclasses
import struct

import pytest
import torch

import mayamatchmovesolver_torch.models as t_models
import mayamatchmovesolver_torch.ops.stmap as t_stmap
from _torch_stmap_models import MODELS, torch_model

CPU = torch.device("cpu")
CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)

# (field devices, map device, packed on the device).
CHOICES = {
    "python_numbers": ([None] * 10, CUDA0, False),
    "cpu_tensors": ([CPU] * 10, CUDA0, False),
    "cpu_tensors_and_numbers": ([CPU, None] * 5, CUDA0, False),
    "on_the_map_device": ([CUDA0] * 10, CUDA0, True),
    "on_it_and_numbers": ([CUDA0] * 5 + [None] * 5, CUDA0, True),
    "on_it_and_cpu": ([CUDA0, CPU] * 5, CUDA0, True),
    "one_field_on_it": ([None] * 9 + [CUDA1], CUDA1, True),
    "on_another_card": ([CUDA1] * 10, CUDA0, False),
    "on_two_cards": ([CUDA0] * 5 + [CUDA1] * 5, CUDA0, False),
    "no_fields": ([], CUDA0, False),
}


@pytest.mark.parametrize("case", list(CHOICES))
def test_packs_on_device_from_where_the_fields_lie(case):
    devices, map_device, want = CHOICES[case]
    assert t_stmap._packs_on_device(devices, map_device) is want


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
