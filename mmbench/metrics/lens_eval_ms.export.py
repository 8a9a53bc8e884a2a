"""Host milliseconds of a frame's evaluation of a lens file,
io/lensfile.py::LensLayers.models_at, the device idle when it starts:
the median of the benchmark's spans."""

from mmbench.common import readers


def read(records):
    return readers.span_ms(records, "lens")
