"""Device milliseconds of the kernels of one ops/warp.py::warp_image
call: the median over the profiled calls."""

from mmbench.common import readers


def read(records):
    return readers.range_device_ms(records, "warp")
