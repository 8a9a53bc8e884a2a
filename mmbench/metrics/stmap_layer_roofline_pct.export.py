"""The ST-map layer kernel's share of its roofline: the frozen bound
(common/peaks.py, from a map: a 16-byte texel read and one written a
pixel) of every launch of stmap_kernel<CORE, DISTORT, true>, the layer
variant that maps a map in place, over those launches' device time in
the profiler, in percent.  None where no layer launch ran."""

import dataclasses

from mmbench.common import readers


def _from_map(name):
    m = readers._STMAP_KERNEL.search(name)
    return m is not None and m.group(3) in ("true", "1")


def read(records):
    if records.trace is None:
        return None
    layer = [(n, s) for n, s in records.trace.kernels if _from_map(n)]
    trace = dataclasses.replace(records.trace, kernels=layer)
    width, height = records.config["plate"]
    return readers.stmap_roofline_pct(
        dataclasses.replace(records, trace=trace), width, height)
