"""Host milliseconds a profiled frame spends in the warp: the summed
durations of its top-level spans "warp.call" (ops/warp.py::warp_image),
the median over the frames that hold one.  The program's span log
(common/program_log.py), on the profiler's slowed host."""

from mmbench.common import program_log


def read(records):
    return program_log.median_ms(records, "warp.call")
