"""Host milliseconds a profiled frame spends evaluating its lens file:
the summed durations of its top-level spans "lensfile.models_at"
(io/lensfile.py::LensLayers.models_at), the median over the frames that
hold one.  The program's span log (common/program_log.py), on the
profiler's slowed host."""

from mmbench.common import program_log


def read(records):
    return program_log.median_ms(records, "lensfile.models_at")
