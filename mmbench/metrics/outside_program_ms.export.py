"""Host milliseconds a profiled frame spends outside every program span:
from the request's start to the end of its last top-level span, less the
union of its top-level spans (the client's and the harness's own work
while issuing the frame, not its closing synchronise), the median over
the frames that hold a span.  The program's span log
(common/program_log.py), on the profiler's slowed host."""

from mmbench.common import program_log


def read(records):
    return program_log.median_ms(records, program_log.OUTSIDE)
