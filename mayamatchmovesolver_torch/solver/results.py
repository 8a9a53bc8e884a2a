"""Typed solver results + key=value serialization.

Mirrors the reference's result structs and string protocol
(ref: src/mmSolver/adjust/adjust_results.h:59-940 — SolverResult,
ErrorMetricsResult, TimerResult, SolveValuesResult — and the
'success=1'/'error_final=...' strings parsed by
python/mmSolver/_api/solveresult.py).
"""

import dataclasses
from typing import Dict, List, Optional

STOP_REASON_MESSAGES = {
    1: "relative reduction of function is small (ftol)",
    2: "relative change in parameters is small (xtol)",
    3: "gradient is small (gtol)",
    4: "maximum iterations reached",
    5: "solver step failed (singular normal equations)",
}


@dataclasses.dataclass
class FrameErrorList:
    """Per-frame average deviation (pixels), like the reference's
    per-frame error lists baked onto markers."""

    frames: List[int] = dataclasses.field(default_factory=list)
    errors: List[float] = dataclasses.field(default_factory=list)

    def as_dict(self):
        return dict(zip(self.frames, self.errors))


@dataclasses.dataclass
class SolverTimer:
    """Per-phase wall-clock seconds
    (ref: SolverTimer, adjust_data.h:58-72)."""

    solve_seconds: float = 0.0
    function_seconds: float = 0.0
    jacobian_seconds: float = 0.0
    compile_seconds: float = 0.0


@dataclasses.dataclass
class SolverResult:
    success: bool = False
    stop_reason: int = 0
    reason_string: str = ""
    iterations: int = 0
    function_evals: int = 0
    jacobian_evals: int = 0
    error_initial: float = 0.0
    error_final: float = 0.0
    error_avg: float = 0.0
    error_min: float = 0.0
    error_max: float = 0.0
    user_interrupted: bool = False
    # Which registered backend actually ran (ref: the solverType flag
    # echo in the reference's result strings, adjust_results.h).
    solver_type_name: str = ""
    timer: SolverTimer = dataclasses.field(default_factory=SolverTimer)
    per_frame_error: FrameErrorList = dataclasses.field(
        default_factory=FrameErrorList
    )
    # marker name -> per-frame deviation
    per_marker_error: Dict[str, FrameErrorList] = dataclasses.field(
        default_factory=dict
    )
    solved_parameters: Optional[object] = None
    # Per-frame solve mode extras (ref: the per-frame loop's per-frame
    # success/revert bookkeeping, adjust_base.cpp:1430-1484).
    per_frame_stop_reason: List[int] = dataclasses.field(
        default_factory=list
    )
    per_frame_reverted: List[bool] = dataclasses.field(
        default_factory=list
    )

    @property
    def evals_per_second(self):
        """The reference's throughput metric-of-record
        (ref: adjust_base.cpp:434-452)."""
        if self.timer.solve_seconds <= 0:
            return 0.0
        return self.function_evals / self.timer.solve_seconds

    def as_key_value_strings(self):
        """Serialize like the reference command result
        (ref: adjust_results.h:123-143)."""
        out = [
            "success=%d" % int(self.success),
            "reason_num=%d" % self.stop_reason,
            "reason_string=%s" % (
                self.reason_string
                or STOP_REASON_MESSAGES.get(self.stop_reason, "")
            ),
            "error_initial=%g" % self.error_initial,
            "error_final=%g" % self.error_final,
            "error_final_average=%g" % self.error_avg,
            "error_final_maximum=%g" % self.error_max,
            "error_final_minimum=%g" % self.error_min,
            "iteration_num=%d" % self.iterations,
            "iteration_function_num=%d" % self.function_evals,
            "iteration_jacobian_num=%d" % self.jacobian_evals,
            "timer_solve=%g" % self.timer.solve_seconds,
            "timer_function=%g" % self.timer.function_seconds,
            "timer_jacobian=%g" % self.timer.jacobian_seconds,
            "user_interrupted=%d" % int(self.user_interrupted),
        ]
        if self.solver_type_name:
            out.append("solver_type=%s" % self.solver_type_name)
        for frame, err in zip(
            self.per_frame_error.frames, self.per_frame_error.errors
        ):
            out.append("error_per_frame=%s,%g" % (frame, err))
        return out


def parse_key_value_strings(lines):
    """Parse the strings back into a dict (the Python-API side;
    ref: python/mmSolver/_api/solveresult.py)."""
    result = {}
    per_frame = {}
    for line in lines:
        if "=" not in line:
            continue
        key, value = line.split("=", 1)
        if key == "error_per_frame":
            frame, err = value.split(",")
            per_frame[int(float(frame))] = float(err)
        else:
            result[key] = value
    if per_frame:
        result["per_frame_error"] = per_frame
    return result
