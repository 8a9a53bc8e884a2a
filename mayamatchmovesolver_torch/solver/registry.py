"""Solver backend registry.

Counterpart of the reference's solver-type registry + mmSolverType
command (ref: getSolverTypes, adjust_base.cpp:80-127 — including the
MMSOLVER_DEFAULT_SOLVER env override — and MMSolverTypeCmd).
"""

import os

SOLVER_TYPE_LM_DENSE = 0       # dense LM, analytic Jacobian (lm.py)
SOLVER_TYPE_BA_SCHUR = 1       # structured Schur BA (ba.py)
SOLVER_TYPE_LM_SHARDED = 2     # frame-sharded LM (parallel/sharded.py)
SOLVER_TYPE_BA_SHARDED = 3     # distributed Schur-CG BA (ba_sharded.py)

SOLVER_TYPE_DEFAULT_VALUE = SOLVER_TYPE_LM_DENSE

_SOLVER_TYPES = {
    SOLVER_TYPE_LM_DENSE: "lm_jax",
    SOLVER_TYPE_BA_SCHUR: "ba_schur",
    SOLVER_TYPE_LM_SHARDED: "lm_sharded",
    SOLVER_TYPE_BA_SHARDED: "ba_schur_sharded",
}

# Environment override, like the reference's MMSOLVER_DEFAULT_SOLVER
# (adjust_base.cpp:102-127).
DEFAULT_SOLVER_ENV_VAR = "MMSOLVER_TPU_DEFAULT_SOLVER"


def get_solver_types():
    """[(index, name), ...] (ref: getSolverTypes)."""
    return sorted(_SOLVER_TYPES.items())


def get_solver_type_default():
    """(index, name) honoring the env override
    (ref: getSolverTypeDefault)."""
    name = os.environ.get(DEFAULT_SOLVER_ENV_VAR)
    if name:
        for index, reg_name in _SOLVER_TYPES.items():
            if reg_name == name:
                return index, reg_name
    return (
        SOLVER_TYPE_DEFAULT_VALUE,
        _SOLVER_TYPES[SOLVER_TYPE_DEFAULT_VALUE],
    )


def solver_name(index):
    return _SOLVER_TYPES[index]
