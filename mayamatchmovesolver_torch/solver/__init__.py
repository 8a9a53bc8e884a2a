from mayamatchmovesolver_torch.solver.loss import RobustLossType  # noqa: F401
from mayamatchmovesolver_torch.solver.lm import (  # noqa: F401
    LMConfig,
    LMResult,
    levenberg_marquardt,
)
from mayamatchmovesolver_torch.solver.problem import (  # noqa: F401
    SolveProblem,
    initial_parameters,
    insert_parameters,
    measure_residuals,
    residual_fn,
)
from mayamatchmovesolver_torch.solver.results import (  # noqa: F401
    SolverResult,
    parse_key_value_strings,
)
from mayamatchmovesolver_torch.solver.solve import (  # noqa: F401
    FrameSolveMode,
    SceneGraphMode,
    SolverOptions,
    build_problem,
    build_stiffness,
    count_errors_and_parameters,
    merge_stiffness,
    solve,
    solve_per_frame,
)
from mayamatchmovesolver_torch.solver import ba  # noqa: F401  (module)
from mayamatchmovesolver_torch.solver import ba_bridge  # noqa: F401
from mayamatchmovesolver_torch.solver import registry  # noqa: F401
from mayamatchmovesolver_torch.solver.ba import (  # noqa: F401
    BAProblem,
    BAResult,
    make_ba_problem,
    solve_ba,
)
