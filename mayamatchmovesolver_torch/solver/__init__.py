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
    SolverOptions,
    build_problem,
    count_errors_and_parameters,
    solve,
)
from mayamatchmovesolver_torch.solver import registry  # noqa: F401
