from mayamatchmovesolver_torch.parallel.sharded import (  # noqa: F401
    make_frame_mesh,
    shard_problem_arrays,
    sharded_levenberg_marquardt,
    sharded_normal_system,
)
