from mayamatchmovesolver_torch.ops import stmap  # noqa: F401  (module)
from mayamatchmovesolver_torch.ops import warp  # noqa: F401  (module)
