from mayamatchmovesolver_torch.core.constants import (  # noqa: F401
    FilmFit,
    RotateOrder,
)
from mayamatchmovesolver_torch.core import camera  # noqa: F401
from mayamatchmovesolver_torch.core import reprojection  # noqa: F401
from mayamatchmovesolver_torch.core import transform  # noqa: F401
