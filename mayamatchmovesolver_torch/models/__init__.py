from mayamatchmovesolver_torch.models.base import (  # noqa: F401
    FilmBack,
    dn_to_unit,
    film_back_radius_cm,
    unit_to_dn,
)
from mayamatchmovesolver_torch.models.tde import (  # noqa: F401
    Passthrough,
    TdeAnamorphicStdDeg4,
    TdeAnamorphicStdDeg4Rescaled,
    TdeClassic,
    TdeRadialStdDeg4,
    distort,
    distort_dn,
    undistort,
    undistort_dn,
)
