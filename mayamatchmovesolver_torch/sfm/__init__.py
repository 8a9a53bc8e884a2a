from mayamatchmovesolver_torch.sfm.twoview import (  # noqa: F401
    RelativePose,
    decompose_essential,
    eight_point_essential,
    estimate_homography,
    homography_transfer_error,
    resection_pose,
    robust_relative_pose,
    sampson_error,
    triangulate_linear,
)
from mayamatchmovesolver_torch.sfm.vanishing import (  # noqa: F401
    CameraCalibration,
    SceneScaleMode,
    calibrate_one_vanishing_point,
    calibrate_two_vanishing_points,
)
