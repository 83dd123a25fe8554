"""Geometry core: rotation algebra, pose algebra, alignment, projection,
robust losses (the public names of ``tpu3drecon.geometry``)."""

from tpu3drecon_torch.geometry.losses import (
    RobustLoss,
    cauchy_loss,
    cauchy_rho,
    huber_rho,
    l2_loss,
    robust_weight,
    trivial_rho,
)
from tpu3drecon_torch.geometry.pose import (
    CONVERSION_MATRIX,
    camera_center,
    camera_center_batch,
    pose_apply,
    pose_compose,
    pose_convert_coordinate_system,
    pose_inverse,
    pose_to_matrix_3x4,
    pose_to_matrix_4x4,
    position_error,
    rotation_geodesic_angle,
    rotation_identity_error,
)
from tpu3drecon_torch.geometry.projection import (
    make_intrinsics_matrix,
    perspective_project,
    project_point,
    project_points,
    project_points_batched,
    reprojection_residuals,
    world_to_camera,
)
from tpu3drecon_torch.geometry.rotations import (
    matrix_to_quat,
    matrix_to_rodrigues,
    matrix_to_rodrigues_batch,
    quat_mul,
    quat_rotate,
    quat_to_matrix,
    quat_to_rodrigues,
    rodrigues_to_matrix,
    rodrigues_to_matrix_batch,
    rodrigues_to_quat,
    skew,
    wxyz_to_xyzw,
    xyzw_to_wxyz,
)
