"""Dataset layer: object model, COLMAP loading, synthetic scenes.

Counterpart of ``tpu3drecon/dataset/__init__.py`` with the same public
names; the packed containers of ``tpu3drecon_torch.problems`` carry the
data path.
"""

from tpu3drecon_torch.dataset.camera_pose import (
    CameraPose,
    CoordinateSystem,
    InvalidInputFormatErr,
    PoseFormat,
    TransformationDirection,
)
from tpu3drecon_torch.dataset.camera_set import CameraSet
from tpu3drecon_torch.dataset.loader import (
    export_in_colmap_format,
    get_intrinsics,
    load_colmap_cameras,
    load_colmap_dataset,
)
from tpu3drecon_torch.dataset.model import (
    Camera,
    CameraIntrinsics,
    DatasetEntry,
    ImageMetadata,
    Point2D,
    Point3D,
    params_to_intrinsics,
)
from tpu3drecon_torch.dataset.scene import Dataset
from tpu3drecon_torch.dataset.synthetic import (
    SyntheticScene,
    make_scene,
    perturb_scene,
    scene_to_ba_problem,
    scene_to_colmap_model,
    scene_to_pose_problem,
)
