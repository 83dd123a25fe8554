"""Packed problem containers and packers (flat, bucketed grid, dense and
windowed track table, from COLMAP models and Dataset objects), camera
reordering, and conversion from the JAX package."""

from tpu3drecon_torch.problems.from_dataset import (
    ba_problem_from_dataset,
    pose_problem_from_dataset,
)
from tpu3drecon_torch.problems.grid import BAGridProblem, grid_from_flat
from tpu3drecon_torch.problems.packing import (
    BAProblem,
    CameraParams,
    PoseProblem,
    ProblemMeta,
    ba_problem_from_colmap,
    bucket_size,
    pose_problem_from_colmap,
)
