"""LM / implicit-Schur bundle-adjustment solvers (the public names of
``tpu3drecon.solvers``): the dense LM, the flat, grid and fused-kernel grid
engines; the track-table engines live in ``solvers/ba_wtt.py`` and
``solvers/ba_tt.py``."""

from tpu3drecon_torch.solvers.ba_grid import ba_solve_grid, make_grid_ba_solver
from tpu3drecon_torch.solvers.bundle_adjust import (
    BAConfig,
    BAState,
    ba_solve,
    make_ba_solver,
    reprojection_rmse,
)
from tpu3drecon_torch.solvers.ba_pallas import ba_solve_pallas, make_pallas_ba_solver
from tpu3drecon_torch.solvers.intrinsics_refine import refine_intrinsics
from tpu3drecon_torch.solvers.lm_core import LMConfig, LMState, lm_solve, lm_solve_batched
from tpu3drecon_torch.solvers.pose_refine import (
    PoseRefiner,
    pose_params_pack,
    pose_params_unpack,
    refine_poses,
)
