"""Repo-level paths and the typed run configuration tree.

The port's own copy of ``tpu3drecon/config.py``: dataset and result paths
(the same environment variables, ``TPU3DRECON_DATASETS`` and
``TPU3DRECON_RESULTS``) and the ``RunConfig`` tree that drivers thread
through: solver settings, the mesh shape and benchmark scale caps.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

REPO_PATH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS_PATH = os.environ.get(
    "TPU3DRECON_DATASETS", os.path.join(REPO_PATH, "datasets")
)
BENCHMARK_RESULTS_PATH = os.environ.get(
    "TPU3DRECON_RESULTS", os.path.join(REPO_PATH, "benchmark_results")
)
BENCHMARK_SINGLE_POSE_RESULTS_PATH = os.path.join(
    BENCHMARK_RESULTS_PATH, "single_pose"
)
BENCHMARK_BUNDLE_ADJUSTMENT_RESULTS_PATH = os.path.join(
    BENCHMARK_RESULTS_PATH, "bundle_adjustment"
)
EVALUATION_PATH = os.path.join(REPO_PATH, "evaluation")


@dataclass(frozen=True)
class MeshConfig:
    """Mesh shape: the number of ranks (None: the whole process group) over
    the observation axis."""

    n_devices: Optional[int] = None
    axis_name: str = "obs"


@dataclass(frozen=True)
class SolverSettings:
    """User-facing solver knobs (lowered into LMConfig/BAConfig)."""

    maxiter: int = 100
    tol: float = 1e-7
    cg_maxiter: int = 100
    cg_rtol: float = 1e-5
    loss: str = "cauchy"
    dtype: str = "float32"


@dataclass(frozen=True)
class BenchmarkScale:
    """Problem-size caps (None: uncapped)."""

    camera_limit: Optional[int] = None
    points_limit: Optional[int] = None


@dataclass(frozen=True)
class RunConfig:
    solver: SolverSettings = field(default_factory=SolverSettings)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    scale: BenchmarkScale = field(default_factory=BenchmarkScale)
    results_root: str = BENCHMARK_RESULTS_PATH
