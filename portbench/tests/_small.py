"""A cell of ``BENCHMARK.json`` cut to a size the CPU tests can hold:
the same traffic, solver settings and limits, a small graph.  The radial
specs (``fixtures/``) are cells that ``BENCHMARK.json`` does not list:
Final-13682 with BAL's radial camera, under the wtt or flat traffic with
``optimize_dist``, judged by the limits of the listed cell of that engine."""

from __future__ import annotations

import copy
from pathlib import Path

from portbench import generator, run

SMALL_GRAPH = dict(n_locals=60, n_hubs=4, points_per_camera=60, hub_obs=300)
FIXTURES = Path(__file__).resolve().parent / "fixtures"
RADIAL_CONFIG = FIXTURES / "bal_final13682_radial.json"


def cut(spec: dict) -> dict:
    """``spec`` with its configuration's graph cut to ``SMALL_GRAPH``."""
    spec = copy.deepcopy(spec)
    spec["config"]["generator"].update(SMALL_GRAPH)
    spec["config"]["expected"] = generator.counts(spec["config"]["generator"])
    return spec


def small_spec(workload: str) -> dict:
    return cut(run.load_cell(workload))


def radial_spec(engine: str, small: bool = True) -> dict:
    """The radial configuration under ``<engine>_fixed3_dist`` (engine
    "wtt" or "flat"), judged by the limits of ``final13682.<engine>``."""
    spec = run.unlisted_cell(RADIAL_CONFIG, FIXTURES / f"{engine}_fixed3_dist.json",
                             limits=run.load_cell(f"final13682.{engine}")["limits"])
    return cut(spec) if small else spec
