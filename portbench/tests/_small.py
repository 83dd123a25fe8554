"""A cell of ``BENCHMARK.json`` cut to a size the CPU tests can hold:
the same traffic, solver settings and limits, a small graph."""

from __future__ import annotations

import copy

from portbench import generator, run

SMALL_GRAPH = dict(n_locals=60, n_hubs=4, points_per_camera=60, hub_obs=300)


def small_spec(workload: str) -> dict:
    spec = copy.deepcopy(run.load_cell(workload))
    spec["config"]["generator"].update(SMALL_GRAPH)
    spec["config"]["expected"] = generator.counts(spec["config"]["generator"])
    return spec
