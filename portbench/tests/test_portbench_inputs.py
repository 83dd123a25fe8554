"""The configuration and traffic files, and the generator."""

import json
from pathlib import Path

import pytest
import torch

from portbench import generator, run

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = sorted((BENCH / "configs").glob("*.json"))
TRAFFIC = sorted((BENCH / "traffic").glob("*.json"))
SMALL = dict(graph_seed=7, n_locals=40, n_hubs=3, points_per_camera=25, track_span=5,
             hub_obs=120)


def small_config(**graph):
    with open(BENCH / "configs" / "bal_venice1778.json") as fh:
        config = json.load(fh)
    config["generator"] = dict(SMALL, **graph)
    return config


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_counts_match_the_file(path):
    config = json.loads(path.read_text())
    assert generator.counts(config["generator"]) == config["expected"]
    for key in ("n_cameras", "n_points", "n_obs"):
        published, made = config["published"][key], config["expected"][key]
        assert abs(made - published) <= 1e-3 * published, key
    assert config["expected"]["n_cameras"] == config["published"]["n_cameras"]


@pytest.mark.parametrize("path", TRAFFIC, ids=lambda p: p.stem)
def test_traffic_names_solver_fields_and_program_entries(path):
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    traffic = json.loads(path.read_text())
    BAConfig(**traffic["solver"])
    for key in ("pack", "solve"):
        if traffic[key] is not None:
            assert callable(run._entry(traffic[key]))


def test_entries_outside_the_program_are_refused():
    with pytest.raises(ValueError):
        run._entry("tpu3drecon.solvers.bundle_adjust.ba_solve")


def test_small_graph_has_the_stated_counts_and_structure():
    config = small_config()
    g = config["generator"]
    inp = generator.make_inputs(config, 2**31 + 5, "cpu")
    assert dict(n_cameras=inp.n_cameras, n_points=inp.n_points,
                n_obs=inp.n_obs) == generator.counts(g)
    cam, pt = inp.cam_idx.long(), inp.pt_idx.long()
    # Sorted by point, then camera; no (camera, point) pair twice.
    key = pt * inp.n_cameras + cam
    assert bool((key[1:] > key[:-1]).all())
    per_point = torch.bincount(pt, minlength=inp.n_points)
    assert int(per_point.min()) >= g["track_span"]
    assert int(per_point.sum()) == inp.n_obs
    per_cam = torch.bincount(cam, minlength=inp.n_cameras)
    assert sorted(per_cam.tolist()).count(g["hub_obs"]) >= g["n_hubs"]
    # Every observation lies in front of its camera at the start.
    xc = (inp.rmats[cam] @ inp.points3d[pt][:, :, None])[:, :, 0] + inp.tvecs[cam]
    assert float(xc[:, 2].min()) > config["assumed"]["min_depth"]


def test_generator_is_deterministic_per_seed_and_keeps_the_graph():
    config = small_config()
    a = generator.make_inputs(config, 11, "cpu")
    b = generator.make_inputs(config, 11, "cpu")
    c = generator.make_inputs(config, 12, "cpu")
    for name in ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "points3d", "cam_idx", "pt_idx",
                 "uv"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.cam_idx, c.cam_idx) and torch.equal(a.pt_idx, c.pt_idx)
    assert not torch.equal(a.uv, c.uv)
    assert not torch.equal(a.points3d, c.points3d)


def test_hub_draws_are_distinct_per_hub():
    config = small_config(hub_obs=900, points_per_camera=25, n_locals=40)
    inp = generator.make_inputs(config, 3, "cpu")
    cam, pt = inp.cam_idx.long(), inp.pt_idx.long()
    pairs = torch.unique(cam * inp.n_points + pt)
    assert pairs.numel() == inp.n_obs


def test_oversized_graph_is_refused():
    with pytest.raises(ValueError):
        generator.make_inputs(small_config(track_span=41), 1, "cpu")
