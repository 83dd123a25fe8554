"""The configuration and traffic files, and the generator."""

import copy
import hashlib
import json
from pathlib import Path

import pytest
import torch

from portbench import generator, reference, run

BENCH = Path(__file__).resolve().parents[1]
FIXTURES = BENCH / "tests" / "fixtures"
# The committed files, then the fixtures of the radial spec.
CONFIGS = sorted((BENCH / "configs").glob("*.json")) + [FIXTURES / "bal_final13682_radial.json"]
TRAFFIC = sorted((BENCH / "traffic").glob("*.json")) + sorted(FIXTURES.glob("*_dist.json"))
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
    reference.check_solver(traffic["solver"])  # the reference implements every setting
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


FIELDS = ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist", "points3d", "cam_idx", "pt_idx",
          "uv")
# sha256 of the inputs that each committed configuration gave at
# ``_small.SMALL_GRAPH`` before the camera block existed (torch 2.13 on an
# x86-64 CPU): a configuration without the block makes them bit for bit.
DIGESTS = {
    ("bal_final13682", 2**31 + 977):
        "9690c12a02d1bdcef5658232e4271087b88fc5991319c044fc3586a6acac93ed",
    ("bal_final13682", 5): "cdeb4e14c0919fc4f64ad8089677d02d23116f2c80cd0a69bd6746357838d15b",
    ("bal_venice1778", 2**31 + 977):
        "375bb53276c941aa169c7e1f4424ba516aab5cdb3f718d9cb6828ac553575aa3",
    ("bal_venice1778", 5): "48bc373933af20d5b9e2edf161b5afcff46d2ea1a7502df2979b6bb68daf830a",
}


def inputs_digest(inp) -> str:
    h = hashlib.sha256()
    for name in FIELDS:
        t = getattr(inp, name).contiguous().cpu()
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.numpy().tobytes())
    h.update(repr(inp.width).encode())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(DIGESTS), ids=lambda v: str(v))
def test_committed_configs_make_the_inputs_they_made_before(name, seed):
    from _small import SMALL_GRAPH

    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert "camera" not in config
    config["generator"].update(SMALL_GRAPH)
    assert inputs_digest(generator.make_inputs(config, seed, "cpu")) == DIGESTS[name, seed]


def radial_config(**camera):
    config = json.loads((FIXTURES / "bal_final13682_radial.json").read_text())
    config["generator"] = dict(SMALL)
    config["camera"].update(camera)
    return config


def test_the_camera_block_draws_only_k1_k2_and_moves_only_the_observations():
    config = radial_config()
    pinhole = copy.deepcopy(config)
    del pinhole["camera"]
    a = generator.make_inputs(config, 2**31 + 11, "cpu")
    b = generator.make_inputs(config, 2**31 + 11, "cpu")
    plain = generator.make_inputs(pinhole, 2**31 + 11, "cpu")
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
        same = name not in ("dist", "uv")
        assert torch.equal(getattr(a, name), getattr(plain, name)) == same, name
    k1, k2 = a.dist[:, 0], a.dist[:, 1]
    cam = config["camera"]
    assert float(k1.min()) >= cam["k1"][0] - cam["k1_noise"]
    assert float(k1.max()) <= cam["k1"][1] + cam["k1_noise"]
    assert float(k2.min()) >= cam["k2"][0] - cam["k2_noise"]
    assert float(k2.max()) <= cam["k2"][1] + cam["k2_noise"]
    assert float(k1.std()) > 0 and float(k2.std()) > 0


def test_radial_observations_are_the_programs_projection_of_the_truth():
    from tpu3drecon_torch.geometry.projection import project_point

    # No noise anywhere: the start is the truth, and its projection the
    # observations.
    config = radial_config(k1_noise=0.0, k2_noise=0.0)
    for key in ("obs_noise_px", "point_noise", "rotation_noise", "translation_noise",
                "focal_noise"):
        config["assumed"][key] = 0.0
    inp = generator.make_inputs(config, 3, "cpu", torch.float64)
    c, p = inp.cam_idx.long(), inp.pt_idx.long()
    uv = project_point(inp.rmats[c], inp.tvecs[c], inp.fx_fy[c], inp.cx_cy_skew[c],
                       inp.dist[c], inp.points3d[p])
    assert float((uv - inp.uv).abs().max()) < 1e-9
    m = (inp.rmats[c] @ inp.points3d[p][:, :, None])[:, :2, 0]
    assert float(m.abs().max()) > 0 and bool((inp.dist != 0).any())


@pytest.mark.parametrize("camera", [dict(k1=[-1.5, -1.5]), dict(k2=[-1.0, -1.0])],
                         ids=["k1", "k2"])
def test_a_folding_distortion_is_refused(camera):
    with pytest.raises(ValueError, match="folds"):
        generator.make_inputs(radial_config(**camera), 5, "cpu")


def test_a_fold_between_the_centre_and_the_corner_is_refused():
    # d(r s)/dr = 1 - 3 u + 2 u^2 = (1 - u)(1 - 2 u): positive at u = 0.4
    # and at u = 1.2, negative around the vertex u = 0.75.
    k = torch.tensor([[-1.0, 0.4]], dtype=torch.float64)
    generator._refuse_folds(k, torch.tensor([0.4], dtype=torch.float64))
    with pytest.raises(ValueError, match="folds"):
        generator._refuse_folds(k, torch.tensor([1.2], dtype=torch.float64))


def test_an_unknown_camera_model_is_refused():
    with pytest.raises(ValueError, match="radial"):
        generator.make_inputs(radial_config(model="fisheye"), 5, "cpu")
