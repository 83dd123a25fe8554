"""BAL-shaped bundle-adjustment inputs, made on the device from a seed.

The observation graph is the photo-tourism (hub) structure of
``tpu3drecon_torch/dataset/synthetic.py`` ``make_hub_scene`` (frozen here
from commit a2ddbf06de4361660b45a75548f7333c894b1583), rewritten in plain
torch so that it runs on the card in a few large calls:

- ``n_locals`` local cameras, each the home of ``points_per_camera``
  points; the points of home ``h`` are seen by the ``track_span``
  consecutive local cameras starting at ``min(h, n_locals - track_span)``,
  so every point has exactly ``track_span`` local observations;
- ``n_hubs`` overview cameras, each seeing ``hub_obs`` distinct points
  drawn from the whole scene;
- camera labels shuffled by a random permutation (the packer has to find
  the locality and the hubs itself), observations sorted by point, as in
  the BAL files.

The graph comes from the configuration's own ``graph_seed``: every run
seed solves the same graph, so the work is the same.  The run's ``seed``
draws the geometry, the start and the noise.  Local cameras lie on a
serpentine over a square (consecutive labels are neighbours, and the
scene's extent stays near ten times the viewing depth, as in a city
reconstruction normalised the BAL way), looking down at points
``depth +- depth_halfwidth`` below them; hubs look at the square's centre
from ``hub_height`` times its side above it.  Observations are the exact
projections plus ``obs_noise_px`` pixels in a random direction; the start
is the truth moved as ``make_hub_scene``'s callers move it
(``perturb_scene``: points 3e-2, rotations 5e-2 rad, translations 5e-2,
focal lengths up to +10 px).

A configuration may state BAL's radial camera in a ``camera`` block
(``_radial``): per camera a truth (k1, k2) drawn uniformly from the
block's ranges and a start moved uniformly by up to its ``k1_noise`` and
``k2_noise``.  The projection then scales the normalized point m = (x/z,
y/z) by s = 1 + k1 |m|^2 + k2 |m|^4, as ``tpu3drecon_torch``'s
``geometry/projection.py`` defines it.  Those draws come from a generator
of their own (``_camera_seed``), so a configuration without the block makes
the same tensors as before the block existed; a configuration whose radial
map folds (d(r s)/dr <= 0) inside the image or at an observed radius is
refused.

Nothing here imports the program: the harness hands the same tensors to
the program and to the plain reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Inputs:
    """One problem: the start and the observations (flat BAL layout)."""

    rmats: torch.Tensor  # (C, 3, 3) world to camera
    tvecs: torch.Tensor  # (C, 3)
    fx_fy: torch.Tensor  # (C, 2)
    cx_cy_skew: torch.Tensor  # (C, 3)
    dist: torch.Tensor  # (C, 2) start k1, k2; zero without a camera block
    points3d: torch.Tensor  # (P, 3)
    cam_idx: torch.Tensor  # (N,) int32
    pt_idx: torch.Tensor  # (N,) int32
    uv: torch.Tensor  # (N, 2) observed pixels
    width: float  # image width, the residual scale

    @property
    def n_cameras(self) -> int:
        return self.rmats.shape[0]

    @property
    def n_points(self) -> int:
        return self.points3d.shape[0]

    @property
    def n_obs(self) -> int:
        return self.uv.shape[0]


def counts(gen: dict) -> dict:
    """Cameras, points and observations that ``gen`` (a configuration's
    ``generator`` block) makes."""
    n_hubs, n_locals = gen["n_hubs"], gen["n_locals"]
    n_points = n_locals * gen["points_per_camera"]
    return dict(
        n_cameras=n_hubs + n_locals,
        n_points=n_points,
        n_obs=n_points * gen["track_span"] + n_hubs * gen["hub_obs"],
    )


def _graph(gen: dict, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cam_idx, pt_idx, perm) before relabelling: local cameras are
    0..n_locals-1 and hubs follow; ``perm[orig]`` is each camera's label."""
    rng = torch.Generator(device=device).manual_seed(int(gen["graph_seed"]))
    n_hubs, n_locals = gen["n_hubs"], gen["n_locals"]
    ppc, span, hub_obs = gen["points_per_camera"], gen["track_span"], gen["hub_obs"]
    n_points = n_locals * ppc
    if span > n_locals or hub_obs > n_points:
        raise ValueError("track_span or hub_obs larger than the scene")

    pts = torch.arange(n_points, device=device)
    start = torch.clamp(pts // ppc, max=n_locals - span)
    local_cam = (start[:, None] + torch.arange(span, device=device)).reshape(-1)
    local_pt = pts.repeat_interleave(span)

    # hub_obs distinct points per hub: draw a few more than needed, drop
    # repeats within the row, keep the first hub_obs in draw order.
    extra = 64 + 4 * int(math.ceil(hub_obs * hub_obs / max(n_points, 1)))
    draws = torch.randint(0, n_points, (n_hubs, hub_obs + extra), generator=rng,
                          device=device)
    sorted_vals, order = torch.sort(draws, dim=1, stable=True)
    repeat_sorted = torch.zeros_like(draws, dtype=torch.bool)
    repeat_sorted[:, 1:] = sorted_vals[:, 1:] == sorted_vals[:, :-1]
    repeat = torch.zeros_like(repeat_sorted).scatter_(1, order, repeat_sorted)
    keep = (~repeat) & (torch.cumsum((~repeat).to(torch.int64), dim=1) <= hub_obs)
    if bool((keep.sum(dim=1) != hub_obs).any()):
        raise ValueError("too few distinct hub draws; raise the extra draws")
    hub_pt = draws[keep]  # row-major: hub by hub
    hub_cam = (n_locals + torch.arange(n_hubs, device=device)).repeat_interleave(hub_obs)

    cam = torch.cat([local_cam, hub_cam])
    pt = torch.cat([local_pt, hub_pt])
    perm = torch.randperm(n_hubs + n_locals, generator=rng, device=device)
    return cam, pt, perm


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    """(n, 3) rotation vectors -> (n, 3, 3) matrices."""
    theta = torch.linalg.norm(w, dim=1, keepdim=True).clamp(min=1e-30)
    k = w / theta
    kx = torch.zeros(w.shape[0], 3, 3, dtype=w.dtype, device=w.device)
    kx[:, 0, 1], kx[:, 0, 2] = -k[:, 2], k[:, 1]
    kx[:, 1, 0], kx[:, 1, 2] = k[:, 2], -k[:, 0]
    kx[:, 2, 0], kx[:, 2, 1] = -k[:, 1], k[:, 0]
    s = torch.sin(theta)[:, :, None]
    c = torch.cos(theta)[:, :, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + s * kx + (1.0 - c) * (kx @ kx)


def _look_at(centers: torch.Tensor, targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """World-to-camera (R, t) of cameras at ``centers`` looking at
    ``targets``, image rows along +y of the world."""
    fwd = targets - centers
    fwd = fwd / torch.linalg.norm(fwd, dim=1, keepdim=True)
    up = torch.zeros_like(fwd)
    up[:, 1] = 1.0
    right = torch.linalg.cross(fwd, up, dim=1)
    right = right / torch.linalg.norm(right, dim=1, keepdim=True)
    down = torch.linalg.cross(fwd, right, dim=1)
    rmats = torch.stack([right, down, fwd], dim=1)  # rows: camera axes
    tvecs = -(rmats @ centers[:, :, None])[:, :, 0]
    return rmats, tvecs


def _camera_seed(seed: int) -> int:
    """The seed of the camera block's own generator, derived from ``seed``."""
    return (int(seed) * 6364136223846793005 + 1442695040888963407) % 2**64


def _radial(camera: dict, seed: int, n_cams: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(truth, start) (C, 2) k1, k2 in float64 of the configuration's
    ``camera`` block (model "radial": ``k1`` and ``k2`` [low, high], the
    start's ``k1_noise`` and ``k2_noise``, their ``source``)."""
    if camera.get("model") != "radial":
        raise ValueError(f"camera model {camera.get('model')!r}: the generator takes 'radial'")
    rng = torch.Generator(device=device).manual_seed(_camera_seed(seed))
    u = torch.rand(n_cams, 4, generator=rng, dtype=torch.float64, device=device)
    lo = torch.tensor([camera["k1"][0], camera["k2"][0]], dtype=torch.float64, device=device)
    hi = torch.tensor([camera["k1"][1], camera["k2"][1]], dtype=torch.float64, device=device)
    noise = torch.tensor([camera["k1_noise"], camera["k2_noise"]], dtype=torch.float64,
                         device=device)
    truth = lo + (hi - lo) * u[:, :2]
    return truth, truth + noise * (2.0 * u[:, 2:] - 1.0)


def _refuse_folds(k: torch.Tensor, u_max: torch.Tensor) -> None:
    """Raise where r s(r) stops growing for some r^2 = u in [0, u_max]:
    d(r s)/dr = 1 + 3 k1 u + 5 k2 u^2, least at an end of the interval or
    at the parabola's vertex."""
    k1, k2 = k[:, 0], k[:, 1]
    vertex = -3.0 * k1 / torch.where(k2 == 0, torch.ones_like(k2), 10.0 * k2)
    for u in (u_max, torch.minimum(torch.clamp(vertex, min=0.0), u_max)):
        if bool((1.0 + 3.0 * k1 * u + 5.0 * k2 * u * u <= 0).any()):
            raise ValueError("the radial distortion folds inside the image")


def _unit_rows(n: int, d: int, rng, dtype, device) -> torch.Tensor:
    v = torch.randn(n, d, generator=rng, dtype=dtype, device=device)
    return v / torch.linalg.norm(v, dim=1, keepdim=True)


def make_inputs(config: dict, seed: int, device, dtype=torch.float32) -> Inputs:
    """The configuration's problem for ``seed`` on ``device``: truth and
    projections in float64, then the start and the observations in
    ``dtype``."""
    gen = config["generator"]
    geo = config["assumed"]
    f64 = torch.float64
    cam_orig, pt, perm = _graph(gen, device)
    n_hubs, n_locals = gen["n_hubs"], gen["n_locals"]
    n_cams = n_hubs + n_locals
    ppc, span = gen["points_per_camera"], gen["track_span"]
    n_points = n_locals * ppc
    rng = torch.Generator(device=device).manual_seed(int(seed))

    # Local cameras along a serpentine over a square, looking down +z.
    spacing = geo["camera_spacing"]
    cols = int(math.ceil(math.sqrt(n_locals)))
    k = torch.arange(n_locals, device=device)
    row, col = k // cols, k % cols
    col = torch.where(row % 2 == 1, cols - 1 - col, col)
    centers = torch.stack([col * spacing, row * spacing, torch.zeros_like(col)], 1).to(f64)
    centers = centers + 0.02 * torch.randn(n_locals, 3, generator=rng, dtype=f64,
                                           device=device)
    down = centers.clone()
    down[:, 2] += 1.0
    r_loc, _ = _look_at(centers, down)
    r_loc = _rodrigues(0.02 * torch.randn(n_locals, 3, generator=rng, dtype=f64,
                                          device=device)) @ r_loc
    t_loc = -(r_loc @ centers[:, :, None])[:, :, 0]

    # Points of each home camera: around the middle of the cameras that
    # see them, depth +- depth_halfwidth below.
    home = torch.arange(n_points, device=device) // ppc
    first = torch.clamp(home, max=n_locals - span)
    mid = 0.5 * (centers[first] + centers[first + span - 1])
    lateral = geo["point_lateral_sigma"] * torch.randn(n_points, 2, generator=rng,
                                                       dtype=f64, device=device)
    depth = geo["depth"] + geo["depth_halfwidth"] * (
        2.0 * torch.rand(n_points, generator=rng, dtype=f64, device=device) - 1.0)
    points = torch.stack([mid[:, 0] + lateral[:, 0], mid[:, 1] + lateral[:, 1],
                          depth], dim=1)

    # Hubs above the square, looking at its centre.
    side = spacing * cols
    centre = torch.tensor([0.5 * side, 0.5 * side, geo["depth"]], dtype=f64,
                          device=device)
    hub_xy = centre[:2] + side * geo["hub_spread"] * (
        torch.rand(n_hubs, 2, generator=rng, dtype=f64, device=device) - 0.5)
    hub_c = torch.cat([hub_xy, torch.full((n_hubs, 1), -geo["hub_height"] * side,
                                          dtype=f64, device=device)], dim=1)
    r_hub, t_hub = _look_at(hub_c, centre.expand(n_hubs, 3))

    rmats = torch.cat([r_loc, r_hub])
    tvecs = torch.cat([t_loc, t_hub])
    focal = geo["focal"] * (0.95 + 0.1 * torch.rand(n_cams, generator=rng, dtype=f64,
                                                   device=device))
    fx_fy = torch.stack([focal, focal * (0.99 + 0.02 * torch.rand(
        n_cams, generator=rng, dtype=f64, device=device))], dim=1)
    width, height = geo["image_size"]
    ccs = torch.zeros(n_cams, 3, dtype=f64, device=device)
    ccs[:, :2] = torch.tensor([width / 2, height / 2], dtype=f64, device=device) + 2.0 * (
        torch.randn(n_cams, 2, generator=rng, dtype=f64, device=device))

    # Exact projections plus noise.
    ci = cam_orig
    xc = (rmats[ci] @ points[pt][:, :, None])[:, :, 0] + tvecs[ci]
    if bool((xc[:, 2] <= geo["min_depth"]).any()):
        raise ValueError("an observed point lies behind its camera")
    mx, my = xc[:, 0] / xc[:, 2], xc[:, 1] / xc[:, 2]
    dist = torch.zeros(n_cams, 2, dtype=f64, device=device)
    if "camera" in config:
        truth, dist = _radial(config["camera"], seed, n_cams, device)
        # The largest normalized radius^2 of each camera: its image's
        # farthest corner or its farthest observation.
        corners = torch.stack([
            torch.stack([(x - ccs[:, 0]) / fx_fy[:, 0], (y - ccs[:, 1]) / fx_fy[:, 1]], 1)
            for x in (0.0, width) for y in (0.0, height)], 1)
        r2 = mx * mx + my * my
        u_max = torch.sum(corners * corners, dim=2).amax(dim=1).scatter_reduce(
            0, ci, r2, "amax")
        for k in (truth, dist):
            _refuse_folds(k, u_max)
        k = truth[ci]
        s = 1.0 + k[:, 0] * r2 + k[:, 1] * r2 * r2
        mx, my = s * mx, s * my
        del k, s, r2
    uv = torch.stack([fx_fy[ci, 0] * mx + ccs[ci, 2] * my + ccs[ci, 0],
                      fx_fy[ci, 1] * my + ccs[ci, 1]], dim=1)
    del xc, mx, my
    uv = uv + geo["obs_noise_px"] * _unit_rows(uv.shape[0], 2, rng, f64, device)

    # The start: the truth moved.
    points = points + geo["point_noise"] * _unit_rows(n_points, 3, rng, f64, device)
    dr = _rodrigues(geo["rotation_noise"] * _unit_rows(n_cams, 3, rng, f64, device))
    rmats = dr @ rmats
    tvecs = ((dr @ tvecs[:, :, None])[:, :, 0]
             + geo["translation_noise"] * _unit_rows(n_cams, 3, rng, f64, device))
    fx_fy = fx_fy + geo["focal_noise"] * torch.rand(n_cams, 2, generator=rng, dtype=f64,
                                                    device=device)

    # Labels: camera orig -> perm[orig]; observations sorted by point.
    def relabel(x):
        out = torch.empty_like(x)
        out[perm] = x
        return out

    cam = perm[cam_orig]
    order = torch.argsort(pt * n_cams + cam)
    return Inputs(
        rmats=relabel(rmats).to(dtype), tvecs=relabel(tvecs).to(dtype),
        fx_fy=relabel(fx_fy).to(dtype), cx_cy_skew=relabel(ccs).to(dtype),
        dist=relabel(dist).to(dtype),
        points3d=points.to(dtype),
        cam_idx=cam[order].to(torch.int32), pt_idx=pt[order].to(torch.int32),
        uv=uv[order].to(dtype), width=float(width),
    )
