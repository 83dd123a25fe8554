"""The plain reference: Levenberg-Marquardt bundle adjustment with the
implicit Schur complement, in plain PyTorch.

It follows the algorithm that the configuration's solver settings name
(the JAX package's ``ba_solve``, which every engine of the port
reproduces): whitened reprojection residuals of BAL's cameras (a pinhole
with the radial factor s = 1 + k1 |m|^2 + k2 |m|^4 on the normalized point
m, as ``generator.py`` makes them) with a left-multiplicative SE(3) step,
two focal lengths and, under ``optimize_dist``, an additive step of k1 and
k2 (camera columns so3 | t | fx fy | k1 k2), Marquardt damping
``lam * max(diag, 1e-8)`` with Nielsen's control (``init_lambda``, nu = 2,
the gain-ratio update), the reduced camera system solved by ``cg_maxiter``
preconditioned CG iterations (block Schur-Jacobi: a Cholesky factor of
each camera's diagonal block of S, or of its damped U where that fails),
points back-substituted, a step kept where the cost falls.  Its Jacobian
is derived here by the chain rule (``_linearize``; the tests hold it
against finite differences of ``residual_after``); every sum is an
``index_add_`` over the flat observations, in blocks of ``CHUNK`` rows.
At k1 = k2 = 0 the radial factor is exactly 1 and each expression reduces
to the pinhole's own operations, so a pinhole's numbers are the
pinhole's bit for bit (up to the sign of a zero).

It implements the solver settings in ``SETTINGS`` and the values of
``FIXED``, ignores the program's own choice of route (``PROGRAM_ONLY``),
and refuses every other setting with a ``ValueError`` that names it: a
traffic that asked for anything else would be judged against a solve that
did not do it.

``precision`` is "float64" (the reference) or "tf32", the control: float32
storage with every operand of a product that a matrix unit would take
(the projection's R and X, the Jacobian entries in the normal equations
and the CG products) rounded to TF32's 10-bit mantissa, as
``allow_tf32`` would let a matrix multiplication do.

Imports torch only: never the program, and nothing the program made.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

CHUNK = 1 << 22  # observations per block

# Settings the reference reads: the required ones, then those with a default.
REQUIRED = ("maxiter", "gtol", "ftol", "cg_maxiter", "cg_rtol")
SETTINGS = REQUIRED + ("init_lambda", "min_lambda", "max_lambda", "optimize_dist")
# Settings the reference implements at one value only.
FIXED = dict(loss="trivial", precond="schur_jacobi", optimize_focal=True,
             optimize_points=True, optimize_pp=False, matvec_bf16=False,
             packed_gathers=False)
# The program's choice of kernels: the same mathematics by another route.
PROGRAM_ONLY = ("matvec_kernel", "linearize_kernel")


def check_solver(solver: dict) -> None:
    """Raise ``ValueError`` naming each setting of ``solver`` that the
    reference does not implement."""
    missing = [k for k in REQUIRED if k not in solver]
    unknown = sorted(set(solver) - set(SETTINGS) - set(FIXED) - set(PROGRAM_ONLY))
    other = [k for k, v in FIXED.items() if k in solver and solver[k] != v]
    if missing or unknown or other:
        raise ValueError(
            "the reference does not implement "
            + "; ".join([f"a solve without {k!r}" for k in missing]
                        + [f"the setting {k!r}" for k in unknown]
                        + [f"{k}={solver[k]!r} (only {FIXED[k]!r})" for k in other]))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits,
    ties to even)."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    b = torch.where(b >= 1 << 31, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


@dataclass
class Params:
    rmats: torch.Tensor  # (C, 3, 3)
    tvecs: torch.Tensor  # (C, 3)
    fx_fy: torch.Tensor  # (C, 2)
    points3d: torch.Tensor  # (P, 3)
    dist: torch.Tensor  # (C, 2) k1, k2

    def to(self, dtype) -> "Params":
        return Params(*(getattr(self, f.name).to(dtype) for f in fields(self)))


@dataclass
class Result:
    params: Params
    loss: float
    accepted: int
    iterations: int
    fallbacks: int  # camera blocks preconditioned by chol(U), over the iterations


def _mv(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched m @ x: (n, a, b), (n, b) -> (n, a), as elementwise products
    and a sum (a batched matrix call on tiny blocks is far slower)."""
    return torch.sum(m * x[:, None, :], dim=2)


def _tmv(m: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched m^T @ y: (n, a, b), (n, a) -> (n, b)."""
    return torch.sum(m * y[:, :, None], dim=1)


def _gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a^T @ b of two-row blocks: (n, 2, k), (n, 2, l) -> (n, k, l)."""
    return a[:, 0, :, None] * b[:, 0, None, :] + a[:, 1, :, None] * b[:, 1, None, :]


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Inverses of (n, 3, 3) blocks by their cofactors."""
    c = torch.stack([
        torch.linalg.cross(m[:, :, 1], m[:, :, 2], dim=1),
        torch.linalg.cross(m[:, :, 2], m[:, :, 0], dim=1),
        torch.linalg.cross(m[:, :, 0], m[:, :, 1], dim=1),
    ], dim=1)  # rows: cofactor rows of the transpose
    det = torch.sum(m[:, :, 0] * c[:, 0], dim=1)
    return c / det[:, None, None]


def _skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[:, 0])
    return torch.stack([
        torch.stack([z, -w[:, 2], w[:, 1]], 1),
        torch.stack([w[:, 2], z, -w[:, 0]], 1),
        torch.stack([-w[:, 1], w[:, 0], z], 1),
    ], 1)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.norm(w, dim=1)[:, None, None]
    k = _skew(w) / torch.clamp(theta, min=1e-30)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(theta) * k + (1.0 - torch.cos(theta)) * (k @ k)


class Reference:
    """The inputs of one problem (``generator.Inputs``) in the reference's
    precision, and their solve with the traffic's ``solver`` settings."""

    def __init__(self, inputs, solver: dict, precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}")
        check_solver(solver)
        self.solver = solver
        self.optimize_dist = bool(solver.get("optimize_dist", False))
        self.width = 10 if self.optimize_dist else 8  # camera columns
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        dt = self.dtype
        self.cam = inputs.cam_idx.long()
        self.pt = inputs.pt_idx.long()
        self.uv = inputs.uv.to(dt)
        self.ccs = inputs.cx_cy_skew.to(dt)
        self.inv_w = 1.0 / inputs.width
        self.n_cams = inputs.n_cameras
        self.n_pts = inputs.n_points
        self.start = Params(inputs.rmats, inputs.tvecs, inputs.fx_fy, inputs.points3d,
                            inputs.dist).to(dt)

    def _rt(self, x: torch.Tensor) -> torch.Tensor:
        return round_tf32(x) if self.tf32 else x

    def _chunks(self):
        n = self.uv.shape[0]
        for lo in range(0, n, CHUNK):
            yield slice(lo, min(lo + CHUNK, n))

    def _gather(self, p: Params, sl: slice):
        """Per observation of ``sl``: R, the point in the camera frame
        (R X + t), the focal lengths, cx cy skew, the observation and k1,
        k2."""
        ci = self.cam[sl]
        rm = self._rt(p.rmats[ci])
        xc = _mv(rm, self._rt(p.points3d[self.pt[sl]])) + p.tvecs[ci]
        return rm, xc, p.fx_fy[ci], self.ccs[ci], self.uv[sl], p.dist[ci]

    def _residual(self, xc, f, ccs, uv, k):
        """Whitened residuals (n, 2) of camera-frame points ``xc``, with
        the radial factor of ``k`` (k1, k2 per row)."""
        mx, my = xc[:, 0] / xc[:, 2], xc[:, 1] / xc[:, 2]
        r2 = mx * mx + my * my
        s = 1.0 + k[:, 0] * r2 + k[:, 1] * r2 * r2
        mx, my = s * mx, s * my
        u = f[:, 0] * mx + ccs[:, 2] * my + ccs[:, 0]
        v = f[:, 1] * my + ccs[:, 1]
        return (torch.stack([u, v], 1) - uv) * self.inv_w

    def residual_after(self, p: Params, sl: slice, drot, dt, df, dx, dk=None):
        """Residuals of ``sl`` after a step of each observation's camera
        (rotation vector, translation, focal lengths, k1 and k2) and
        point, by the retraction ``_step`` applies; the Jacobian is its
        derivative at 0."""
        ci = self.cam[sl]
        rm = self._rt(p.rmats[ci])
        xc = _mv(rm, self._rt(p.points3d[self.pt[sl]]) + dx) + p.tvecs[ci]
        xc = _mv(_exp_so3(drot), xc) + dt
        k = p.dist[ci] if dk is None else p.dist[ci] + dk
        return self._residual(xc, p.fx_fy[ci] + df, self.ccs[ci], self.uv[sl], k)

    def cost(self, p: Params) -> float:
        """0.5 * sum of squared whitened residuals, in float64."""
        total = 0.0
        for sl in self._chunks():
            _, xc, f, ccs, uv, k = self._gather(p, sl)
            r = self._residual(xc, f, ccs, uv, k).double()
            total += float(0.5 * torch.sum(r * r))
        return total

    def _linearize(self, p: Params):
        """Residuals (N, 2) and Jacobians (N, 2, width), (N, 2, 3), by the
        chain rule through the camera-frame point P = R X + t: a step
        moves P by -[P]x drot + dt + R dx, and the pixel by A dP with
        A = K2 D dm/dP, K2 = [[fx, sk], [0, fy]], m = (x/z, y/z) and D =
        d(s m)/dm = s I + 2 (k1 + 2 k2 |m|^2) m m^T; the focal and k1, k2
        columns are s m and K2 m |m|^2, K2 m |m|^4.  A's columns are
        written so that at k1 = k2 = 0 they are the pinhole's [[fx/z,
        sk/z, -(fx x + sk y)/z^2], [0, fy/z, -fy y/z^2]] operation for
        operation."""
        n = self.uv.shape[0]
        dev = self.uv.device
        r = torch.empty(n, 2, dtype=self.dtype, device=dev)
        jc = torch.empty(n, 2, self.width, dtype=self.dtype, device=dev)
        jp = torch.empty(n, 2, 3, dtype=self.dtype, device=dev)
        for sl in self._chunks():
            rm, xc, f, ccs, uv, k = self._gather(p, sl)
            r[sl] = self._residual(xc, f, ccs, uv, k)
            x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
            iz = 1.0 / z
            zero = torch.zeros_like(z)
            fx, fy, sk = f[:, 0], f[:, 1], ccs[:, 2]
            mx, my = x * iz, y * iz
            r2 = mx * mx + my * my
            s = 1.0 + k[:, 0] * r2 + k[:, 1] * r2 * r2
            ds = 2.0 * (k[:, 0] + 2.0 * k[:, 1] * r2)
            d00, d01, d11 = s + ds * mx * mx, ds * mx * my, s + ds * my * my
            kx = torch.stack([fx * d00 + sk * d01, fy * d01], 1)  # K2 D's columns
            ky = torch.stack([fx * d01 + sk * d11, fy * d11], 1)
            a = torch.stack([kx * iz[:, None], ky * iz[:, None],
                             -(kx * x[:, None] + ky * y[:, None]) * iz[:, None] * iz[:, None]],
                            2) * self.inv_w  # (n, 2, 3)
            jf = torch.stack([torch.stack([s * mx, zero], 1),
                              torch.stack([zero, s * my], 1)], 1) * self.inv_w
            cols = [a, jf]
            if self.optimize_dist:
                km = torch.stack([fx * mx + sk * my, fy * my], 1) * self.inv_w  # K2 m
                cols.append(torch.stack([km * r2[:, None], km * (r2 * r2)[:, None]], 2))
            skew = _skew(xc)
            jrot = -torch.sum(a[:, :, :, None] * skew[:, None, :, :], dim=2)
            jc[sl] = torch.cat([jrot] + cols, dim=2)
            jp[sl] = torch.sum(a[:, :, :, None] * rm[:, None, :, :], dim=2)
        return r, jc, jp

    def _normal(self, r, jc, jp, lam):
        """Damped U, V^-1, gradients, damping and the preconditioner's
        inverse blocks."""
        rt = self._rt
        w = self.width
        u = jc.new_zeros(self.n_cams, w, w)
        v = jc.new_zeros(self.n_pts, 3, 3)
        g_c = jc.new_zeros(self.n_cams, w)
        g_p = jc.new_zeros(self.n_pts, 3)
        for sl in self._chunks():
            a, b, rr = rt(jc[sl]), rt(jp[sl]), rt(r[sl])
            u.index_add_(0, self.cam[sl], _gram(a, a))
            v.index_add_(0, self.pt[sl], _gram(b, b))
            g_c.index_add_(0, self.cam[sl], _tmv(a, rr))
            g_p.index_add_(0, self.pt[sl], _tmv(b, rr))
        damp_c = lam * torch.clamp(torch.diagonal(u, dim1=1, dim2=2), min=1e-8)
        damp_p = lam * torch.clamp(torch.diagonal(v, dim1=1, dim2=2), min=1e-8)
        u_d = u + torch.diag_embed(damp_c)
        v_inv = _inv3(v + torch.diag_embed(damp_p))
        coupling = jc.new_zeros(self.n_cams, w, w)
        for sl in self._chunks():
            wo = rt(_gram(rt(jc[sl]), rt(jp[sl])))  # (n, width, 3)
            vi = rt(v_inv[self.pt[sl]])
            wv = rt(sum(wo[:, :, k, None] * vi[:, None, k, :] for k in range(3)))
            coupling.index_add_(0, self.cam[sl],
                                sum(wv[:, :, k, None] * wo[:, None, :, k] for k in range(3)))
        chol, info = torch.linalg.cholesky_ex(u_d - coupling)
        bad = (info != 0) | torch.isnan(chol).flatten(1).any(1)
        n_bad = int(bad.sum())
        if n_bad:
            self.fallbacks += n_bad
            chol_u, _ = torch.linalg.cholesky_ex(u_d)
            chol = torch.where(bad[:, None, None], chol_u, chol)
        return u_d, v_inv, g_c, g_p, damp_c, damp_p, torch.cholesky_inverse(chol)

    def _wt(self, jc, jp, x_cam):
        """(W^T x) per point: sum over the point's observations of
        Jp^T Jc x_cam."""
        rt = self._rt
        out = jc.new_zeros(self.n_pts, 3)
        for sl in self._chunks():
            y = _mv(rt(jc[sl]), rt(x_cam[self.cam[sl]]))  # (n, 2)
            out.index_add_(0, self.pt[sl], _tmv(rt(jp[sl]), rt(y)))
        return out

    def _w(self, jc, jp, y_pt):
        """(W y) per camera: sum over the camera's observations of
        Jc^T Jp y_pt."""
        rt = self._rt
        out = jc.new_zeros(self.n_cams, self.width)
        for sl in self._chunks():
            z = _mv(rt(jp[sl]), rt(y_pt[self.pt[sl]]))  # (n, 2)
            out.index_add_(0, self.cam[sl], _tmv(rt(jc[sl]), rt(z)))
        return out

    def _step(self, p: Params, lam, cg_maxiter: int, cg_rtol: float):
        r, jc, jp = self._linearize(p)
        u_d, v_inv, g_c, g_p, damp_c, damp_p, m_inv = self._normal(r, jc, jp, lam)

        def v_times(y):
            return _mv(v_inv, y)

        def s_times(x):
            return _mv(u_d, x) - self._w(jc, jp, v_times(self._wt(jc, jp, x)))

        def precond(x):
            return _mv(m_inv, x)

        def guard(d):
            return torch.where(torch.abs(d) < 1e-32, torch.ones_like(d), d)

        b = -g_c + self._w(jc, jp, v_times(g_p))
        x = torch.zeros_like(b)
        x_good, res = x, b
        z = precond(b)
        p_dir, rz = z, torch.sum(b * z)
        tol2 = cg_rtol ** 2 * torch.clamp(torch.sum(b * b), min=1e-32)
        for _ in range(cg_maxiter):
            if not bool(torch.sum(res * res) > tol2):
                break
            sp = s_times(p_dir)
            alpha = rz / guard(torch.sum(p_dir * sp))
            x = x + alpha * p_dir
            res = res - alpha * sp
            z = precond(res)
            rz_new = torch.sum(res * z)
            beta = rz_new / guard(rz)
            if bool(torch.isfinite(torch.sum(x * x) + torch.sum(res * res))):
                x_good = x
            p_dir = z + beta * p_dir
            rz = rz_new
        dc = x_good
        dp = v_times(-g_p - self._wt(jc, jp, dc))
        pred = 0.5 * (torch.sum(dc * damp_c * dc) + torch.sum(dp * damp_p * dp)
                      - torch.sum(dc * g_c) - torch.sum(dp * g_p))
        dr = _exp_so3(dc[:, :3])
        cand = Params(dr @ p.rmats, _mv(dr, p.tvecs) + dc[:, 3:6],
                      p.fx_fy + dc[:, 6:8], p.points3d + dp,
                      p.dist + dc[:, 8:10] if self.optimize_dist else p.dist)
        grad_norm = max(float(g_c.abs().max()), float(g_p.abs().max()))
        return cand, float(pred), grad_norm

    def solve(self) -> Result:
        """LM from the start, with the traffic's solver settings."""
        solver = self.solver
        p = self.start
        loss = self.cost(p)
        lam, nu = float(solver.get("init_lambda", 1e-4)), 2.0
        lam_lo = float(solver.get("min_lambda", 1e-32))
        lam_hi = float(solver.get("max_lambda", 1e32))
        accepted = iterations = self.fallbacks = 0
        converged = False
        while iterations < solver["maxiter"] and not converged:
            cand, pred, grad_norm = self._step(p, lam, solver["cg_maxiter"],
                                               solver["cg_rtol"])
            loss_cand = self.cost(cand)
            gain = (loss - loss_cand) / max(pred, 1e-32)
            accept = loss_cand == loss_cand and loss_cand < loss
            converged = grad_norm < solver["gtol"] or (
                accept and loss - loss_cand <= solver["ftol"] * max(loss, 1e-32))
            iterations += 1
            if accept:
                p, loss = cand, loss_cand
                lam = lam * max(1.0 - (2.0 * gain - 1.0) ** 3, 1.0 / 3.0)
                nu = 2.0
                accepted += 1
            else:
                lam, nu = lam * nu, 2.0 * nu
            lam = min(max(lam, lam_lo), lam_hi)
        return Result(params=p, loss=loss, accepted=accepted, iterations=iterations,
                      fallbacks=self.fallbacks)
