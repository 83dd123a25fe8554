"""Least device time of the flat engine's two kernels, ``flat_lin_kernel``
and ``flat_coupling_kernel`` (``tpu3drecon_torch/csrc/flat_kernels.cu``),
from the shape of one launch: its observations N, cameras C and points P,
its camera width NP (8, or 10 with k1, k2) and its float size.

Each input read once and each output written once at 3.35 TB/s, or the
float operations per observation at the card's rate for that float size,
whichever is longer.  Camera rows, points and V^-1 are counted once per
camera or point (the kernels read them from cache after the first time);
the sums' zeroing is the caller's memset, not the kernel's.  At
Final-13682 (29.0M observations, 4.46M points) in float32 and NP = 8 the
bytes come to ~3.6 GB and ~0.8 GB, the floors that the kernel file
states.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FLOPS_PER_S = {4: 67e12, 8: 34e12}  # H100 SXM, without the tensor cores: f32, f64
CAM_ROW = 19  # R (9) | t (3) | fx fy (2) | cx cy skew (3) | k1 k2 (2)
KERNELS = ("lin_kernel", "coupling_kernel")


def _sym(np_cam: int) -> int:
    """Entries of an NP x NP block's upper triangle."""
    return np_cam * (np_cam + 1) // 2


def obs_flops(kernel: str, np_cam: int) -> int:
    """Float operations of one observation (a multiply, an add, a divide or
    a square root each one; a fused multiply-add two)."""
    sym = _sym(np_cam)
    # r, J_c and J_p (slot.cuh tt_blocks): 153 at NP = 8; each of the two
    # k columns adds 5 (K2 m's row, r^2 or r^4, two products) and 2 scalings.
    blocks = 153 + 7 * (np_cam - 8)
    w = 9 * np_cam  # W = J_c^T J_p: NP x 3 entries of 2 products and a sum
    if kernel == "lin_kernel":
        return (blocks + w
                + 3 * sym  # U's upper triangle, 2 products and a sum each
                + 3 * np_cam  # g_c = J_c^T r
                + 18 + 9  # V's 6 entries and g_p's 3
                + sym + np_cam + 9)  # the warp sums: one add per column
    if kernel == "coupling_kernel":
        return (blocks + w
                + 15 * np_cam  # W V^-1: NP x 3 entries of 3 products and 2 sums
                + 5 * sym  # (W V^-1) W^T's upper triangle, 3 products and 2 sums
                + sym)  # the warp sums
    raise KeyError(kernel)


def launch_bytes(kernel: str, n_obs: int, n_cams: int, n_pts: int, np_cam: int,
                 itemsize: int = 4) -> int:
    """Bytes one launch must move: each input read and each output written
    once."""
    e = itemsize
    obs = 2 * 4 + 3 * e  # cam_idx, pt_idx (int32), uv, mask
    cams = CAM_ROW * e  # the camera row
    pts = 3 * e  # the point
    if kernel == "lin_kernel":
        return (n_obs * (obs + 3 * np_cam * e)  # ... and W written
                + n_cams * (cams + (_sym(np_cam) + np_cam) * e)  # U | g_c written
                + n_pts * (pts + 9 * e))  # V | g_p written
    if kernel == "coupling_kernel":
        return (n_obs * obs
                + n_cams * (cams + _sym(np_cam) * e)  # the coupling written
                + n_pts * (pts + 9 * e))  # V^-1 read
    raise KeyError(kernel)


def launch_least_s(kernel: str, n_obs: int, n_cams: int, n_pts: int, np_cam: int,
                   itemsize: int = 4) -> float:
    """The least time of one launch: bytes or operations, the longer."""
    return max(launch_bytes(kernel, n_obs, n_cams, n_pts, np_cam, itemsize) / HBM_BYTES_PER_S,
               obs_flops(kernel, np_cam) * n_obs / FLOPS_PER_S[itemsize])
