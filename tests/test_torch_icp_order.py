"""Kernel B's order (``csrc/icp_reduce.cu``) on the CPU.

The kernel forms each current pixel's 6-row and its 27 products (the 21
upper-triangle entries of JᵀJ and the 6 of Jᵀr) in float32, sums them over
groups of 256 pixels (a shuffle tree 16, 8, 4, 2, 1 over each warp's 32
lanes, then the 8 warps' sums in warp order), then the groups' sums in
group order, and writes the full symmetric A and b. ``system_ordered``
transcribes that in torch, operation for operation (the kernel's
association, no fused multiply-add), and is held within 1e-4 relative of
the port's plain ``_build_system_plain`` and of the JAX package's jitted
``_build_system``: the three sum in different orders, and a relative 1e-4
of the largest entry is ``chip_smoke.TOL_ICP_REL``, the tolerance the card
holds the kernel to against the plain version.

Inputs: the synthetic sphere scene at 160x120 and 80x60 (the last group
of 256 pixels partly empty at 80x60), the current frame one orbit step
from the previous, at the identity and at a small twist. No full-width
JAX compile.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import Intrinsics as JIntr
from dynamicfusion_tpu.solvers import icp as jicp
from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.core import se3
from dynamicfusion_tpu_torch.io import synthetic
from dynamicfusion_tpu_torch.ops import preprocess
from dynamicfusion_tpu_torch.solvers import icp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL_ICP_REL = 1e-4
GROUP, WARPS = 256, 8
SCENE = dict(
    spheres=[dict(center=(0.0, 0.0, 0.9), radius=0.2), dict(center=(0.25, 0.15, 1.0), radius=0.12)],
    plane_z=1.2,
)


def packed(r: int, c: int) -> int:
    """The index of entry (r, c), r <= c, among the 21 upper-triangle sums
    in the kernel's row-major order (``write_system``)."""
    return r * 6 - r * (r - 1) // 2 + (c - r)


def products(intr, t, cp, cn, pp, pn, dist2_thres, min_cos) -> torch.Tensor:
    """(P, 27) float32: each pixel's 27 products as the kernel forms them,
    zero where the pixel is masked."""
    f = torch.float32
    t = t.to(f).reshape(-1)
    p, q = cp.reshape(-1, 3), cn.reshape(-1, 3)
    rows, cols = pp.shape[:2]
    sx = p[:, 0] * t[0] + p[:, 1] * t[1] + p[:, 2] * t[2] + t[3]
    sy = p[:, 0] * t[4] + p[:, 1] * t[5] + p[:, 2] * t[6] + t[7]
    sz = p[:, 0] * t[8] + p[:, 1] * t[9] + p[:, 2] * t[10] + t[11]
    fx, fy, cx, cy = (torch.tensor(v, dtype=f) for v in (intr.fx, intr.fy, intr.cx, intr.cy))
    u = sx * fx / sz + cx
    v = sy * fy / sz + cy
    inb = (sz > 0) & (u >= 0) & (v >= 0) & (u < cols) & (v < rows)
    ui = torch.nan_to_num(torch.floor(u), nan=0.0).clamp(0, cols - 1).to(torch.int64)
    vi = torch.nan_to_num(torch.floor(v), nan=0.0).clamp(0, rows - 1).to(torch.int64)
    j = vi * cols + ui
    d, n = pp.reshape(-1, 3)[j], pn.reshape(-1, 3)[j]
    valid = ~torch.isnan(p[:, 0]) & inb & ~torch.isnan(d[:, 0]) & ~torch.isnan(n[:, 0])
    ex, ey, ez = sx - d[:, 0], sy - d[:, 1], sz - d[:, 2]
    dist2 = ex * ex + ey * ey + ez * ez
    nsx = q[:, 0] * t[0] + q[:, 1] * t[1] + q[:, 2] * t[2]
    nsy = q[:, 0] * t[4] + q[:, 1] * t[5] + q[:, 2] * t[6]
    nsz = q[:, 0] * t[8] + q[:, 1] * t[9] + q[:, 2] * t[10]
    cosine = torch.abs(nsx * n[:, 0] + nsy * n[:, 1] + nsz * n[:, 2])
    mask = valid & (dist2 < torch.tensor(dist2_thres, dtype=f)) & (cosine > torch.tensor(min_cos, dtype=f))
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    row = [sy * nz - sz * ny, sz * nx - sx * nz, sx * ny - sy * nx, nx, ny, nz]
    rhs = nx * (d[:, 0] - sx) + ny * (d[:, 1] - sy) + nz * (d[:, 2] - sz)
    prods = [row[a] * row[b] for a in range(6) for b in range(a, 6)] + [row[a] * rhs for a in range(6)]
    return torch.where(mask[:, None], torch.stack(prods, dim=1), torch.zeros(()))


def ordered_sums(x: torch.Tensor) -> torch.Tensor:
    """(27,) float32: the kernel's order over the (P, 27) products."""
    groups = -(-x.shape[0] // GROUP)
    x = torch.cat([x, x.new_zeros((groups * GROUP - x.shape[0], 27))]).reshape(groups, WARPS, 32, 27).clone()
    for off in (16, 8, 4, 2, 1):  # lane l takes lane l + off's value: lane 0's tree
        x[:, :, :off] = x[:, :, :off] + x[:, :, off : 2 * off]
    block = torch.zeros((groups, 27))
    for w in range(WARPS):
        block = block + x[:, w, 0]
    total = torch.zeros(27)
    for g in range(groups):
        total = total + block[g]
    return total


def system_ordered(*args):
    s = ordered_sums(products(*args))
    a = torch.stack([torch.stack([s[packed(min(r, c), max(r, c))] for c in range(6)]) for r in range(6)])
    return a, s[21:]


@functools.lru_cache(maxsize=None)
def inputs(cols: int, twist: bool):
    cfg = DynamicFusionConfig.small(rows=cols * 3 // 4, cols=cols)
    intr = cfg.intr
    depth = [synthetic.scene_depth(intr, cfg.rows, cfg.cols, synthetic.orbit_pose(a, target=(0.0, 0.0, 0.9)), **SCENE)
             for a in (0.0, 0.02)]
    prev = preprocess.compute_points_normals(intr, torch.from_numpy(depth[0]))
    cur = preprocess.compute_points_normals(intr, torch.from_numpy(depth[1]))
    xi = torch.tensor([0.003, -0.002, 0.001, 0.004, 0.002, -0.003] if twist else [0.0] * 6)
    t = se3.exp_twist(xi).to(torch.float32)
    return (intr, t, cur[0], cur[1], prev[0], prev[1], cfg.icp_dist_thres ** 2, math.cos(cfg.icp_angle_thres))


def rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def test_packed_order_is_the_upper_triangle_row_major():
    assert [packed(r, c) for r in range(6) for c in range(r, 6)] == list(range(21))


@pytest.mark.parametrize("cols", [80, 160])
@pytest.mark.parametrize("twist", [False, True])
def test_order_against_plain_and_jax(cols, twist):
    args = inputs(cols, twist)
    a, b = system_ordered(*args)
    assert bool(torch.equal(a, a.T))
    ap, bp = icp._build_system_plain(*args)
    scale = max(float(ap.abs().max()), float(bp.abs().max()))
    assert scale > 0 and int((products(*args)[:, 0] != 0).sum()) > 100
    assert max(float((a - ap).abs().max()), float((b - bp).abs().max())) <= TOL_ICP_REL * scale
    intr, t, cp, cn, pp, pn, d2, mc = args
    jintr = JIntr(intr.fx, intr.fy, intr.cx, intr.cy)
    fn = jax.jit(functools.partial(jicp._build_system, jintr, dist2_thres=d2, min_cosine=mc))
    aj, bj = fn(*(jnp.asarray(x.numpy()) for x in (t, cp, cn, pp, pn)))
    aj, bj = torch.from_numpy(np.array(aj)), torch.from_numpy(np.array(bj))
    assert max(float((a - aj).abs().max()), float((b - bj).abs().max())) <= TOL_ICP_REL * scale
    assert rel(ap, aj) <= TOL_ICP_REL


def test_order_is_not_the_plain_sum_order():
    """The transcription's order shows in the last bits (so the card's bit
    for bit holds read the kernel's order, not an accident of the data)."""
    args = inputs(160, True)
    a, b = system_ordered(*args)
    x = products(*args)
    flat = x.sum(dim=0)
    assert not torch.equal(torch.cat([a[0], b]), torch.cat([flat[:6], flat[21:]]))
