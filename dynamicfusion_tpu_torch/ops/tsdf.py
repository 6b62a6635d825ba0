"""TSDF volume ops (port of ``dynamicfusion_tpu.ops.tsdf``): trilinear
sampling, rigid integrate (brick dispatch), raycast, surface extraction.

``march_and_refine`` owns CUDA kernel C (``csrc/raycast.cu``): one thread
per ray marches with its own early exit and refines the crossing with the
secant + Newton polish or, under ``raycast_refine="newton8"`` (the
dynamicfusion preset's), with one Newton step from the secant of the
march's own bracket values. The plain version below keeps the JAX lockstep
loop (all rays step together, finished rays masked). ``extract_cloud``
owns kernel L's extraction (``csrc/extract.cu``): tile counts, their scan
and an ordered write, equal to the plain version bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from dynamicfusion_tpu_torch import kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig, Intrinsics
from dynamicfusion_tpu_torch.core import compact, se3
from dynamicfusion_tpu_torch.models import volume as volume_model
from dynamicfusion_tpu_torch.models.volume import TsdfVolume

NAN = float("nan")


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of size 3, in the fixed order the kernels use."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


# --------------------------------------------------------------------------
# sampling helpers
# --------------------------------------------------------------------------


def fetch_nearest(tsdf: torch.Tensor, p_voxels: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour fetch at fractional voxel coords (..., 3), rounded
    half-to-even and clipped into the volume; decoded after the gather."""
    d = tsdf.shape[0]
    idx = torch.round(p_voxels).clamp(0, d - 1).to(torch.int64)
    flat = (idx[..., 0] * d + idx[..., 1]) * d + idx[..., 2]
    v = tsdf.reshape(-1)[flat]
    return v.to(torch.float32) * volume_model.tsdf_decode_scale(tsdf.dtype)


def _corners(tsdf: torch.Tensor, p_voxels: torch.Tensor):
    """Cell origin fraction, out-of-bounds mask and the 8 corner values."""
    d = tsdf.shape[0]
    g = torch.floor(p_voxels)
    f = p_voxels - g
    gi = torch.nan_to_num(g, nan=-1.0).clamp(-1, d).to(torch.int64)
    oob = ((gi < 0) | (gi >= d - 1)).any(dim=-1)
    gi = gi.clamp(0, d - 2)
    base = (gi[..., 0] * d + gi[..., 1]) * d + gi[..., 2]
    flat = tsdf.reshape(-1)
    cor = {}
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cor[dx, dy, dz] = flat[base + (dx * d + dy) * d + dz].to(torch.float32)
    return f, oob, cor


def interpolate(tsdf: torch.Tensor, p_voxels: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation at fractional voxel coords (..., 3); NaN
    outside the interpolation region."""
    f, oob, cor = _corners(tsdf, p_voxels)
    a, b, c = f[..., 0], f[..., 1], f[..., 2]
    out = torch.zeros(p_voxels.shape[:-1], dtype=torch.float32, device=p_voxels.device)
    for dx in (0, 1):
        wx = a if dx else (1.0 - a)
        for dy in (0, 1):
            wy = b if dy else (1.0 - b)
            for dz in (0, 1):
                wz = c if dz else (1.0 - c)
                out = out + cor[dx, dy, dz] * (wx * wy * wz)
    out = out * volume_model.tsdf_decode_scale(tsdf.dtype)
    return torch.where(oob, NAN, out)


def interpolate_with_gradient(
    tsdf: torch.Tensor, p_voxels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear value and its analytic in-cell gradient (tsdf per voxel)
    from one set of 8 corner fetches; NaN outside the region."""
    f, oob, cor = _corners(tsdf, p_voxels)
    a, b, c = f[..., 0], f[..., 1], f[..., 2]
    wa0, wa1 = 1.0 - a, a
    wb0, wb1 = 1.0 - b, b
    wc0, wc1 = 1.0 - c, c
    val = (
        wa0 * (wb0 * (wc0 * cor[0, 0, 0] + wc1 * cor[0, 0, 1])
               + wb1 * (wc0 * cor[0, 1, 0] + wc1 * cor[0, 1, 1]))
        + wa1 * (wb0 * (wc0 * cor[1, 0, 0] + wc1 * cor[1, 0, 1])
                 + wb1 * (wc0 * cor[1, 1, 0] + wc1 * cor[1, 1, 1]))
    )
    gx = (
        wb0 * (wc0 * (cor[1, 0, 0] - cor[0, 0, 0]) + wc1 * (cor[1, 0, 1] - cor[0, 0, 1]))
        + wb1 * (wc0 * (cor[1, 1, 0] - cor[0, 1, 0]) + wc1 * (cor[1, 1, 1] - cor[0, 1, 1]))
    )
    gy = (
        wa0 * (wc0 * (cor[0, 1, 0] - cor[0, 0, 0]) + wc1 * (cor[0, 1, 1] - cor[0, 0, 1]))
        + wa1 * (wc0 * (cor[1, 1, 0] - cor[1, 0, 0]) + wc1 * (cor[1, 1, 1] - cor[1, 0, 1]))
    )
    gz = (
        wa0 * (wb0 * (cor[0, 0, 1] - cor[0, 0, 0]) + wb1 * (cor[0, 1, 1] - cor[0, 1, 0]))
        + wa1 * (wb0 * (cor[1, 0, 1] - cor[1, 0, 0]) + wb1 * (cor[1, 1, 1] - cor[1, 1, 0]))
    )
    sc = volume_model.tsdf_decode_scale(tsdf.dtype)
    nanv = torch.where(oob, NAN, 0.0)
    grad = torch.stack([gx, gy, gz], dim=-1) * sc
    return val * sc + nanv, grad + nanv[..., None]


# --------------------------------------------------------------------------
# integrate
# --------------------------------------------------------------------------


def integrate(
    cfg: DynamicFusionConfig,
    vol: TsdfVolume,
    dists: torch.Tensor,
    vol2cam: torch.Tensor,
    intr: Intrinsics,
    ok: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Rigid projective TSDF fusion of one dists image, brick-sparse
    (``ops.bricks``), IN PLACE on ``vol``. ``vol2cam`` maps volume-frame
    meters to the camera frame. ``ok`` (a () bool device tensor) gates the
    whole update without a host sync. Returns the (3,) int32
    (band, wide, dropped) brick counts (zeros where ``ok`` is False)."""
    if cfg.integrate_mode != "brick":
        raise NotImplementedError("dense integrate: a later slice")
    from dynamicfusion_tpu_torch.ops import bricks

    return bricks.integrate_bricks(
        cfg, vol, dists, brick_grid(cfg, vol2cam), cfg.brick_size, intr, ok=ok, plain=plain
    )


def brick_grid(cfg: DynamicFusionConfig, vol2cam: torch.Tensor) -> torch.Tensor:
    """(G, G, G, 3) camera-frame positions of the voxel grid at stride
    ``brick_size``: the rigid integrate's brick corners (prolongation of an
    affine map is exact)."""
    g = cfg.brick_size
    gp = cfg.volume_dims // g + 1
    ax = torch.arange(gp, dtype=torch.float32, device=vol2cam.device) * (g * cfg.voxel_size)
    rr = vol2cam[:3, :3]
    tt = vol2cam[:3, 3]
    i = ax[:, None, None]
    j = ax[None, :, None]
    kk = ax[None, None, :]
    return torch.stack(
        [rr[a, 0] * i + rr[a, 1] * j + rr[a, 2] * kk + tt[a] for a in range(3)], dim=-1
    )


# --------------------------------------------------------------------------
# raycast
# --------------------------------------------------------------------------


class RaycastResult(NamedTuple):
    points: torch.Tensor   # (H, W, 3) camera frame, NaN invalid
    normals: torch.Tensor  # (H, W, 3) camera frame, NaN invalid


def _ray_box(ray_org: torch.Tensor, ray_dir: torch.Tensor, box_max: float):
    """Slab test against [0, box_max]^3 -> (tnear, tfar)."""
    safe = torch.where(torch.abs(ray_dir) > 1e-12, ray_dir, 1e-12)
    inv = 1.0 / safe
    tbot = inv * (0.0 - ray_org)
    ttop = inv * (box_max - ray_org)
    tmin = torch.minimum(ttop, tbot)
    tmax = torch.maximum(ttop, tbot)
    return tmin.amax(dim=-1), tmax.amin(dim=-1)


def rays(
    cfg: DynamicFusionConfig,
    cam2vol: torch.Tensor,
    intr: Intrinsics,
    rows: int,
    cols: int,
    t_seed: Optional[torch.Tensor] = None,
    t_band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """The raycast's rays in the volume frame: (origin (3,), unit
    directions (H, W, 3), march interval tmin, tmax (H, W)), all
    contiguous. ``t_band`` = per-pixel march interval (lo, hi) (rays with
    hi <= lo miss); ``t_seed`` = expected distance, marching
    [seed - m, seed + m] where seed > 0."""
    dev = cam2vol.device
    vs = cfg.voxel_size
    step = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor
    vol_size = vs * cfg.volume_dims
    r_cv = cam2vol[:3, :3]
    ray_org = cam2vol[:3, 3].contiguous()

    v = torch.arange(rows, dtype=torch.float32, device=dev)[:, None].expand(rows, cols)
    u = torch.arange(cols, dtype=torch.float32, device=dev)[None, :].expand(rows, cols)
    dirs = torch.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, torch.ones_like(u)], dim=-1)
    dirs = se3.rotate(r_cv, dirs)
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)

    tmin, tmax = _ray_box(ray_org, dirs, vol_size - vs)
    tmin = torch.clamp(tmin, min=0.0)
    tmax = tmax - step
    if t_band is not None:
        lo = torch.nan_to_num(t_band[0])
        hi = torch.nan_to_num(t_band[1])
        if cfg.raycast_band_cap > 0.0:
            hi = torch.minimum(hi, lo + cfg.raycast_band_cap)
        tmin = torch.maximum(tmin, lo)
        tmax = torch.minimum(tmax, hi)
    elif t_seed is not None:
        m = cfg.raycast_seed_margin
        seeded = t_seed > 0.0
        ts0 = torch.nan_to_num(t_seed)
        tmin = torch.where(seeded, torch.minimum(torch.maximum(ts0 - m, tmin), tmax), tmin)
        tmax = torch.where(seeded, torch.minimum(ts0 + m, tmax), tmax)
    return ray_org, dirs.contiguous(), tmin.contiguous(), tmax.contiguous()


def raycast(
    cfg: DynamicFusionConfig,
    vol: TsdfVolume,
    cam2vol: torch.Tensor,
    intr: Intrinsics,
    rows: int,
    cols: int,
    t_seed: Optional[torch.Tensor] = None,
    t_band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    plain: bool = False,
) -> RaycastResult:
    """Per-pixel ray march for the zero crossing (``rays`` says which
    interval each ray marches); points/normals in the camera frame."""
    _refine_mode(cfg)
    if cfg.raycast_smooth_normals:
        raise NotImplementedError("smoothed raycast normals: a later slice")
    ray_org, dirs, tmin, tmax = rays(cfg, cam2vol, intr, rows, cols, t_seed, t_band)
    found, vertex_vol, normal_vol = march_and_refine(cfg, vol.tsdf, ray_org, dirs, tmin, tmax, plain=plain)
    nn = torch.linalg.vector_norm(normal_vol, dim=-1, keepdim=True)
    normal_vol = normal_vol / torch.clamp(nn, min=1e-12)
    valid = found & ~torch.isnan(normal_vol).any(dim=-1) & (nn[..., 0] > 1e-12)
    r_vc = cam2vol[:3, :3].T
    vertex_cam = se3.rotate(r_vc, vertex_vol - ray_org)
    normal_cam = se3.rotate(r_vc, normal_vol)
    return RaycastResult(
        points=torch.where(valid[..., None], vertex_cam, NAN),
        normals=torch.where(valid[..., None], normal_cam, NAN),
    )


REFINES = ("secant", "newton8")


def _refine_mode(cfg: DynamicFusionConfig) -> int:
    """Kernel C's refine code of ``cfg.raycast_refine`` (0 secant, 1
    newton8); the experimental newton16 and hybrid16 refines are not
    ported and raise."""
    if cfg.raycast_refine not in REFINES:
        raise NotImplementedError(f"{cfg.raycast_refine} refine: a later slice")
    return REFINES.index(cfg.raycast_refine)


def march_steps(cfg: DynamicFusionConfig) -> int:
    """Step cap of a ray: the JAX loop runs two steps per trip and checks
    its count between trips, so a ray takes ``n_steps`` rounded up to even."""
    step = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor
    n_steps = int(math.ceil(math.sqrt(3.0) * cfg.voxel_size * cfg.volume_dims / step)) + 1
    return n_steps + (n_steps % 2)


def march_and_refine_plain(
    cfg: DynamicFusionConfig,
    tsdf: torch.Tensor,
    ray_org: torch.Tensor,
    dirs: torch.Tensor,
    tmin: torch.Tensor,
    tmax: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lockstep march (nearest fetches, step doubled where the previous
    sample is > 0.99) and the refine of ``cfg.raycast_refine``: "secant"
    (secant between trilinear values at the bracket ends, then a Newton
    polish) or "newton8" (secant from the march's nearest-fetched bracket
    values f0/f1, then one clamped Newton step; the normal is the gradient
    at the secant point, the vertex the point after the step). Returns
    (found, vertex_vol, normal_vol) in the volume frame; the normal is the
    unnormalized trilinear gradient."""
    newton8 = _refine_mode(cfg) == 1
    inv_vs = 1.0 / cfg.voxel_size
    step = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor

    def point(t):
        return (ray_org + dirs * t[..., None]) * inv_vs

    t = tmin
    done = tmin >= tmax
    found = torch.zeros_like(done)
    t_hit = torch.zeros_like(tmin)
    dt_hit = torch.full_like(tmin, step)
    f0 = torch.ones_like(tmin)
    f1 = -torch.ones_like(tmin)
    tsdf_prev = fetch_nearest(tsdf, point(tmin))
    for i in range(march_steps(cfg)):
        if i % 2 == 0 and bool(done.all()):
            break
        if cfg.raycast_adaptive_step:
            dt = torch.where(tsdf_prev > 0.99, 2.0 * step, step)
        else:
            dt = torch.full_like(tsdf_prev, step)
        tnext = t + dt
        active = ~done & (t < tmax)
        tsdf_next = fetch_nearest(tsdf, point(tnext))
        crossing = (tsdf_prev > 0.0) & (tsdf_next < 0.0) & active
        behind = (tsdf_prev < 0.0) & (tsdf_next > 0.0) & active
        t_hit = torch.where(crossing, t, t_hit)
        dt_hit = torch.where(crossing, dt, dt_hit)
        if newton8:
            f0 = torch.where(crossing, tsdf_prev, f0)
            f1 = torch.where(crossing, tsdf_next, f1)
        t = torch.where(active, tnext, t)
        done = done | crossing | behind | (tnext >= tmax)
        found = found | crossing
        tsdf_prev = torch.where(active, tsdf_next, tsdf_prev)

    if newton8:
        denom0 = f0 - f1
        alpha = torch.clamp(f0 / torch.where(torch.abs(denom0) > 1e-12, denom0, 1e-12), 0.0, 1.0)
        ts = t_hit + dt_hit * alpha
        f_v, normal_vol = interpolate_with_gradient(tsdf, point(ts))
        dfdt = _dot3(normal_vol, dirs) * inv_vs
        ts2 = ts - f_v / torch.where(torch.abs(dfdt) > 1e-12, dfdt, 1e-12)
        good2 = torch.isfinite(ts2) & (torch.abs(ts2 - ts) < dt_hit) & ~torch.isnan(f_v)
        ts = torch.where(good2, ts2, ts)
        return found, ray_org + dirs * ts[..., None], normal_vol

    ft = interpolate(tsdf, point(t_hit))
    ftdt = interpolate(tsdf, point(t_hit + dt_hit))
    denom = ftdt - ft
    ts = t_hit - dt_hit * ft / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
    ts = torch.where(torch.isnan(ft) | torch.isnan(ftdt), t_hit, ts)
    f_v, normal_vol = interpolate_with_gradient(tsdf, point(ts))
    dfdt = _dot3(normal_vol, dirs) * inv_vs
    ts2 = ts - f_v / torch.where(torch.abs(dfdt) > 1e-12, dfdt, 1e-12)
    good2 = torch.isfinite(ts2) & (torch.abs(ts2 - ts) < dt_hit) & ~torch.isnan(f_v)
    ts = torch.where(good2, ts2, ts)
    vertex_vol = ray_org + dirs * ts[..., None]
    return found, vertex_vol, normal_vol


def march_and_refine(
    cfg: DynamicFusionConfig,
    tsdf: torch.Tensor,
    ray_org: torch.Tensor,
    dirs: torch.Tensor,
    tmin: torch.Tensor,
    tmax: torch.Tensor,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel C on CUDA tensors, the plain version on CPU tensors or where
    the caller asks for it. The kernel leaves vertex/normal of rays that
    found nothing as NaN."""
    if plain or tsdf.device.type == "cpu":
        return march_and_refine_plain(cfg, tsdf, ray_org, dirs, tmin, tmax)
    return kernels.march_and_refine(
        tsdf, ray_org, dirs, tmin, tmax,
        voxel_size=cfg.voxel_size,
        step=volume_model.trunc_dist(cfg) * cfg.raycast_step_factor,
        max_steps=march_steps(cfg),
        adaptive=cfg.raycast_adaptive_step,
        refine=_refine_mode(cfg),
    )


def coarse_band_plain(points_c: torch.Tensor, factor: int, margin: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel J's coarse-band entry: ray distances |p|
    of the coarse hits (summed in the kernel's order), their 3x3 window
    min and max (+-inf outside, a miss counts as none), widened by
    ``margin``, empty where no neighbour hit, each coarse value repeated
    ``factor`` x ``factor``."""
    import torch.nn.functional as F

    p = points_c
    t = torch.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2])
    hit = ~torch.isnan(t)
    inf = float("inf")
    lo_c = -F.max_pool2d(-torch.where(hit, t, inf)[None, None], 3, 1, padding=1)[0, 0]
    hi_c = F.max_pool2d(torch.where(hit, t, -inf)[None, None], 3, 1, padding=1)[0, 0]
    any_hit = torch.isfinite(lo_c)
    lo_c = torch.where(any_hit, torch.clamp(lo_c - margin, min=0.0), 0.0)
    hi_c = torch.where(any_hit, hi_c + margin, 0.0)
    return tuple(a.repeat_interleave(factor, 0).repeat_interleave(factor, 1) for a in (lo_c, hi_c))


def raycast_coarse_band(
    cfg: DynamicFusionConfig,
    vol: TsdfVolume,
    cam2vol: torch.Tensor,
    intr: Intrinsics,
    rows: int,
    cols: int,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse-to-fine march band of a (rows, cols) raycast: a full march at
    1/f resolution (f = ``raycast_coarse_factor``, kernel C), then each fine
    pixel's band [min - m, max + m] of the hit distances over its coarse
    cell's 3x3 window (m = ``raycast_band_margin``; kernel J's
    ``coarse_band`` on CUDA tensors, ``coarse_band_plain`` on CPU tensors or
    where the caller asks). Fine rays whose whole window missed do not
    march."""
    f = cfg.raycast_coarse_factor
    lvl = f.bit_length() - 1
    if f != 1 << lvl or rows % f or cols % f:
        raise ValueError(f"coarse factor {f} must be a power of two dividing {rows}x{cols}")
    res_c = raycast(cfg, vol, cam2vol, intr.level(lvl), rows // f, cols // f, plain=plain)
    if plain or vol.tsdf.device.type == "cpu":
        return coarse_band_plain(res_c.points, f, cfg.raycast_band_margin)
    return kernels.coarse_band(res_c.points.contiguous(), f, cfg.raycast_band_margin)


# --------------------------------------------------------------------------
# extraction
# --------------------------------------------------------------------------


class ExtractedCloud(NamedTuple):
    points: torch.Tensor  # (K, 3) world frame; rows past the count are NaN
    valid: torch.Tensor   # (K,) bool
    count: torch.Tensor   # () int32


def extract_cloud_plain(cfg: DynamicFusionConfig, vol: TsdfVolume, max_points: int, mw: float) -> ExtractedCloud:
    """The plain version of kernel L's extraction: the crossing flags of
    all three axes concatenated and compacted with a cumulative sum."""
    d = cfg.volume_dims
    vs = cfg.voxel_size
    dev = vol.tsdf.device
    tsdf = volume_model.decode_tsdf(vol.tsdf)
    w = volume_model.decode_weight(vol.weight)

    crosses = []
    for axis in range(3):
        t0 = tsdf.narrow(axis, 0, d - 1)
        t1 = tsdf.narrow(axis, 1, d - 1)
        w0 = w.narrow(axis, 0, d - 1)
        w1 = w.narrow(axis, 1, d - 1)
        crosses.append(((w0 >= mw) & (w1 >= mw) & (t0 * t1 < 0)).reshape(-1))
    valid = torch.cat(crosses)
    sel = compact.first_true(valid, max_points)
    ok = sel >= 0
    sel = sel.clamp(min=0)
    per_axis = (d - 1) * d * d
    axis = sel // per_axis
    rem = sel % per_axis
    # the axis's own extent is d - 1, the other two d
    nk = torch.where(axis == 2, d - 1, d)
    nj = torch.where(axis == 1, d - 1, d)
    k = rem % nk
    j = (rem // nk) % nj
    i = rem // (nk * nj)
    t0 = tsdf.reshape(-1)[(i * d + j) * d + k]
    step = torch.stack([axis == 0, axis == 1, axis == 2], dim=-1).to(torch.int64)
    t1 = tsdf.reshape(-1)[((i + step[:, 0]) * d + j + step[:, 1]) * d + k + step[:, 2]]
    den = t0 - t1
    alpha = t0 / torch.where(torch.abs(den) > 1e-12, den, 1e-12)
    idx = torch.stack([i, j, k], dim=-1).to(torch.float32)
    idx = idx + step.to(torch.float32) * alpha[:, None]
    out = idx * vs + volume_model.origin(cfg, dev)
    out = torch.where(ok[:, None], out, NAN)
    return ExtractedCloud(points=out, valid=ok, count=valid.sum(dtype=torch.int32))


def extract_cloud(
    cfg: DynamicFusionConfig,
    vol: TsdfVolume,
    max_points: int,
    min_weight: float | None = None,
    plain: bool = False,
) -> ExtractedCloud:
    """Zero-crossing surface cloud in world coordinates: for each voxel and
    its +x/+y/+z neighbour, both observed (weight >= min_weight) with a
    sign change, the linearly interpolated crossing. Static-size
    compaction in the JAX order (axis-major, then x-major voxel order);
    ``count`` is the uncapped total. Kernel L (``csrc/extract.cu``) on CUDA
    tensors, the plain version on CPU tensors or where the caller asks."""
    mw = cfg.extract_min_weight if min_weight is None else min_weight
    if plain or vol.tsdf.device.type == "cpu":
        return extract_cloud_plain(cfg, vol, max_points, mw)
    return ExtractedCloud(*kernels.extract_cloud(
        vol.tsdf, vol.weight, mw, max_points, cfg.voxel_size, tuple(float(v) for v in cfg.volume_origin),
    ))
