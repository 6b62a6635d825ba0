"""TSDF volume ops (port of ``dynamicfusion_tpu.ops.tsdf``): trilinear
sampling, rigid integrate (brick dispatch or dense), raycast, surface
extraction.

``march_and_refine`` owns CUDA kernel C (``csrc/raycast.cu``): one thread
per ray marches with its own early exit and refines the crossing with the
secant + Newton polish, or from the bracket values of the march itself:
newton8 (the dynamicfusion preset's, one Newton step from their secant),
newton16 (two steps) or hybrid16 (two fused fetches and an exact two-point
secant). Under ``raycast_smooth_normals`` the normal is the reference's
six-sample central difference at the vertex. The plain version below
keeps the JAX lockstep loop (all rays step together, finished rays
masked). ``integrate_dense`` owns kernel F1 (``csrc/fuse_dense.cu``), the
dense projective update of every voxel under ``integrate_mode="dense"``.
``extract_cloud`` owns kernel L's extraction (``csrc/extract.cu``): tile
counts, their scan and an ordered write, equal to the plain version bit
for bit. ``extract_normals`` owns kernel R (``csrc/normals.cu``): one
thread a point of an extracted list, the six-sample gradient normalized.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from dynamicfusion_tpu_torch import device as device_mod
from dynamicfusion_tpu_torch import kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig, Intrinsics
from dynamicfusion_tpu_torch.core import compact, se3
from dynamicfusion_tpu_torch.models import volume as volume_model
from dynamicfusion_tpu_torch.models.volume import TsdfVolume

NAN = float("nan")
INF = float("inf")


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of size 3, in the fixed order the kernels use."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


# --------------------------------------------------------------------------
# sampling helpers
# --------------------------------------------------------------------------


def fetch_nearest(tsdf: torch.Tensor, p_voxels: torch.Tensor, x_off: int = 0, d: Optional[int] = None) -> torch.Tensor:
    """Nearest-neighbour fetch at fractional voxel coords (..., 3), rounded
    half-to-even and clipped into the volume; decoded after the gather.
    On a slab (``d`` the global side, the slab's first plane the global
    x-plane ``x_off``, JAX ``parallel/sharded_raycast.py:57``) the index is
    clipped globally first, then its x into the slab (on the whole volume
    the second clip changes nothing)."""
    d = tsdf.shape[-1] if d is None else d
    idx = torch.round(p_voxels).clamp(0, d - 1).to(torch.int64)
    flat = (_clampx(tsdf, idx[..., 0], x_off) * d + idx[..., 1]) * d + idx[..., 2]
    v = tsdf.reshape(-1)[flat]
    return v.to(torch.float32) * volume_model.tsdf_decode_scale(tsdf.dtype)


def _clampx(slab: torch.Tensor, x: torch.Tensor, x_off: int) -> torch.Tensor:
    """Global x-plane index -> the slab's plane, clipped into the slab."""
    return (x - x_off).clamp(0, slab.shape[0] - 1)


def _corners(tsdf: torch.Tensor, p_voxels: torch.Tensor, x_off: int = 0, d: Optional[int] = None):
    """Cell origin fraction, out-of-bounds mask and the 8 corner values; on
    a slab (``fetch_nearest``) the out-of-bounds test and the clip are on
    the global indices, then each corner's x is clipped into the slab."""
    d = tsdf.shape[-1] if d is None else d
    g = torch.floor(p_voxels)
    f = p_voxels - g
    gi = torch.nan_to_num(g, nan=-1.0).clamp(-1, d).to(torch.int64)
    oob = ((gi < 0) | (gi >= d - 1)).any(dim=-1)
    gi = gi.clamp(0, d - 2)
    flat = tsdf.reshape(-1)
    xs = (_clampx(tsdf, gi[..., 0], x_off), _clampx(tsdf, gi[..., 0] + 1, x_off))
    cor = {}
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cor[dx, dy, dz] = flat[(xs[dx] * d + gi[..., 1] + dy) * d + gi[..., 2] + dz].to(torch.float32)
    return f, oob, cor


def interpolate(tsdf: torch.Tensor, p_voxels: torch.Tensor, x_off: int = 0, d: Optional[int] = None) -> torch.Tensor:
    """Trilinear interpolation at fractional voxel coords (..., 3); NaN
    outside the interpolation region (on a slab as ``fetch_nearest``)."""
    f, oob, cor = _corners(tsdf, p_voxels, x_off, d)
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
    tsdf: torch.Tensor, p_voxels: torch.Tensor, x_off: int = 0, d: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear value and its analytic in-cell gradient (tsdf per voxel)
    from one set of 8 corner fetches; NaN outside the region (on a slab as
    ``fetch_nearest``)."""
    f, oob, cor = _corners(tsdf, p_voxels, x_off, d)
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
    """Rigid projective TSDF fusion of one dists image, IN PLACE on ``vol``:
    brick-sparse (``ops.bricks``) or, with ``integrate_mode="dense"``,
    every voxel (``integrate_dense``). ``vol2cam`` maps volume-frame meters
    to the camera frame. ``ok`` (a () bool device tensor) gates the whole
    update without a host sync. Returns the (3,) int32 (band, wide,
    dropped) brick counts (zeros where ``ok`` is False, and on the dense
    path, which caps nothing)."""
    if ok is None:
        ok = torch.ones((), dtype=torch.bool, device=dists.device)
    if cfg.integrate_mode != "brick":
        integrate_dense(cfg, vol, dists, vol2cam, intr, ok, plain=plain)
        return torch.zeros((3,), dtype=torch.int32, device=dists.device)
    from dynamicfusion_tpu_torch.ops import bricks

    return bricks.integrate_bricks(
        cfg, vol, dists, brick_grid(cfg, vol2cam), cfg.brick_size, intr, ok=ok, plain=plain
    )


def dense_update_plain(
    cfg: DynamicFusionConfig,
    vol: TsdfVolume,
    lookup: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    intr: Intrinsics,
    ok: torch.Tensor,
    q: Optional[torch.Tensor] = None,
    packed: bool = False,
    slab: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The projective update of every voxel, IN PLACE, from its camera-frame
    position (x, y, z), each (D, D, D): project, fetch the nearest pixel of
    ``lookup`` (the dists image, or with ``packed`` the packed
    depth+confidence image, unpacked into the incidence weight and the SDF
    scale), and fold min(1, psdf * scale / trunc) into the running average
    where the pixel is in the image, observed and psdf >= -trunc, with
    observation weight ``q`` (None = 1; voxels with q <= fusion_quality_min
    are not updated) times the incidence weight, on the voxels where
    ``slab`` (a broadcastable bool mask, the phase split) holds. The JAX
    dense branches (ops/tsdf.py:214-256, ops/fusion.py:263-322) with one
    arithmetic: the rigid update is the q = 1 case bit for bit. Divides by
    tensors, as the kernels divide. Returns the (D, D, D) update mask (the
    voxels the kernels write)."""
    from dynamicfusion_tpu_torch.ops import bricks

    rows, cols = lookup.shape
    dev = lookup.device
    trunc = volume_model.trunc_dist(cfg)
    u = x * intr.fx / z + intr.cx
    v = y * intr.fy / z + intr.cy
    inb = (u >= 0) & (v >= 0) & (u < cols) & (v < rows) & (z > 0)
    # the pixel is read only where it is in the image: clipped before the
    # gather (u is inf or NaN where z <= 0), masked after it
    ui = torch.nan_to_num(torch.floor(u)).clamp(0, cols - 1).to(torch.int64)
    vi = torch.nan_to_num(torch.floor(v)).clamp(0, rows - 1).to(torch.int64)
    dp = lookup.reshape(-1)[vi * cols + ui]
    conf = None
    if packed:
        dp, conf = bricks.unpack_depth_conf(dp)
    obs_w, sdf_scale = bricks.incidence_weight_scale(cfg, conf)
    psdf = dp - torch.sqrt(x * x + y * y + z * z)
    update = inb & (dp != 0.0) & (psdf >= -trunc) & ok
    if slab is not None:
        update = update & slab
    if q is None:
        q = 1.0
    else:
        update = update & (q > cfg.fusion_quality_min)
    q = q * obs_w
    obs = torch.clamp(psdf * sdf_scale / torch.full((), trunc, device=dev), max=1.0)
    t32 = volume_model.decode_tsdf(vol.tsdf)
    w32 = volume_model.decode_weight(vol.weight)
    wq = w32 + q
    fused = (t32 * w32 + obs * q) / torch.clamp(wq, min=1e-12)
    new_t = volume_model.encode_tsdf(torch.where(update & (wq > 1e-12), fused, t32), vol.tsdf.dtype)
    new_w = volume_model.encode_weight(
        torch.where(update, torch.clamp(wq, max=float(cfg.tsdf_max_weight)), w32), vol.weight.dtype
    )
    vol.tsdf.copy_(new_t)
    volume_model.storage_view(vol.weight).copy_(volume_model.storage_view(new_w))
    return update


def integrate_dense_plain(
    cfg: DynamicFusionConfig, vol: TsdfVolume, dists: torch.Tensor, vol2cam: torch.Tensor, intr: Intrinsics,
    ok: torch.Tensor,
) -> torch.Tensor:
    """The plain version of kernel F1: the camera-frame position of every
    voxel corner i * voxel_size as r[a, 0] * i + r[a, 1] * j + r[a, 2] * k
    + t[a] with r = R * voxel_size (JAX ops/tsdf.py:214-222, no + 0.5),
    then ``dense_update_plain``; returns its update mask."""
    d = cfg.volume_dims
    r = vol2cam[:3, :3] * cfg.voxel_size
    t = vol2cam[:3, 3]
    ax = torch.arange(d, dtype=torch.float32, device=dists.device)
    i, j, k = ax[:, None, None], ax[None, :, None], ax[None, None, :]
    x, y, z = (r[a, 0] * i + r[a, 1] * j + r[a, 2] * k + t[a] for a in range(3))
    return dense_update_plain(cfg, vol, dists, x, y, z, intr, ok)


def integrate_dense(
    cfg: DynamicFusionConfig, vol: TsdfVolume, dists: torch.Tensor, vol2cam: torch.Tensor, intr: Intrinsics,
    ok: torch.Tensor, plain: bool = False, reference: bool = False,
) -> None:
    """Dense rigid integrate IN PLACE: kernel F1 on CUDA tensors, the plain
    version on CPU tensors or where the caller asks for it; ``reference``
    launches F1's design before (no path asks for it)."""
    if plain or dists.device.type == "cpu":
        integrate_dense_plain(cfg, vol, dists, vol2cam, intr, ok)
        return
    rt = torch.cat([(vol2cam[:3, :3] * cfg.voxel_size).reshape(-1), vol2cam[:3, 3]]).contiguous()
    kernels.integrate_dense(
        vol.tsdf, vol.weight, dists.contiguous(), rt, ok, intr,
        trunc=volume_model.trunc_dist(cfg), max_weight=float(cfg.tsdf_max_weight), reference=reference,
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


REFINES = ("secant", "newton8", "newton16", "hybrid16")


def _refine_mode(cfg: DynamicFusionConfig) -> int:
    """Kernel C's refine code of ``cfg.raycast_refine``: 0 secant, 1
    newton8, 2 newton16 (the Newton refines take that many steps), 3
    hybrid16."""
    if cfg.raycast_refine not in REFINES:
        raise ValueError(f"raycast_refine {cfg.raycast_refine!r}: expected one of {REFINES}")
    return REFINES.index(cfg.raycast_refine)


def gradient(
    tsdf: torch.Tensor, p_voxels: torch.Tensor, delta_voxels, x_off: int = 0, d: Optional[int] = None
) -> torch.Tensor:
    """Central-difference TSDF gradient (unnormalized) at fractional voxel
    coords (..., 3): trilinear samples at +-``delta_voxels[axis]`` voxels
    along each axis, NaN outside (JAX ops/tsdf.py:152 ``gradient``)."""
    comps = []
    for axis in range(3):
        e = device_mod.const(
            tuple(float(delta_voxels[axis]) if a == axis else 0.0 for a in range(3)), torch.float32, p_voxels.device
        )
        comps.append(interpolate(tsdf, p_voxels + e, x_off, d) - interpolate(tsdf, p_voxels - e, x_off, d))
    return torch.stack(comps, dim=-1)


def _grad6(tsdf: torch.Tensor, p_voxels: torch.Tensor, delta: float, x_off: int = 0, d: Optional[int] = None):
    """The reference's six-sample central difference at +-delta voxels on
    every axis (JAX ops/tsdf.py:610 ``_grad6``)."""
    return gradient(tsdf, p_voxels, (delta,) * 3, x_off, d)


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
    sample is > 0.99) and the refine of ``cfg.raycast_refine``:
    "secant" (secant between trilinear values at the bracket ends, then a
    Newton polish); "newton8"/"newton16" (secant from the march's
    nearest-fetched bracket values f0/f1, then one/two clamped Newton steps,
    each from a fused value + gradient fetch; the normal is the last
    fetch's gradient, at that step's start point); "hybrid16" (a fused
    fetch at the f0/f1 secant point, a march-slope step clipped to +-dt, a
    second fused fetch there, then a step along the two-point secant slope
    or, where it is healthy, the local gradient, clamped). With
    ``raycast_smooth_normals`` the normal is the six-sample central
    difference at the vertex, and the secant refine keeps its secant point
    (no polish), as JAX does. Returns (found, vertex_vol, normal_vol) in the
    volume frame; the normal is unnormalized."""
    found, _, vertex, normal, _ = _march_core(cfg, tsdf, ray_org, dirs, tmin, tmax, cfg.raycast_adaptive_step)
    return found, vertex, normal


def march_slab_plain(
    cfg: DynamicFusionConfig,
    ext: torch.Tensor,
    x_off: int,
    ray_org: torch.Tensor,
    dirs: torch.Tensor,
    tmin: torch.Tensor,
    tmax: torch.Tensor,
):
    """The plain version of kernel C's slab mode: the fixed-step march and
    refine of ``march_and_refine_plain`` over an extended slab ``ext``
    ((dx, D, D) codes, its first plane the global x-plane ``x_off``; every
    fetch clipped globally first, then into the slab). Returns (found, ts,
    vertex_vol, normal_vol, t_behind): the refined ray distance and the
    bracket start of the first exit-geometry event (+inf where none), the
    ownership inputs of the sharded raycast (JAX ``ops/tsdf.py:386-470``)."""
    return _march_core(cfg, ext, ray_org, dirs, tmin, tmax, False, x_off, cfg.volume_dims)


def _march_core(cfg, tsdf, ray_org, dirs, tmin, tmax, adaptive: bool, x_off: int = 0, d: Optional[int] = None):
    """The raycast core over a volume or, with ``d``, a slab of one: (found,
    ts, vertex_vol, normal_vol, t_behind)."""
    refine = _refine_mode(cfg)
    inv_vs = 1.0 / cfg.voxel_size
    step = volume_model.trunc_dist(cfg) * cfg.raycast_step_factor

    def point(t):
        return (ray_org + dirs * t[..., None]) * inv_vs

    def fetch(t):
        return fetch_nearest(tsdf, point(t), x_off, d)

    def interp_grad(t):
        return interpolate_with_gradient(tsdf, point(t), x_off, d)

    t = tmin
    done = tmin >= tmax
    found = torch.zeros_like(done)
    t_hit = torch.zeros_like(tmin)
    dt_hit = torch.full_like(tmin, step)
    t_behind = torch.full_like(tmin, INF)
    f0 = torch.ones_like(tmin)
    f1 = -torch.ones_like(tmin)
    tsdf_prev = fetch(tmin)
    for i in range(march_steps(cfg)):
        if i % 2 == 0 and bool(done.all()):
            break
        if adaptive:
            dt = torch.where(tsdf_prev > 0.99, 2.0 * step, step)
        else:
            dt = torch.full_like(tsdf_prev, step)
        tnext = t + dt
        active = ~done & (t < tmax)
        tsdf_next = fetch(tnext)
        crossing = (tsdf_prev > 0.0) & (tsdf_next < 0.0) & active
        behind = (tsdf_prev < 0.0) & (tsdf_next > 0.0) & active
        t_hit = torch.where(crossing, t, t_hit)
        dt_hit = torch.where(crossing, dt, dt_hit)
        t_behind = torch.where(behind, t, t_behind)
        if refine:
            f0 = torch.where(crossing, tsdf_prev, f0)
            f1 = torch.where(crossing, tsdf_next, f1)
        t = torch.where(active, tnext, t)
        done = done | crossing | behind | (tnext >= tmax)
        found = found | crossing
        tsdf_prev = torch.where(active, tsdf_next, tsdf_prev)

    def newton(ts, f_v, grad):
        """One Newton step from ts with a fused fetch there, kept where it
        is finite and shorter than the bracket."""
        dfdt = _dot3(grad, dirs) * inv_vs
        ts2 = ts - f_v / torch.where(torch.abs(dfdt) > 1e-12, dfdt, 1e-12)
        good2 = torch.isfinite(ts2) & (torch.abs(ts2 - ts) < dt_hit) & ~torch.isnan(f_v)
        return torch.where(good2, ts2, ts)

    if refine in (1, 2):
        denom0 = f0 - f1
        alpha = torch.clamp(f0 / torch.where(torch.abs(denom0) > 1e-12, denom0, 1e-12), 0.0, 1.0)
        ts = t_hit + dt_hit * alpha
        for _ in range(refine):
            f_v, normal_vol = interp_grad(ts)
            ts = newton(ts, f_v, normal_vol)
    elif refine == 3:
        slope_march = torch.clamp((f1 - f0) / dt_hit, max=-1e-6)
        d0 = f0 - f1
        alpha0 = torch.clamp(f0 / torch.where(torch.abs(d0) > 1e-12, d0, 1e-12), 0.0, 1.0)
        t_m = t_hit + dt_hit * alpha0
        f_m0 = torch.nan_to_num(interp_grad(t_m)[0])
        t_c = t_m + torch.minimum(torch.maximum(-f_m0 / slope_march, -dt_hit), dt_hit)
        f_c, normal_vol = interp_grad(t_c)
        f_c0 = torch.nan_to_num(f_c)
        dt_sec = t_c - t_m
        slope_sec = torch.where(torch.abs(dt_sec) > 1e-6 * dt_hit, (f_c0 - f_m0) / dt_sec, slope_march)
        slope_sec = torch.clamp(slope_sec, max=-1e-6)
        dfdt = _dot3(normal_vol, dirs) * inv_vs
        use_local = torch.abs(dfdt) > 0.25 * torch.abs(slope_sec)
        ts = t_c - f_c0 / torch.where(use_local & (dfdt < -1e-12), dfdt, slope_sec)
        good2 = torch.isfinite(ts) & (torch.abs(ts - t_c) < dt_hit) & ~torch.isnan(f_c)
        ts = torch.where(good2, ts, t_c)
    else:
        ft = interpolate(tsdf, point(t_hit), x_off, d)
        ftdt = interpolate(tsdf, point(t_hit + dt_hit), x_off, d)
        denom = ftdt - ft
        ts = t_hit - dt_hit * ft / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
        ts = torch.where(torch.isnan(ft) | torch.isnan(ftdt), t_hit, ts)
        if not cfg.raycast_smooth_normals:
            f_v, normal_vol = interp_grad(ts)
            ts = newton(ts, f_v, normal_vol)
    if cfg.raycast_smooth_normals:
        normal_vol = _grad6(tsdf, point(ts), cfg.gradient_delta_factor, x_off, d)
    return found, ts, ray_org + dirs * ts[..., None], normal_vol, t_behind


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
        smooth=cfg.raycast_smooth_normals,
        delta=cfg.gradient_delta_factor,
    )


def march_slab(
    cfg: DynamicFusionConfig,
    ext: torch.Tensor,
    x_off: int,
    ray_org: torch.Tensor,
    dirs: torch.Tensor,
    tmin: torch.Tensor,
    tmax: torch.Tensor,
    plain: bool = False,
):
    """Kernel C's slab mode on CUDA tensors (``march_slab_plain`` on CPU
    tensors or where the caller asks): (found, ts, vertex_vol, normal_vol,
    t_behind) of a fixed-step march over the extended slab ``ext``."""
    if plain or ext.device.type == "cpu":
        return march_slab_plain(cfg, ext, x_off, ray_org, dirs, tmin, tmax)
    return kernels.march_and_refine(
        ext, ray_org, dirs, tmin, tmax,
        voxel_size=cfg.voxel_size,
        step=volume_model.trunc_dist(cfg) * cfg.raycast_step_factor,
        max_steps=march_steps(cfg),
        adaptive=False,
        refine=_refine_mode(cfg),
        smooth=cfg.raycast_smooth_normals,
        delta=cfg.gradient_delta_factor,
        x_off=x_off,
        d=cfg.volume_dims,
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
    reference: bool = False,
) -> ExtractedCloud:
    """Zero-crossing surface cloud in world coordinates: for each voxel and
    its +x/+y/+z neighbour, both observed (weight >= min_weight) with a
    sign change, the linearly interpolated crossing. Static-size
    compaction in the JAX order (axis-major, then x-major voxel order);
    ``count`` is the uncapped total. Kernel L (``csrc/extract.cu``; its
    reference mode with ``reference``) on CUDA tensors, the plain version
    on CPU tensors or where the caller asks."""
    mw = cfg.extract_min_weight if min_weight is None else min_weight
    if plain or vol.tsdf.device.type == "cpu":
        return extract_cloud_plain(cfg, vol, max_points, mw)
    return ExtractedCloud(*kernels.extract_cloud(
        vol.tsdf, vol.weight, mw, max_points, cfg.voxel_size, tuple(float(v) for v in cfg.volume_origin),
        reference=reference,
    ))


def extract_normals_plain(cfg: DynamicFusionConfig, vol: TsdfVolume, points_world: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel R: the six-sample gradient at each point,
    divided by max(|g|, 1e-12). The coordinates are divided by a tensor
    (PyTorch on CUDA multiplies by the reciprocal of a Python scalar). The
    norm is the JAX package's ``jnp.linalg.norm`` to the bit: XLA (jitted
    or op by op) takes the sum of squares as the fused multiply-adds
    fma(z, z, fma(y, y, x x)), each here the float64 sum of an exact
    product rounded once more (see ``warpfield._fma``); the square root is
    taken in float64 and rounded, the correctly rounded float32 root that
    XLA and CUDA's ``sqrtf`` give (CPU PyTorch's float32 ``sqrt`` is off by
    an ulp on some inputs)."""
    dev = points_world.device
    vs = device_mod.const((cfg.voxel_size,), torch.float32, dev)
    p_vox = (points_world - volume_model.origin(cfg, dev)) / vs
    g = _grad6(vol.tsdf, p_vox, cfg.gradient_delta_factor)
    gx, gy, gz = g.double().unbind(-1)
    ss = (gy * gy + (g[..., 0] * g[..., 0]).double()).float()
    ss = (gz * gz + ss.double()).float()
    norm = torch.sqrt(ss.double()).float()
    return g / torch.clamp(norm, min=1e-12)[..., None]


def extract_normals(
    cfg: DynamicFusionConfig, vol: TsdfVolume, points_world: torch.Tensor, plain: bool = False
) -> torch.Tensor:
    """Unit normals at world-frame points (N, 3), e.g. ``extract_cloud``'s
    rows: the trilinear TSDF gradient's six-sample central difference at
    +-``cfg.gradient_delta_factor`` voxels, normalized; NaN where a point
    is NaN or a sample leaves the volume. Kernel R (``csrc/normals.cu``) on
    CUDA tensors, the plain version on CPU tensors or where the caller
    asks."""
    if plain or points_world.device.type == "cpu":
        return extract_normals_plain(cfg, vol, points_world)
    return kernels.extract_normals(
        vol.tsdf, points_world.contiguous(), cfg.voxel_size, tuple(float(v) for v in cfg.volume_origin),
        cfg.gradient_delta_factor,
    )
