"""Brick-sparse TSDF integration (port of ``dynamicfusion_tpu.ops.bricks``).

Each 16^3 brick is classified from a coarse camera-frame grid of its
corners and a min/max depth pyramid as skip, front (free space: constant
update), band (straddles the truncation band: per-voxel depth lookup) or
wide (footprint larger than the band window). The pyramid, the
classification and the capped, prioritized selection of band bricks are
CUDA kernel K (``csrc/classify.cu``) on CUDA tensors; the plain version
runs as PyTorch with static shapes: ``_plan`` ranks bricks with cumulative
sums and compacts them into one work list with a scatter. Either way the
count of real entries stays a device tensor and no step syncs with the
host.

The fuse itself is CUDA kernel D (``csrc/fuse_bricks.cu``) on CUDA
tensors: a persistent grid walking the listed bricks, IN PLACE on the (D,
D, D) volume, voxel addresses computed from the brick id (no brick-major
transposes), band depths fetched directly from the lookup image. Where the JAX package
selects from a window with one-hot matmuls, a direct load returns the same
value. The plain version (``_fuse_plain``) does the same arithmetic with
gathers and scatters for CPU tensors.

The non-rigid fusion adds three inputs: a per-grid-point observation
weight (the warp's blend quality) prolonged to the voxels like their
positions, a per-pixel incidence confidence packed with the depth into
one float (``pack_depth_conf``: the depth a voxel sees is quantized to
0.25 mm, the confidence to 16 levels, as in the JAX package), and a phase
split of the brick x-planes.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dynamicfusion_tpu_torch import device as device_mod, kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig, Intrinsics
from dynamicfusion_tpu_torch.models import volume as volume_model
from dynamicfusion_tpu_torch.models.volume import TsdfVolume

_ZEPS = 1e-3  # meters; bricks not strictly in front of the camera -> band

SKIP, FRONT, BAND, WIDE = 0, 1, 2, 3
INF = float("inf")


@functools.lru_cache(maxsize=8)
def _brick_perm(nbr: int) -> np.ndarray:
    """Fixed fair permutation of brick ids for band-cap overflow (the JAX
    package's RandomState(1) permutation)."""
    return np.random.RandomState(1).permutation(nbr).astype(np.int64)


@functools.lru_cache(maxsize=8)
def _brick_perm_on(nbr: int, device: torch.device) -> torch.Tensor:
    """``_brick_perm`` on the device, copied once (a copy from pageable
    host memory waits for the device)."""
    return torch.from_numpy(_brick_perm(nbr)).to(device)


# --------------------------------------------------------------------------
# conservative depth min/max pyramid
# --------------------------------------------------------------------------


class DepthPyramid(NamedTuple):
    dmin: torch.Tensor        # (T,) concatenated levels; +inf where no valid depth
    dmax: torch.Tensor        # (T,) -inf where no valid depth
    allvalid: torch.Tensor    # (T,) 1.0 iff every covered pixel is valid
    offsets: Tuple[int, ...]  # per-level start index
    widths: Tuple[int, ...]   # per-level row width
    levels: int


def _pool2(a: torch.Tensor, fill: float, reduce_min: bool) -> torch.Tensor:
    h, w = a.shape
    a = F.pad(a, (0, (-w) % 2, 0, (-h) % 2), value=fill)
    a = a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2)
    return a.amin(dim=(1, 3)) if reduce_min else a.amax(dim=(1, 3))


def build_depth_pyramid(dists: torch.Tensor, levels: int) -> DepthPyramid:
    """Min/max/all-valid mip pyramid of the dists image (0 = invalid);
    level l has cells of 2^l pixels, out-of-image area is neutral."""
    valid = dists > 0.0
    dmin = torch.where(valid, dists, INF)
    dmax = torch.where(valid, dists, -INF)
    av = valid.to(torch.float32)
    mins, maxs, avs, offsets, widths = [], [], [], [], []
    off = 0
    for lvl in range(levels):
        h, w = dmin.shape
        offsets.append(off)
        widths.append(w)
        mins.append(dmin.reshape(-1))
        maxs.append(dmax.reshape(-1))
        avs.append(av.reshape(-1))
        off += h * w
        if lvl + 1 < levels:
            dmin = _pool2(dmin, INF, True)
            dmax = _pool2(dmax, -INF, False)
            av = _pool2(av, 0.0, True)
    return DepthPyramid(
        dmin=torch.cat(mins), dmax=torch.cat(maxs), allvalid=torch.cat(avs),
        offsets=tuple(offsets), widths=tuple(widths), levels=levels,
    )


def query_rect(pyr: DepthPyramid, u0, u1, v0, v1, ncells: int = 4):
    """Conservative (dmin, dmax, allvalid) over the pixel rect
    [u0,u1]x[v0,v1] (float bounds clipped to the image), from up to
    ncells x ncells cells of the finest mip level whose cells cover it."""
    dev = u0.device
    ext = torch.maximum(u1 - u0, v1 - v0)
    # log(x)/log(2), as jnp.log2 computes it: the level choice must agree
    # a true division (by a tensor: CUDA PyTorch multiplies by the
    # reciprocal of a Python scalar), as kernel K and the JAX package divide
    x = torch.clamp(ext, min=1.0) / torch.full((), float(ncells - 1), device=dev)
    lvl = torch.ceil(torch.log(x) / torch.log(torch.full((), 2.0, device=dev)))
    lvl = lvl.clamp(0, pyr.levels - 1).to(torch.int64)
    cell = torch.exp2(lvl.to(torch.float32))
    offs = device_mod.const(pyr.offsets, torch.int64, dev)[lvl]
    wids = device_mod.const(pyr.widths, torch.int64, dev)[lvl]
    i0 = torch.floor(u0 / cell).to(torch.int64)
    j0 = torch.floor(v0 / cell).to(torch.int64)
    i1 = torch.floor(u1 / cell).to(torch.int64)
    j1 = torch.floor(v1 / cell).to(torch.int64)
    n = pyr.dmin.shape[0]
    dmin = torch.full(u0.shape, INF, device=dev)
    dmax = torch.full(u0.shape, -INF, device=dev)
    av = torch.ones(u0.shape, device=dev)
    for dj in range(ncells):
        for di in range(ncells):
            keep = ((i0 + di) <= i1) & ((j0 + dj) <= j1)
            flat = (offs + (j0 + dj) * wids + (i0 + di)).clamp(0, n - 1)
            dmin = torch.minimum(dmin, torch.where(keep, pyr.dmin[flat], INF))
            dmax = torch.maximum(dmax, torch.where(keep, pyr.dmax[flat], -INF))
            av = torch.minimum(av, torch.where(keep, pyr.allvalid[flat], 1.0))
    return dmin, dmax, av


# --------------------------------------------------------------------------
# classification
# --------------------------------------------------------------------------


class BrickClasses(NamedTuple):
    cls: torch.Tensor   # (NBR,) int64: SKIP / FRONT / BAND / WIDE
    u0: torch.Tensor    # (NBR,) int32 band-window origin column
    v0: torch.Tensor    # (NBR,) int32 band-window origin row
    surf: torch.Tensor  # (NBR,) bool: depth range meets the brick's ray-distance range


def classify(
    cfg: DynamicFusionConfig,
    cam_grid: torch.Tensor,  # (G, G, G, 3) camera-frame grid points at voxel stride g
    g: int,
    pyr: DepthPyramid,
    intr: Intrinsics,
    rows: int,
    cols: int,
    rect: int,
) -> BrickClasses:
    b = cfg.brick_size
    trunc = volume_model.trunc_dist(cfg)
    w = b // g  # grid points per brick per axis: window w+1, stride w

    x, y, z = cam_grid[..., 0], cam_grid[..., 1], cam_grid[..., 2]
    zok = z > _ZEPS
    zs = torch.where(zok, z, 1.0)
    u = x * intr.fx / zs + intr.cx
    v = y * intr.fy / zs + intr.cy
    r = torch.sqrt(x * x + y * y + z * z)

    def bmax(a):
        return F.max_pool3d(a[None, None], w + 1, w)[0, 0].reshape(-1)

    def bmin(a):
        return -bmax(-a)

    umin, umax = bmin(torch.where(zok, u, INF)), bmax(torch.where(zok, u, -INF))
    vmin, vmax = bmin(torch.where(zok, v, INF)), bmax(torch.where(zok, v, -INF))
    zmin, zmax = bmin(z), bmax(z)
    rmax = bmax(r)
    # lower bound on |p|: distance from the camera to the AABB of the grid points
    xmin, xmax = bmin(x), bmax(x)
    ymin, ymax = bmin(y), bmax(y)
    dx = torch.clamp(torch.maximum(xmin, -xmax), min=0.0)
    dy = torch.clamp(torch.maximum(ymin, -ymax), min=0.0)
    dz = torch.clamp(torch.maximum(zmin, -zmax), min=0.0)
    rmin = torch.sqrt(dx * dx + dy * dy + dz * dz)

    zfront = zmin > _ZEPS
    cu0 = umin.clamp(0.0, cols - 1.0)
    cu1 = umax.clamp(0.0, cols - 1.0)
    cv0 = vmin.clamp(0.0, rows - 1.0)
    cv1 = vmax.clamp(0.0, rows - 1.0)
    dminv, dmaxv, allvalid = query_rect(pyr, cu0, cu1, cv0, cv1)

    visible = (
        (zmax > _ZEPS) & (umax >= 0.0) & (umin <= cols - 1.0)
        & (vmax >= 0.0) & (vmin <= rows - 1.0)
    )
    no_band = dmaxv < rmin - trunc
    inside = (umin >= 0.0) & (umax <= cols - 1.0) & (vmin >= 0.0) & (vmax <= rows - 1.0)
    is_front = inside & (allvalid > 0.5) & (dminv > rmax + trunc) & zfront
    narrow = ((umax - umin) <= rect - 2) & ((vmax - vmin) <= rect - 2) & zfront
    cls = torch.where(
        ~visible | (zfront & no_band),
        SKIP,
        torch.where(is_front, FRONT, torch.where(narrow, BAND, WIDE)),
    )
    u0 = torch.floor(umin).clamp(0, max(cols - rect, 0)).to(torch.int32)
    v0 = torch.floor(vmin).clamp(0, max(rows - rect, 0)).to(torch.int32)
    surf = (dmaxv + trunc >= rmin) & (dminv - trunc <= rmax)
    return BrickClasses(cls=cls, u0=u0, v0=v0, surf=surf)


# --------------------------------------------------------------------------
# work list: capped, prioritized, compacted with static shapes
# --------------------------------------------------------------------------


class WorkList(NamedTuple):
    ids: torch.Tensor     # (NBR,) int32 brick ids: front, then band, then wide; NBR fill
    kind: torch.Tensor    # (NBR,) int32 FRONT / BAND / WIDE per slot
    count: torch.Tensor   # (1,) int32 number of real slots
    counts: torch.Tensor  # (3,) int32 (band, wide, dropped)


def _rank(mask: torch.Tensor) -> torch.Tensor:
    """Position of each set entry among the set entries (exclusive scan)."""
    return torch.cumsum(mask.to(torch.int64), 0) - 1


def _plan(bc: BrickClasses, band_cap: int, wide_cap: int) -> WorkList:
    """Every front brick; band bricks up to ``band_cap`` with surface
    bricks first (x-major order) and the rest in ``_brick_perm`` order;
    wide bricks up to ``wide_cap`` in x-major order."""
    nbr = bc.cls.shape[0]
    dev = bc.cls.device
    front = bc.cls == FRONT
    band = bc.cls == BAND
    wide = bc.cls == WIDE
    hi = band & bc.surf
    perm = _brick_perm_on(nbr, dev)
    lo_p = (band & ~bc.surf)[perm]

    n_front = front.sum()
    n_hi = torch.clamp(hi.sum(), max=band_cap)
    n_band = band.sum()
    n_band_sel = torch.clamp(n_band, max=band_cap)
    n_wide = wide.sum()

    rank_hi = _rank(hi)
    slot_lo = n_hi + _rank(lo_p)
    rank_w = _rank(wide)
    dump = torch.full((nbr,), nbr, dtype=torch.int64, device=dev)
    pos_front = torch.where(front, _rank(front), dump)
    pos_hi = torch.where(hi & (rank_hi < band_cap), n_front + rank_hi, dump)
    pos_lo = torch.where(lo_p & (slot_lo < band_cap), n_front + slot_lo, dump)
    pos_w = torch.where(wide & (rank_w < wide_cap), n_front + n_band_sel + rank_w, dump)

    brick = torch.arange(nbr, dtype=torch.int32, device=dev)
    ids = torch.full((nbr + 1,), nbr, dtype=torch.int32, device=dev)
    kind = torch.zeros((nbr + 1,), dtype=torch.int32, device=dev)
    for pos, who, k in (
        (pos_front, brick, FRONT), (pos_hi, brick, BAND),
        (pos_lo, perm.to(torch.int32), BAND), (pos_w, brick, WIDE),
    ):
        ids.index_put_((pos,), who)
        kind.index_put_((pos,), torch.full_like(who, k))
    count = (n_front + n_band_sel + torch.clamp(n_wide, max=wide_cap)).to(torch.int32)
    dropped = torch.clamp(n_band - band_cap, min=0) + torch.clamp(n_wide - wide_cap, min=0)
    counts = torch.stack([n_band, n_wide, dropped]).to(torch.int32)
    return WorkList(ids=ids[:nbr], kind=kind[:nbr], count=count.reshape(1), counts=counts)


# --------------------------------------------------------------------------
# per-voxel math shared by the plain path (and mirrored by kernel D)
# --------------------------------------------------------------------------


def _prolong_weights(b: int, g: int, device=None) -> torch.Tensor:
    """(B, B/g + 1) trilinear prolongation weights from a brick's grid
    points to its voxels."""
    o = torch.arange(b, device=device)
    c = o // g
    f = (o % g).to(torch.float32) / g
    w = torch.zeros((b, b // g + 1), dtype=torch.float32, device=device)
    w[o, c] = 1.0 - f
    w[o, c + 1] += f
    return w


def _corner_indices(d: int, b: int, g: int, brick_ids: torch.Tensor) -> torch.Tensor:
    """Flat (G^3,) grid indices of each brick's (B/g+1)^3 grid points. With
    a slab's local ids the indices are into the slab's corner grid
    (``corner_slab``): the y and z strides are the whole grid's (JAX
    ``parallel/sharded_fusion.py:64`` ``_corner_indices_slab``)."""
    nb = d // b
    gpts = d // g + 1
    w = b // g
    bi = brick_ids // (nb * nb)
    bj = (brick_ids // nb) % nb
    bk = brick_ids % nb
    a = torch.arange(w + 1, device=brick_ids.device)
    ii = bi[:, None] * w + a[None, :]
    jj = bj[:, None] * w + a[None, :]
    kk = bk[:, None] * w + a[None, :]
    return ((ii[:, :, None, None] * gpts + jj[:, None, :, None]) * gpts
            + kk[:, None, None, :]).reshape(brick_ids.shape[0], -1)


def corner_slab(grid: torch.Tensor, k: int, n: int, b: int, g: int) -> torch.Tensor:
    """Shard ``k`` of ``n``'s x-slab of a (G, G, G, ...) corner grid: the
    corners of its D/n/b brick planes plus the +1 overlap plane that its
    last bricks share with the next shard (JAX ``sharded_fusion.py:122-128``);
    a view."""
    w = b // g
    nb_loc = (grid.shape[0] - 1) // w // n
    return grid[k * nb_loc * w: (k + 1) * nb_loc * w + 1]


def _voxel_positions(cam_flat: torch.Tensor, corner_idx: torch.Tensor, b: int, g: int) -> torch.Tensor:
    """(K, B^3, CH) voxel camera positions (and any extra channel, the
    blend quality) by separable trilinear prolongation of the grid points,
    contracting x, then y, then z, each as the ordered sum over grid points
    that kernel D computes."""
    c = b // g + 1
    k = corner_idx.shape[0]
    ch = cam_flat.shape[-1]
    pts = cam_flat[corner_idx].reshape(k, c, c, c, ch)
    w = _prolong_weights(b, g, cam_flat.device)  # (B, C)

    def contract(t, axis):
        # sum_a w[i, a] * t[..., a, ...] along `axis`, a in order
        acc = None
        for a in range(c):
            term = t.select(axis, a).unsqueeze(axis) * w[:, a].reshape(
                [b if i == axis else 1 for i in range(t.dim())]
            )
            acc = term if acc is None else acc + term
        return acc

    f = contract(pts, 1)
    f = contract(f, 2)
    f = contract(f, 3)
    return f.reshape(k, b * b * b, ch)


def _project(cam_pts: torch.Tensor, intr: Intrinsics, rows: int, cols: int):
    """(..., 3) camera points -> (u_idx, v_idx, inb, rdist)."""
    x, y, z = cam_pts[..., 0], cam_pts[..., 1], cam_pts[..., 2]
    zs = torch.where(z > 0, z, 1.0)
    u = x * intr.fx / zs + intr.cx
    v = y * intr.fy / zs + intr.cy
    inb = (z > 0) & (u >= 0) & (v >= 0) & (u < cols) & (v < rows)
    ui = torch.floor(u).clamp(0, cols - 1).to(torch.int64)
    vi = torch.floor(v).clamp(0, rows - 1).to(torch.int64)
    rdist = torch.sqrt(x * x + y * y + z * z)
    return ui, vi, inb, rdist


PACK_DP = 4000.0  # 0.25 mm depth quantization in the packed image
PACK_C = 16.0     # confidence levels
# float32 reciprocals (exact in float32, so the Python scalars multiply as is)
_INV_C = float(np.float32(1.0) / np.float32(PACK_C - 1.0))
_INV_DP = float(np.float32(1.0) / np.float32(PACK_DP))


def pack_depth_conf(dists: torch.Tensor, conf: torch.Tensor) -> torch.Tensor:
    """(depth m, confidence [0, 1]) -> one float holding an exact integer:
    round(d * 4000) * 16 + round(c * 15); invalid pixels (d == 0) -> 0."""
    dq = torch.round(dists * PACK_DP)
    cq = torch.round(torch.clamp(torch.nan_to_num(conf), 0.0, 1.0) * (PACK_C - 1.0))
    return torch.where(dists > 0.0, dq * PACK_C + cq, 0.0)


def unpack_depth_conf(v: torch.Tensor):
    """The packed image's (depth m, confidence [0, 1]). The divisions by
    the constants are products with their float32 reciprocals, as XLA
    compiles the JAX package's jitted ``unpack_depth_conf`` (and kernels D
    and F2 multiply); 1/16 is exact."""
    dq = torch.floor(v * (1.0 / PACK_C))
    c = (v - dq * PACK_C) * _INV_C
    return dq * _INV_DP, c


def incidence_weight_scale(cfg: DynamicFusionConfig, conf: Optional[torch.Tensor]):
    """(observation weight, stored-SDF scale) from the raw per-pixel
    |cos incidence| (0 = invalid): weight max(cos, floor) on observed
    pixels, scale clip(cos, 0.25, 1) with ``fusion_sdf_incidence_scale``."""
    if conf is None:
        return 1.0, 1.0
    w = torch.where(conf > 0.0, torch.clamp(conf, min=cfg.fusion_incidence_floor), 0.0)
    if cfg.fusion_sdf_incidence_scale:
        scale = torch.where(conf > 0.0, torch.clamp(conf, 0.25, 1.0), 1.0)
    else:
        scale = 1.0
    return w, scale


def _fuse_rows(cfg: DynamicFusionConfig, tsdf_rows, w_rows, dp, rdist, inb, q=None, conf=None):
    """Band/wide voxel update: the running average of
    min(1, psdf * scale / trunc) with observation weight q * incidence
    weight where psdf >= -trunc (and, with q, where q > fusion_quality_min)."""
    trunc = volume_model.trunc_dist(cfg)
    psdf = dp - rdist
    update = inb & (dp != 0.0) & (psdf >= -trunc)
    if q is None:
        q = 1.0
    else:
        update = update & (q > cfg.fusion_quality_min)
    obs_w, sdf_scale = incidence_weight_scale(cfg, conf)
    q = q * obs_w
    # a true division, as kernel D's (CUDA torch takes a division by a
    # Python scalar as a product with its reciprocal)
    tsdf_obs = torch.clamp(psdf * sdf_scale / torch.full((), trunc, device=psdf.device), max=1.0)
    t32 = volume_model.decode_tsdf(tsdf_rows)
    w32 = volume_model.decode_weight(w_rows)
    wq = w32 + q
    fused = (t32 * w32 + tsdf_obs * q) / torch.clamp(wq, min=1e-12)
    new_t = volume_model.encode_tsdf(torch.where(update & (wq > 1e-12), fused, t32), tsdf_rows.dtype)
    new_w = volume_model.encode_weight(
        torch.where(update, torch.clamp(wq, max=float(cfg.tsdf_max_weight)), w32), w_rows.dtype,
    )
    return new_t, new_w


def _fuse_front_rows(cfg: DynamicFusionConfig, ft, fw):
    """Front (free-space) brick update: tsdf_obs = 1, weight + 1."""
    t32 = volume_model.decode_tsdf(ft)
    w32 = volume_model.decode_weight(fw)
    new_ft = volume_model.encode_tsdf((t32 * w32 + 1.0) / (w32 + 1.0), ft.dtype)
    new_fw = volume_model.encode_weight(
        torch.clamp(w32 + 1.0, max=float(cfg.tsdf_max_weight)), fw.dtype
    )
    return new_ft, new_fw


def _voxel_addresses(d: int, b: int, brick_ids: torch.Tensor) -> torch.Tensor:
    """(K, B^3) flat (D, D, D) addresses of each brick's voxels, in-brick
    order ((oi * B) + oj) * B + ok; with a slab's local ids, addresses in
    the (dx, D, D) slab (the port fuses in place, so the brick-major
    transposes of JAX ``sharded_fusion.py:45-61`` have no counterpart)."""
    nb = d // b
    o = torch.arange(b, device=brick_ids.device)
    x = (brick_ids // (nb * nb))[:, None] * b + o[None, :]
    y = ((brick_ids // nb) % nb)[:, None] * b + o[None, :]
    z = (brick_ids % nb)[:, None] * b + o[None, :]
    return ((x[:, :, None, None] * d + y[:, None, :, None]) * d
            + z[:, None, None, :]).reshape(brick_ids.shape[0], -1)


def _fuse_plain(
    cfg: DynamicFusionConfig,
    vol: TsdfVolume,
    lookup: torch.Tensor,
    cam_grid: torch.Tensor,
    g: int,
    intr: Intrinsics,
    bc: BrickClasses,
    work: WorkList,
    ok: torch.Tensor,
    rect: int,
    q_grid: Optional[torch.Tensor] = None,
    packed: bool = False,
    chunk: int = 512,
) -> None:
    """The plain version of kernel D: gathers the listed bricks' voxels,
    fuses them and scatters them back in place. ``lookup`` is the dists
    image, or with ``packed`` the packed depth+confidence image. Reads the
    work count on the host. Selections on the weight run on its int16
    storage view (CUDA PyTorch has no ``where`` for uint16)."""
    d = cfg.volume_dims
    b = cfg.brick_size
    rows, cols = lookup.shape
    cam_flat = cam_grid.reshape(-1, 3)
    if q_grid is not None:
        cam_flat = torch.cat([cam_flat, q_grid.reshape(-1, 1)], dim=-1)
    t_flat = vol.tsdf.view(-1)
    w_flat = volume_model.storage_view(vol.weight).view(-1)
    sv = volume_model.storage_view
    n = int(work.count[0])
    for s in range(0, n, chunk):
        ids = work.ids[s : min(n, s + chunk)].to(torch.int64)
        kind = work.kind[s : min(n, s + chunk)][:, None]
        addr = _voxel_addresses(d, b, ids)
        t_old = t_flat[addr]
        w_old = w_flat[addr]
        w_old_u = w_old.view(vol.weight.dtype)
        ptsq = _voxel_positions(cam_flat, _corner_indices(d, b, g, ids), b, g)
        pts, qv = ptsq[..., :3], (ptsq[..., 3] if q_grid is not None else None)
        ui, vi, inb, rdist = _project(pts, intr, rows, cols)
        ri = (vi - bc.v0[ids][:, None]).clamp(0, rect - 1)
        ci = (ui - bc.u0[ids][:, None]).clamp(0, rect - 1)
        inw = (vi - bc.v0[ids][:, None] == ri) & (ui - bc.u0[ids][:, None] == ci)
        dp, cv = lookup[vi, ui], None
        if packed:
            dp, cv = unpack_depth_conf(dp)
        new_t, new_w = _fuse_rows(cfg, t_old, w_old_u, dp, rdist, inb & (inw | (kind == WIDE)), qv, cv)
        front_t, front_w = _fuse_front_rows(cfg, t_old, w_old_u)
        is_front = (kind == FRONT) & ok
        t_flat[addr] = torch.where(is_front, front_t, torch.where(ok, new_t, t_old))
        w_flat[addr] = torch.where(is_front, sv(front_w), torch.where(ok, sv(new_w), w_old))


class BrickPlan(NamedTuple):
    """A plan's classes and work list. Where it was made with the device
    flag ``ok`` False, only ``work.count`` (0) and ``work.counts`` (0, 0,
    0) hold values: kernel K leaves the classes, windows, surface flags
    and list entries unset, and the fusion reads none of them."""

    classes: BrickClasses
    work: WorkList
    rect: int  # band window side, pixels


def plan(
    cfg: DynamicFusionConfig, dists: torch.Tensor, cam_grid: torch.Tensor, g: int, intr: Intrinsics,
    phase: Optional[torch.Tensor] = None, split: int = 1, plain: bool = False, ok: Optional[torch.Tensor] = None,
    reference: bool = False,
) -> BrickPlan:
    """Classify every brick against the dists image and list the ones to
    fuse (``_plan``), all on the device: kernel K on CUDA tensors, the
    plain version on CPU tensors or where the caller asks for it. With
    ``split`` > 1 only bricks whose x-plane index is ``phase`` (a device
    tensor) modulo ``split`` take part, and the caps divide by ``split``.
    Where the device flag ``ok`` is False the list is empty (count 0,
    counts (0, 0, 0)) and kernel K classifies nothing: its classes and
    list entries are then unset. ``reference`` launches K's reference mode
    (one block after the mip tiles); no path of the port asks for it."""
    d, b = cfg.volume_dims, cfg.brick_size
    nbr = (d // b) ** 3
    band_cap = min(max(cfg.integrate_band_cap // split, 1), nbr)
    wide_cap = min(max(cfg.integrate_wide_cap // split, 1), nbr)
    return plan_slab(cfg, dists, cam_grid, g, intr, 0, band_cap, wide_cap, phase, split, plain, ok, reference)


def plan_slab(
    cfg: DynamicFusionConfig, dists: torch.Tensor, cam_grid: torch.Tensor, g: int, intr: Intrinsics,
    x_brick0: int, band_cap: int, wide_cap: int, phase: Optional[torch.Tensor] = None, split: int = 1,
    plain: bool = False, ok: Optional[torch.Tensor] = None, reference: bool = False,
) -> BrickPlan:
    """``plan`` over the bricks of an x-slab of the corner grid: ``cam_grid``
    (nbx w + 1, G, G, 3), its first brick x-plane the global plane
    ``x_brick0`` (the phase split's), local brick ids ((bi nb) + bj) nb +
    bk, with the given caps (the whole volume is ``x_brick0`` 0)."""
    b = cfg.brick_size
    w = b // g
    nb = (cam_grid.shape[1] - 1) // w
    nbr = ((cam_grid.shape[0] - 1) // w) * nb * nb
    rows, cols = dists.shape
    rect = min(cfg.integrate_rect, 1 << int(math.log2(min(rows, cols))))
    levels = int(math.ceil(math.log2(max(rows, cols)))) + 1
    if not (plain or dists.device.type == "cpu"):
        _, (cls, u0, v0, surf), (ids, kind, count, counts) = kernels.brick_plan(
            dists, cam_grid, b, g, intr, rect, volume_model.trunc_dist(cfg), _ZEPS, levels,
            _brick_perm_on(nbr, dists.device), band_cap, wide_cap,
            phase=None if split == 1 else phase.to(torch.int32).reshape(()), split=split, x_brick0=x_brick0,
            ok=ok, one_block=reference,
        )
        return BrickPlan(BrickClasses(cls, u0, v0, surf), WorkList(ids, kind, count, counts), rect)
    pyr = build_depth_pyramid(dists, levels)
    bc = classify(cfg, cam_grid, g, pyr, intr, rows, cols, rect)
    if split > 1:
        bx = x_brick0 + torch.arange(nbr, device=dists.device) // (nb * nb)
        bc = bc._replace(cls=torch.where((bx % split) == phase, bc.cls, SKIP))
    work = _plan(bc, band_cap, wide_cap)
    if ok is not None:
        work = work._replace(count=torch.where(ok, work.count, 0), counts=torch.where(ok, work.counts, 0))
    return BrickPlan(bc, work, rect)


def fuse(
    cfg: DynamicFusionConfig,
    vol: TsdfVolume,
    lookup: torch.Tensor,
    cam_grid: torch.Tensor,
    g: int,
    intr: Intrinsics,
    bp: BrickPlan,
    ok: torch.Tensor,
    q_grid: Optional[torch.Tensor] = None,
    packed: bool = False,
    plain: bool = False,
    reference: bool = False,
) -> None:
    """Fuse the planned bricks IN PLACE: kernel D on CUDA tensors, the
    plain version on CPU tensors or where the caller asks for it.
    ``lookup`` is the dists image, or with ``packed`` the
    ``pack_depth_conf`` image; ``q_grid`` the optional per-grid-point
    observation weight. ``reference`` launches D's reference mode (a
    block a slot); no path of the port asks for it."""
    if plain or lookup.device.type == "cpu":
        _fuse_plain(cfg, vol, lookup, cam_grid, g, intr, bp.classes, bp.work, ok, bp.rect, q_grid, packed)
        return
    kernels.fuse_bricks(
        vol.tsdf, vol.weight, lookup, cam_grid, bp.work.ids, bp.work.kind, bp.work.count, ok,
        bp.classes.u0, bp.classes.v0,
        brick=cfg.brick_size, stride=g, intr=intr, rect=bp.rect,
        trunc=volume_model.trunc_dist(cfg), max_weight=float(cfg.tsdf_max_weight),
        q_grid=q_grid, q_min=cfg.fusion_quality_min, packed=packed,
        incidence_floor=cfg.fusion_incidence_floor, sdf_scale=cfg.fusion_sdf_incidence_scale,
        reference=reference,
    )


def integrate_bricks(
    cfg: DynamicFusionConfig,
    vol: TsdfVolume,
    dists: torch.Tensor,
    cam_grid: torch.Tensor,
    g: int,
    intr: Intrinsics,
    ok: Optional[torch.Tensor] = None,
    q_grid: Optional[torch.Tensor] = None,
    conf: Optional[torch.Tensor] = None,
    phase: Optional[torch.Tensor] = None,
    split: int = 1,
    plain: bool = False,
) -> torch.Tensor:
    """Brick-sparse projective TSDF fusion, IN PLACE on ``vol``.
    ``cam_grid`` holds camera-frame positions of the voxel grid at stride
    ``g``; ``q_grid`` an optional (G, G, G) observation weight prolonged
    alongside them (band/wide voxels fuse with weight q and skip q <=
    fusion_quality_min; front bricks keep unit weight); ``conf`` an
    optional (H, W) incidence confidence. Bricks past the static caps keep
    their old values this frame. Returns the (3,) int32 (band, wide,
    dropped) counts, zero where the device flag ``ok`` is False (the whole
    update, the plan's classification included, is skipped then)."""
    if ok is None:
        ok = torch.ones((), dtype=torch.bool, device=dists.device)
    bp = plan(cfg, dists, cam_grid, g, intr, phase, split, plain, ok)
    lookup = dists if conf is None else pack_depth_conf(dists, conf)
    fuse(cfg, vol, lookup, cam_grid, g, intr, bp, ok, q_grid, conf is not None, plain)
    return torch.where(ok, bp.work.counts, 0)
