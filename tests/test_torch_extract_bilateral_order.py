"""The orders of kernels L and A's redesigns, transcribed in torch on the CPU.

Kernel L (``csrc/extract.cu``, the row listing) gives a warp a k-row (i,
j) of the volume and a lane d / 32 consecutive voxels of it; the row
holds the +x tests of axis 0's row (i, j), the +y tests of axis 1's and
axis 2's row, the +z test at a lane's last voxel taking its neighbour
from the next lane. Pass 1 keeps each row's crossing bits and counts
each block's crossings of each axis (``EXTRACT_ROWS`` rows a block); the
last block scans the three count arrays (a thread's contiguous segment of
blocks, a warp's shuffle scan, the warp totals) into each block's three
offsets, axis a's past the totals of the axes before it. Pass 2 ranks a
crossing by its block offset, the rounds before (a round is a row a
warp), the warps before, the lanes before and the bits before in its
lane, and writes the rows below max_points, then the flags and the NaN
rows past the count. ``row_listing``
transcribes that and is held equal to JAX's ``extract_cloud`` (points
within the existing 1e-6, flags and count exact) and bit-equal to the
port's ``extract_cloud_plain``, on ``test_torch_tsdf_bricks``'s volume
(64^3) at 1 << 16 and 700 rows and at a cap inside one block's run, and
bit-equal to the plain version on seeded 32^3 and 128^3 volumes and on
``chip_smoke.EXTRACT_CASES`` (edge codes and values, every storage kind).

Kernel A (``csrc/bilateral.cu``, the tiled filter) loads a block's tile
and halo into shared memory (a marker past the image), gives a thread
``PX`` consecutive pixels, and takes the spatial term from the host's
table. ``tiled_bilateral`` transcribes the tile and halo indexing, the
marker and the table and is held bit-equal to ``bilateral_filter_plain``
at 160x120 (a rendered frame with noise) and on ``chip_smoke.border_frame``
(depth edges and holes on all four borders), at 7x7 and 5x5; the table is
held entry by entry against numpy's float32(float64(dy^2 + dx^2) inv_sp).

The constants are read against the sources. One JAX compile."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import EXTRACT_CASES, border_frame, extract_case
from dynamicfusion_tpu.models.volume import TsdfVolume as JVol
from dynamicfusion_tpu.ops import tsdf as jtsdf
from dynamicfusion_tpu_torch import kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.io import synthetic
from dynamicfusion_tpu_torch.models import volume as volume_model
from dynamicfusion_tpu_torch.models.volume import TsdfVolume
from dynamicfusion_tpu_torch.ops import preprocess, tsdf as ttsdf
from test_torch_tsdf_bricks import JC, TC, vol2  # noqa: F401  (vol2: the module's fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CSRC = Path(kernels.CSRC)
ROWS = kernels.EXTRACT_ROWS  # rows a block
WARPS = 8                    # warps a block (256 threads)
SCAN_THREADS = 256           # the last block's threads
PX = 1                       # kernel A's pixels a thread
BX, BY = 32, 4               # kernel A's threads a block


def test_constants_match_the_sources():
    ext = (CSRC / "extract.cu").read_text()
    bil = (CSRC / "bilateral.cu").read_text()
    assert f"constexpr int kRowsPerBlock = {ROWS};" in ext
    assert f"constexpr int kRowThreads = {WARPS * 32};" in ext
    assert f"constexpr int kPx = {PX};" in bil
    assert f"constexpr int kBx = {BX}, kBy = {BY};" in bil
    sides = re.findall(r"case (\d+): return f\(Lanes<(\d+)>\{\}\);", ext)
    assert tuple(int(d) for d, _ in sides) == kernels.EXTRACT_SIDES
    assert all(int(d) == 32 * int(v) for d, v in sides)
    halves = re.findall(r"case (\d+): return launch_tiled<(\d+)>", bil)
    assert tuple(int(h) for h, _ in halves) == kernels.BILATERAL_HALVES[:-1]
    assert f"constexpr int kMaxHalf = {kernels.BILATERAL_HALVES[-1]};" in bil


# ---------------------------------------------------------------- kernel L


def _cross(ta, wa, tb, wb, mw):
    return (wa >= mw) & (wb >= mw) & (ta * tb < 0)


def row_masks(t, w, mw):
    """(3, d^2, 32, V) bools: the +x, +y and +z tests of each row's lanes'
    voxels, as a warp tests them."""
    d = t.shape[0]
    v = d // 32
    t = t.reshape(d * d, 32, v)
    w = w.reshape(d * d, 32, v)
    r = torch.arange(d * d)
    i, j = r // d, r % d
    # the x row (i + 1, j) is row r + d, the y row (i, j + 1) row r + 1
    rx, ry = (r + d).clamp(max=d * d - 1), (r + 1).clamp(max=d * d - 1)
    mx = _cross(t, w, t[rx], w[rx], mw) & (i < d - 1)[:, None, None]
    my = _cross(t, w, t[ry], w[ry], mw) & (j < d - 1)[:, None, None]
    # +z: the run's next voxel, at its end the next lane's first (the
    # shuffle); lane 31's last voxel has none
    tz = torch.cat([t[:, :, 1:], torch.roll(t[:, :, :1], -1, dims=1)], dim=2)
    wz = torch.cat([w[:, :, 1:], torch.roll(w[:, :, :1], -1, dims=1)], dim=2)
    mz = _cross(t, w, tz, wz, mw)
    mz[:, 31, v - 1] = False
    return torch.stack([mx, my, mz]), (t[rx], t[ry], tz)


def scan_block_counts(counts):
    """The last block's scan of the (3, nblocks) counts: (3, nblocks)
    offsets, axis a's past the axes before it, and the total. A thread's
    contiguous segment of blocks, its warp's shuffle scan of the segment
    sums, the scan of the warp totals."""
    nb = counts.shape[1]
    per = -(-nb // SCAN_THREADS)
    seg = torch.zeros((3, SCAN_THREADS * per), dtype=torch.int64)
    seg[:, :nb] = counts
    seg = seg.reshape(3, WARPS, 32, per)
    s = seg.sum(-1)
    incl = torch.cumsum(s, 2)
    wsum = incl[..., -1]
    before = torch.cumsum(wsum, 1) - wsum
    total = wsum.sum(1)
    axis_base = torch.cumsum(total, 0) - total
    run = axis_base[:, None, None] + before[..., None] + incl - s
    off = run[..., None] + torch.cumsum(seg, -1) - seg
    return off.reshape(3, -1)[:, :nb], int(total.sum())


def row_listing(cfg, vol, max_points, mw):
    """Kernel L's row listing: (points, valid, count) in the kernel's
    order, with the plain version's arithmetic."""
    d = cfg.volume_dims
    v = d // 32
    t = volume_model.decode_tsdf(vol.tsdf)
    w = volume_model.decode_weight(vol.weight)
    m, (tx, ty, tz) = row_masks(t, w, mw)
    nb = d * d // ROWS
    cnt = m.sum(-1).to(torch.int64)  # (3, rows, lanes): a lane's popc
    # pass 1: each block's counts, the scan
    offsets, total = scan_block_counts(cnt.sum(-1).reshape(3, nb, ROWS).sum(-1))
    # pass 2: a round is a row a warp; ranks by round, warp, lane, voxel
    c = cnt.reshape(3, nb, ROWS // WARPS, WARPS, 32)
    lane_before = torch.cumsum(c, -1) - c
    warp_tot = c.sum(-1)
    warp_before = torch.cumsum(warp_tot, -1) - warp_tot
    round_tot = warp_tot.sum(-1)
    round_before = torch.cumsum(round_tot, -1) - round_tot
    rank0 = offsets[:, :, None, None, None] + round_before[..., None, None] + warp_before[..., None] + lane_before
    mi = m.to(torch.int64).reshape(3, nb, ROWS // WARPS, WARPS, 32, v)
    rank = (rank0[..., None] + torch.cumsum(mi, -1) - mi).reshape(3, d * d, 32, v)
    points = torch.full((max_points, 3), float("nan"))
    own = t.reshape(d * d, 32, v)
    r, lane, q = torch.meshgrid(torch.arange(d * d), torch.arange(32), torch.arange(v), indexing="ij")
    org = volume_model.origin(cfg)
    for a, nbr in enumerate((tx, ty, tz)):
        sel = m[a] & (rank[a] < max_points)
        t0, t1 = own[sel], nbr[sel]
        den = t0 - t1
        alpha = t0 / torch.where(torch.abs(den) > 1e-12, den, 1e-12)
        idx = torch.stack([r[sel] // d, r[sel] % d, lane[sel] * v + q[sel]], dim=-1).to(torch.float32)
        step = torch.zeros(3)
        step[a] = 1.0
        idx = idx + step * alpha[:, None]
        points[rank[a][sel]] = idx * cfg.voxel_size + org
    n = min(total, max_points)
    valid = torch.arange(max_points) < n
    points[~valid] = float("nan")
    return points, valid, torch.tensor(total, dtype=torch.int32), offsets, cnt


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _tvol(np_vol):
    return TsdfVolume(torch.from_numpy(np_vol[0].copy()), torch.from_numpy(np_vol[1].copy()))


def _block_cut(cfg, vol):
    """A cap inside one block's run of axis 1: the listing's offsets of a
    block with at least four +y crossings, plus half of them."""
    *_, offsets, cnt = row_listing(cfg, vol, 1, 1.0)
    per_block = cnt[1].sum(-1).reshape(-1, ROWS).sum(-1)
    b = int(torch.nonzero(per_block >= 4)[0])
    return int(offsets[1, b]) + int(per_block[b]) // 2


@pytest.mark.parametrize("cap", ["1<<16", "700", "block"])
def test_row_listing_matches_jax_and_plain(vol2, cap):  # noqa: F811
    tv = _tvol(vol2)
    max_points = {"1<<16": 1 << 16, "700": 700}.get(cap) or _block_cut(TC, tv)
    pts, valid, count, offsets, cnt = row_listing(TC, tv, max_points, 1.0)
    if cap == "block":
        b = int(torch.searchsorted(offsets[1], torch.tensor(max_points), right=True)) - 1
        start = int(offsets[1, b])
        assert start < max_points < start + int(cnt[1].sum(-1).reshape(-1, ROWS).sum(-1)[b])
    jc = jtsdf.extract_cloud(JC, JVol(jnp.asarray(vol2[0]), jnp.asarray(vol2[1])), max_points=max_points,
                             min_weight=1.0)
    assert int(jc.count) == int(count) > 700
    np.testing.assert_array_equal(np.asarray(jc.valid), valid.numpy())
    np.testing.assert_allclose(np.asarray(jc.points), pts.numpy(), atol=1e-6, rtol=0)
    pc = ttsdf.extract_cloud_plain(TC, tv, max_points, 1.0)
    assert torch.equal(pc.count, count) and torch.equal(pc.valid, valid) and _same_bits(pc.points, pts)


def _sphere_volume(d, seed):
    """A seeded (d, d, d) i16/u16 volume: a noisy sphere's truncated SDF,
    weights on and off around the minimum."""
    rng = np.random.RandomState(seed)
    g = (np.arange(d) + 0.5) / d
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    sdf = np.sqrt((x - 0.48) ** 2 + (y - 0.55) ** 2 + (z - 0.5) ** 2) - 0.31 + 0.01 * rng.randn(d, d, d)
    tsdf = np.clip(sdf / 0.05, -1.0, 1.0)
    weight = rng.choice([0.0, 0.5, 1.0, 2.0, 5.0], size=(d, d, d), p=[0.1, 0.1, 0.2, 0.3, 0.3])
    return (np.round(tsdf * 32767).astype(np.int16), np.round(weight * 512).astype(np.uint16))


@pytest.mark.parametrize("d", [32, 128])
def test_row_listing_matches_plain(d):
    cfg = TCfg.small(dims=d)
    tv = _tvol(_sphere_volume(d, d))
    n = int(ttsdf.extract_cloud_plain(cfg, tv, 1, 1.0).count)
    for max_points in (n + 100, n // 2 + 3):
        pts, valid, count, _, _ = row_listing(cfg, tv, max_points, 1.0)
        pc = ttsdf.extract_cloud_plain(cfg, tv, max_points, 1.0)
        assert int(count) == n > 1000
        assert torch.equal(pc.count, count) and torch.equal(pc.valid, valid) and _same_bits(pc.points, pts)


@pytest.mark.parametrize("case", [c for c, (d, _, _) in EXTRACT_CASES.items() if d <= 128])
def test_row_listing_matches_plain_on_edge_values(case):
    """``chip_smoke.EXTRACT_CASES``: codes and values at the edges of the
    crossing test, weights at both sides of the threshold, every storage
    kind; uncapped and at half the count."""
    cfg, vol = extract_case(torch, "cpu", case)
    n = int(ttsdf.extract_cloud_plain(cfg, vol, 1, 1.0).count)
    assert n > 1000
    for max_points in (n + 100, n // 2 + 1):
        pts, valid, count, _, _ = row_listing(cfg, vol, max_points, 1.0)
        pc = ttsdf.extract_cloud_plain(cfg, vol, max_points, 1.0)
        assert torch.equal(pc.count, count) and torch.equal(pc.valid, valid) and _same_bits(pc.points, pts)


# ---------------------------------------------------------------- kernel A


def tiled_bilateral(depth_mm, kernel_size=7, sigma_spatial=4.5, sigma_depth_m=0.04):
    """Kernel A's tiled filter: every block's tile and halo (the marker -1
    past the image), a thread's PX consecutive pixels, the spatial term
    from the table, the marked taps skipped in border blocks only."""
    h = kernel_size // 2
    table = kernels.bilateral_space_table(kernel_size, sigma_spatial)
    sigma_depth_mm = sigma_depth_m * 1000.0
    inv_sd = 0.5 / (sigma_depth_mm * sigma_depth_mm)
    rows, cols = depth_mm.shape
    bw = BX * PX
    nby, nbx = -(-rows // BY), -(-cols // bw)
    d = depth_mm.to(torch.float32)
    y0 = torch.arange(nby) * BY
    x0 = torch.arange(nbx) * bw
    ys = y0[:, None] - h + torch.arange(BY + 2 * h)  # (nby, tile rows)
    xs = x0[:, None] - h + torch.arange(bw + 2 * h)  # (nbx, tile columns)
    inside = ((ys >= 0) & (ys < rows))[:, None, :, None] & ((xs >= 0) & (xs < cols))[None, :, None, :]
    tile = torch.where(inside, d[ys.clamp(0, rows - 1)[:, None, :, None], xs.clamp(0, cols - 1)[None, :, None, :]],
                       -1.0)  # (nby, nbx, BY + 2h, bw + 2h)
    interior = (((y0 >= h) & (y0 + BY + h <= rows))[:, None] & ((x0 >= h) & (x0 + bw + h <= cols))[None, :])
    ty = torch.arange(BY)[:, None, None]
    cx = torch.arange(BX)[None, :, None] * PX + torch.arange(PX)[None, None, :]  # (1, BX, PX)

    def at(dy, dx):
        return tile[:, :, ty + h + dy, cx + h + dx]  # (nby, nbx, BY, BX, PX)

    center = at(0, 0)
    skip_ok = interior[:, :, None, None, None]
    num = torch.zeros_like(center)
    den = torch.zeros_like(center)
    for dy in range(-h, h + 1):
        for dx in range(-h, h + 1):
            nbr = at(dy, dx)
            space = float(table[(dy + h) * (2 * h + 1) + dx + h])
            diff = center - nbr
            wgt = torch.exp(-(space + diff * diff * inv_sd))
            take = skip_ok | (nbr != -1.0)
            num = torch.where(take, num + nbr * wgt, num)
            den = torch.where(take, den + wgt, den)
    res = torch.round(num / torch.clamp(den, min=1e-12))  # (nby, nbx, BY, BX, PX)
    out = res.permute(0, 2, 1, 3, 4).reshape(nby * BY, nbx * bw)[:rows, :cols]
    return out.to(torch.int32).to(depth_mm.dtype)


def _noisy_frame():
    cfg = TCfg.small(dims=64, rows=120, cols=160)
    depth = synthetic.scene_depth(cfg.intr, cfg.rows, cfg.cols, synthetic.orbit_pose(0.02, target=(0.0, 0.0, 0.9)),
                                  spheres=[dict(center=(0.0, 0.0, 0.9), radius=0.2)], plane_z=1.2).astype(np.int32)
    rng = np.random.RandomState(5)
    return np.where(depth > 0, depth + rng.randint(-6, 7, depth.shape), 0).astype(np.uint16)


@pytest.mark.parametrize("frame", ["noisy", "border"])
@pytest.mark.parametrize("kernel_size", [7, 5])
def test_tiled_bilateral_matches_plain(frame, kernel_size):
    depth = torch.from_numpy(_noisy_frame() if frame == "noisy" else border_frame(120, 160, 3))
    got = tiled_bilateral(depth, kernel_size)
    ref = preprocess.bilateral_filter_plain(depth, kernel_size)
    assert got.dtype == torch.uint16 and torch.equal(got, ref)
    if frame == "border":
        # the frame's own check: depth and holes on all four borders
        edge = torch.cat([depth[0], depth[-1], depth[:, 0], depth[:, -1]]).to(torch.int32)
        assert bool((edge > 0).any()) and bool((edge == 0).any())


@pytest.mark.parametrize("kernel_size,sigma", [(7, 4.5), (5, 1.7), (11, 3.0)])
def test_space_table_entries(kernel_size, sigma):
    table = kernels.bilateral_space_table(kernel_size, sigma)
    h = kernel_size // 2
    inv_sp = 0.5 / (sigma * sigma)
    assert table.dtype == np.float32 and table.shape == ((2 * h + 1) ** 2,)
    for dy in range(-h, h + 1):
        for dx in range(-h, h + 1):
            want = np.float32(np.float64(dy * dy + dx * dx) * inv_sp)
            assert table[(dy + h) * (2 * h + 1) + dx + h].view(np.int32) == want.view(np.int32), (dy, dx)
