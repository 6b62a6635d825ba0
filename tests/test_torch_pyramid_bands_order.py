"""Kernel I's one-launch depth pyramid and kernel J's tiled march band on
the CPU: numpy transcriptions of what the CUDA kernels index and compute,
held against the plain versions.

- The pyramid (``preprocess.depth_pyramid``, one launch of
  ``csrc/preprocess.cu``'s ``depth_pyramid_kernel`` on the card): the
  tile plan (``pyramid_plan``: T from 4 down while the grid has fewer
  blocks than the card's SMs or the regions pass the shared-memory cap),
  each block's level-0 region read once as float with a NaN outside the
  image (no tap tests bounds), every coarser level computed over its
  region with its halo, only the owned pixels written; every
  pixel of every level written exactly once and bit-equal to the plain
  per-level ``depth_pyramid_down``, at the preset's 640x480, odd sizes and
  on ``chip_smoke.pyramid_frame``'s threshold-edge frame.
- The band (``kinfu._march_bands``, one launch of ``csrc/bands.cu``'s
  ``bands_tile_kernel``): 16x8 tiles, the sources of the tile and its
  2-pixel halo staged once a pixel, a row pass and a column pass;
  bit-equal to ``_temporal_band`` and ``_raycast_seed`` at strides 1, 2
  and 4, on an all-miss model map and on all-zero dists.

Constants are read from the sources. Small shapes, numpy-made inputs;
a few seconds on one process.
"""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import pyramid_frame
from dynamicfusion_tpu_torch import kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.ops import preprocess as tpre
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
SIGMA = 0.04
THRESH = np.float32(SIGMA * 1000.0 * 3.0)
H100_SMS = 132


def _const(src: str, name: str) -> int:
    m = re.findall(rf"constexpr int {name} = (\d+);", (CSRC / src).read_text())
    assert len(m) == 1, name
    return int(m[0])


def _sizes(h, w, down):
    hs, ws = [h], [w]
    for _ in range(down):
        hs.append(hs[-1] // 2)
        ws.append(ws[-1] // 2)
    return hs, ws


def _pyramid_plan(h, w, down, sms, smem, max_tile=8):
    """``pyramid_plan`` of csrc/preprocess.cu: (T, region sides, halos,
    (grid rows, grid cols), shared bytes, threads a block), or None where
    no tile fits: the T whose busiest SM computes the fewest level-1
    pixels (ceil(blocks / SMs) x n_1^2), the larger on a tie."""
    hs, ws = _sizes(h, w, down)
    best = None
    for t in range(1, max_tile + 1):
        n, halo = [0] * (down + 1), [0] * (down + 1)
        n[down] = t
        for k in range(down - 1, -1, -1):
            n[k] = 2 * n[k + 1] + 3
            halo[k] = 2 * halo[k + 1] + 2
        nbytes = 4 * sum(n[k] * n[k] for k in range(down))
        if nbytes > smem:
            continue
        gy = max(-(-hs[k] // (t << (down - k))) for k in range(1, down + 1))
        gx = max(-(-ws[k] // (t << (down - k))) for k in range(1, down + 1))
        gy, gx = max(gy, 1), max(gx, 1)
        cost = -(-(gx * gy) // sms) * n[1] * n[1]
        if best is None or cost <= best[0]:
            best = (cost, (t, n, halo, (gy, gx), nbytes, 512 if gx * gy <= sms else 256))
    return None if best is None else best[1]


def _level_from_region(prev, n, y0, x0, h, w):
    """One coarser level over a block's region as ``depth_pyramid_kernel``
    computes it: ``prev`` the finer level's region (float32, starting at
    2 y0 - 2, 2 x0 - 2, NaN outside the finer image, so that such a tap
    fails the threshold test), each position's centre at (2r + 2, 2c + 2);
    NaN at positions out of the image."""
    r, c = np.mgrid[0:n, 0:n]
    y, x = y0 + r, x0 + c
    ctr = prev[2 * r + 2, 2 * c + 2]
    s = np.zeros((n, n), np.float32)
    cnt = np.zeros((n, n), np.float32)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            nbr = prev[2 * r + 2 + dy, 2 * c + 2 + dx]
            keep = np.abs(nbr - ctr) < THRESH
            s = np.where(keep, s + nbr, s)
            cnt = np.where(keep, cnt + np.float32(1.0), cnt)
    with np.errstate(invalid="ignore"):
        mean = np.where(cnt > 0, s / np.maximum(cnt, np.float32(1.0)), np.float32(0.0)).astype(np.float32)
        v = np.nan_to_num(mean).astype(np.int32).astype(np.uint16)
    inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    return v, np.where(inside, v.astype(np.float32), np.float32(np.nan)), y, x, inside


def _tiled_pyramid(img, down, sms=H100_SMS):
    """Every level written by the transcribed launch, and how many times
    each pixel was written."""
    smem = _const("preprocess.cu", "kPyrSmem")
    h, w = img.shape
    hs, ws = _sizes(h, w, down)
    t, n, halo, (gy, gx), _, _ = _pyramid_plan(h, w, down, sms, smem)
    outs = [np.zeros((hs[k], ws[k]), np.uint16) for k in range(1, down + 1)]
    writes = [np.zeros((hs[k], ws[k]), np.int64) for k in range(1, down + 1)]
    for by in range(gy):
        for bx in range(gx):
            span = t << down
            y0, x0 = by * span - halo[0], bx * span - halo[0]
            yy, xx = np.mgrid[y0:y0 + n[0], x0:x0 + n[0]]
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            region = np.where(inside, img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(np.float32),
                              np.float32(np.nan))
            for k in range(1, down + 1):
                span = t << (down - k)
                oy, ox = by * span, bx * span
                v, region_k, y, x, inside = _level_from_region(region, n[k], oy - halo[k], ox - halo[k], hs[k], ws[k])
                own = inside & (y >= oy) & ((y < oy + span) | (by + 1 == gy)) & (x >= ox) & (
                    (x < ox + span) | (bx + 1 == gx))
                outs[k - 1][y[own], x[own]] = v[own]
                np.add.at(writes[k - 1], (y[own], x[own]), 1)
                region = region_k
    return outs, writes


def _plain_levels(img, levels):
    return [lv.numpy() for lv in tpre.depth_pyramid(torch.from_numpy(img), levels, SIGMA)]


def _noisy_frame(rows, cols, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:rows, 0:cols]
    d = 900.0 + 0.7 * x + 0.4 * y + np.where((x // 37) % 2 == 0, 160.0, 0.0) + rng.randint(-3, 4, (rows, cols))
    return np.where(rng.rand(rows, cols) < 0.01, 0, d).astype(np.uint16)


FRAMES = {
    "preset_noisy": lambda: _noisy_frame(480, 640, 5),
    "odd_481x641": lambda: _noisy_frame(481, 641, 6),
    "adversarial": lambda: pyramid_frame(480, 640, 1),
    "adversarial_odd": lambda: pyramid_frame(97, 203, 2),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_one_launch_pyramid_transcription(name):
    """Every pixel of every level is written once by its owning block, and
    equals the plain per-level downsample bit for bit."""
    img = FRAMES[name]()
    outs, writes = _tiled_pyramid(img, 3)
    plain = _plain_levels(img, 4)
    for k, (got, ref, wr) in enumerate(zip(outs, plain[1:], writes), 1):
        assert got.shape == ref.shape, k
        assert (wr == 1).all(), (k, int(wr.min()), int(wr.max()))
        np.testing.assert_array_equal(got, ref, err_msg=f"level {k}")


@pytest.mark.parametrize("shape,down,sms", [((100, 70), 3, 4), ((13, 9), 2, 132), ((240, 320), 4, 132),
                                            ((5, 7), 1, 1), ((480, 640), 5, 132)])
def test_one_launch_pyramid_plan_edges(shape, down, sms):
    """Levels whose size is odd (a row or column past the deepest level's
    tiles), a grid under the SM count (T down to 1), more levels: still
    every pixel once and bit-equal."""
    img = pyramid_frame(*shape, seed=3)
    outs, writes = _tiled_pyramid(img, down, sms)
    plain = _plain_levels(img, down + 1)
    for k, (got, ref, wr) in enumerate(zip(outs, plain[1:], writes), 1):
        assert (wr == 1).all(), k
        np.testing.assert_array_equal(got, ref, err_msg=f"level {k}")


def test_pyramid_plan_preset_and_limits():
    """The preset's 640x480 four levels: T = 7, 12x9 = 108 blocks of 512
    threads, one an SM, a 77x77 level-0 region (8T + 21) and 37x37 level-1
    pixels a block (T = 4 would give 300 blocks, 3 of 625 on the busiest
    SM); the wrapper's level limit is the source's, and every level count
    up to it has a tile that fits."""
    smem = _const("preprocess.cu", "kPyrSmem")
    plan = lambda *a: _pyramid_plan(*a, max_tile=_const("preprocess.cu", "kPyrMaxTile"))  # noqa: E731
    t, n, halo, grid, nbytes, threads = plan(480, 640, 3, H100_SMS, smem)
    assert (t, n, halo, grid, threads) == (7, [77, 37, 17, 7], [14, 6, 2, 0], (9, 12), 512)
    assert nbytes == 4 * (77 * 77 + 37 * 37 + 17 * 17)
    assert _const("preprocess.cu", "kPyrMaxDown") == kernels.PYRAMID_MAX_DOWN
    for down in range(1, kernels.PYRAMID_MAX_DOWN + 1):
        assert plan(480, 640, down, H100_SMS, smem) is not None, down
    assert _const("preprocess.cu", "kPyrMaxThreads") == 1024


def test_depth_pyramid_plain_is_the_levels():
    """``depth_pyramid``'s plain route is ``depth_pyramid_down`` level by
    level, and ``build_frame_pyramid`` returns it."""
    img = pyramid_frame(61, 83, seed=4)
    pyr = tpre.depth_pyramid(torch.from_numpy(img), 4, SIGMA)
    cur = torch.from_numpy(img)
    assert torch.equal(pyr[0], cur)
    for lv in pyr[1:]:
        cur = tpre.depth_pyramid_down(cur, SIGMA)
        assert torch.equal(lv, cur)
    cfg = TCfg.small(dims=32, rows=61, cols=83)
    got = tpre.build_frame_pyramid(cfg, torch.from_numpy(img))[0]
    d0 = tpre.bilateral_filter(torch.from_numpy(img), cfg.bilateral_kernel_size, cfg.bilateral_sigma_spatial,
                               cfg.bilateral_sigma_depth)
    ref = tpre.depth_pyramid(d0, cfg.pyramid_levels, cfg.bilateral_sigma_depth)
    assert len(got) == cfg.pyramid_levels and all(torch.equal(a, b) for a, b in zip(got, ref))


# --------------------------------------------------------------------------
# kernel J: the tiled band and seed
# --------------------------------------------------------------------------


def _tiled_bands(dists, stride, prev, margin):
    """``bands_tile_kernel``: (seed, lo | None, hi | None)."""
    bx_, by_ = _const("bands.cu", "kBandX"), _const("bands.cu", "kBandY")
    live_all = dists[::stride, ::stride]
    rows, cols = live_all.shape
    inf = np.float32(np.inf)
    seed = np.zeros((rows, cols), np.float32)
    lo_o = np.zeros((rows, cols), np.float32)
    hi_o = np.zeros((rows, cols), np.float32)
    for by in range(0, rows, by_):
        for bx in range(0, cols, bx_):
            yy, xx = np.mgrid[by - 2:by + by_ + 2, bx - 2:bx + bx_ + 2]
            inside = (yy >= 0) & (yy < rows) & (xx >= 0) & (xx < cols)
            yc, xc = np.clip(yy, 0, rows - 1), np.clip(xx, 0, cols - 1)
            live = live_all[yc, xc]
            pos = live > 0
            near = np.where(inside & pos, live, inf)
            if prev is not None:
                p = prev[yc, xc]
                # the root as the plain version takes it here: CPU torch's
                # float32 sqrt is an ulp off on some inputs, CUDA's is not
                t = torch.sqrt(torch.from_numpy((p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1])
                                                + p[..., 2] * p[..., 2])).numpy()
                miss = np.isnan(t)
                lo = np.where(inside, np.minimum(np.where(miss, inf, t), np.where(pos, live, inf)), inf)
                hi = np.where(inside, np.maximum(np.where(miss, -inf, t), np.where(pos, live, -inf)), -inf)
            srcs = [near] + ([lo, hi] if prev is not None else [])
            ops = [np.minimum, np.minimum, np.maximum]
            # the row pass, then the column pass
            outs = []
            for src, op in zip(srcs, ops):
                r = src[:, 0:bx_]
                for d in range(1, 5):
                    r = op(r, src[:, d:d + bx_])
                c = r[0:by_]
                for d in range(1, 5):
                    c = op(c, r[d:d + by_])
                outs.append(c)
            ys, xs = np.mgrid[by:by + by_, bx:bx + bx_]
            ok = (ys < rows) & (xs < cols)
            d = live_all[np.clip(ys, 0, rows - 1), np.clip(xs, 0, cols - 1)]
            sd = np.where(d > 0, d, np.where(np.isfinite(outs[0]), outs[0], 0.0))
            seed[ys[ok], xs[ok]] = sd[ok]
            if prev is not None:
                hit = np.isfinite(outs[1])
                lo_o[ys[ok], xs[ok]] = np.where(hit, np.maximum(outs[1] - np.float32(margin), 0.0), 0.0)[ok]
                hi_o[ys[ok], xs[ok]] = np.where(hit, outs[2] + np.float32(margin), 0.0)[ok]
    return seed, (lo_o, hi_o) if prev is not None else None


def _band_inputs(case, stride, rows=37, cols=53, seed=3):
    rng = np.random.RandomState(seed)
    dists = rng.uniform(0.4, 2.5, (rows * stride, cols * stride)).astype(np.float32)
    dists[rng.rand(*dists.shape) < 0.3] = 0.0
    prev = rng.uniform(-0.8, 1.6, (rows, cols, 3)).astype(np.float32)
    prev[rng.rand(rows, cols) < 0.25] = np.nan
    if case == "all_miss":
        prev[:] = np.nan
    elif case == "zero_dists":
        dists[:] = 0.0
    return dists, prev


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("case", ["seeded", "all_miss", "zero_dists"])
def test_tiled_band_transcription(case, stride):
    """The tiled kernel's band and seed equal ``_temporal_band`` and
    ``_raycast_seed`` bit for bit (min and max are exact in any order)."""
    dists, prev = _band_inputs(case, stride)
    cfg = dataclasses.replace(TCfg.small(dims=32, rows=dists.shape[0], cols=dists.shape[1]),
                              raycast_subsample=stride, raycast_temporal_band=True, raycast_seed_margin=0.1)
    seed, (lo, hi) = _tiled_bands(dists, stride, prev, np.float32(cfg.raycast_band_margin))
    ps, (plo, phi) = tkinfu._march_bands(cfg, torch.from_numpy(prev), torch.from_numpy(dists))
    for got, ref in ((seed, ps), (lo, plo), (hi, phi)):
        assert np.array_equal(got.view(np.int32), ref.numpy().view(np.int32))
    seed_only, band = _tiled_bands(dists, stride, None, 0.0)
    assert band is None and np.array_equal(seed_only.view(np.int32), ps.numpy().view(np.int32))


def test_band_tile_constants():
    """The 16x8 tile: 150 blocks at the preset's 160x120."""
    bx, by = _const("bands.cu", "kBandX"), _const("bands.cu", "kBandY")
    assert (bx, by) == (16, 8) and math.ceil(160 / bx) * math.ceil(120 / by) == 150
