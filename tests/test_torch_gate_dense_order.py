"""Kernel M's cluster design and kernel F1's tiled design on the CPU: numpy
transcriptions of what the CUDA kernels compute, held against the plain
versions.

- M (``csrc/p2p_gate.cu`` ``gate_cluster_kernel``): a strip's bins that
  its pixels read, in passes of kSlots bins in ascending order; the
  horizontal pass walks each (row, column, channel)'s window once a pass,
  adding each tap of the pass's bins into its own bin's sum from +0; the
  vertical pass sums, for each pixel and each of its bins, the window's
  rows in the image from +0, the bins in ascending order. The sums are bit-equal to the plain version's
  (``kinfu._gate_sums``) and give its gate, on ``chip_smoke.GATE_CASES``
  and at odd and even windows; the design's constants keep a strip and its
  window inside a region row and a warp's rows on distinct banks.
- F1 (``csrc/fuse_dense.cu`` ``fuse_dense_tiles_kernel``): the blocks'
  tiles, their warps' rows and lanes' runs cover every voxel once at each
  compiled side, and every preset's side is compiled.

Constants are read from the sources. No JAX; a few seconds on one process.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import GATE_CASES, gate_case
from dynamicfusion_tpu_torch import kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.pipeline import kinfu
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
F32 = np.float32


def _const(src: str, name: str) -> int:
    m = re.findall(rf"constexpr int {name} = (\d+);", (CSRC / src).read_text())
    assert len(m) == 1, name
    return int(m[0])


# --------------------------------------------------------------------------
# kernel M
# --------------------------------------------------------------------------

BINS, CH = _const("p2p_gate.cu", "kBins"), _const("p2p_gate.cu", "kCh")
STRIP = _const("p2p_gate.cu", "kStrip")
MAX_WIN, REGION = _const("p2p_gate.cu", "kMaxWin"), _const("p2p_gate.cu", "kRegion")
SLOTS = _const("p2p_gate.cu", "kSlots")


def _features(live, nrm, prev, cam_z):
    """``pixel_features``: (H, W, 11) features, (H, W) bins, the bin codes
    (the bin, + 16 where the pixel is not valid)."""
    with np.errstate(invalid="ignore", over="ignore"):
        d = (live - prev).astype(F32)
        valid = np.isfinite(d).all(-1) & np.isfinite(nrm).all(-1)
        big = np.finfo(F32).max
        n = np.where(valid[..., None], np.nan_to_num(nrm, nan=0.0, posinf=big, neginf=-big), F32(0))
        dd = np.nan_to_num(d, nan=0.0, posinf=big, neginf=-big)
        nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
        b = np.where(valid, (nx * dd[..., 0] + ny * dd[..., 1]) + nz * dd[..., 2], F32(0))
        f = np.stack([valid.astype(F32), nx * nx, ny * ny, nz * nz, nx * ny, nx * nz, ny * nz, nx * b, ny * b,
                      nz * b, b * b], -1).astype(F32)
        z = np.where(np.isnan(cam_z), F32(-1), cam_z)
        zb = np.clip(np.floor((z - F32(0.3)) / F32(0.1)), 0, BINS - 1).astype(np.int64)
    return f, zb, np.where(valid, zb, zb + BINS)


def _cluster_sums(gin, win):
    """The cluster design's (H, W, 11) three-bin window sums: a strip of
    STRIP columns at a time, the bins its pixels read in passes of SLOTS
    in ascending order."""
    f, zb, code = _features(*gin)
    rows, cols = zb.shape
    lo, hi = (win - 1) // 2, win - 1 - (win - 1) // 2
    s = np.zeros((rows, cols, CH), F32)
    for x0 in range(0, cols, STRIP):
        xs = np.arange(x0, min(x0 + STRIP, cols))
        yy, xx = np.meshgrid(np.arange(rows), xs, indexing="ij")
        zc = zb[:, xs]
        need = sorted({b for z in np.unique(zc) for b in (z - 1, z, z + 1) if 0 <= b < BINS})
        for g in range(0, len(need), SLOTS):
            grp = need[g:g + SLOTS]
            slot = {b: n for n, b in enumerate(grp)}
            # horizontal: each (row, column)'s taps once, each added to its
            # own bin's sum (a tap of another bin, or not valid, to none)
            hs = np.zeros((len(grp), rows, len(xs), CH), F32)
            for dx in range(-lo, hi + 1):
                xt = np.clip(xx + dx, 0, cols - 1)
                inside = (xx + dx >= 0) & (xx + dx < cols)
                cd = code[yy, xt]
                for n, b in enumerate(grp):
                    hs[n] = np.where((inside & (cd == b))[..., None], hs[n] + f[yy, xt], hs[n])
            # vertical: a pixel's bins of the pass in ascending order, each
            # the bin's window rows in the image from +0
            for n, b in enumerate(grp):
                acc = np.zeros((rows, len(xs), CH), F32)
                for t in range(win):
                    yt = yy - lo + t
                    acc = np.where(((yt >= 0) & (yt < rows))[..., None],
                                   acc + hs[n, np.clip(yt, 0, rows - 1), xx - x0], acc)
                read = ((b >= zc - 1) & (b <= zc + 1))[..., None]
                s[:, xs] = np.where(read, s[:, xs] + acc, s[:, xs])
    return s


def test_gate_constants():
    """A strip and its widest window fit a region row; a warp's eight rows
    of four taps (stride kRegion) fall on distinct groups of four banks."""
    assert STRIP + MAX_WIN - 1 <= REGION and 32 % STRIP == 0 and STRIP == 4
    assert sorted((r * REGION) % 32 // 4 for r in range(8)) == list(range(8))
    assert (BINS, CH) == (kinfu.GATE_BINS, kinfu.GATE_CHANNELS)


@pytest.mark.parametrize("name,win", [(n, 41) for n in GATE_CASES if n not in ("wide", "tall")]
                         + [("random", 9), ("all_bins", 16), ("narrow", 40)])
def test_cluster_sums_are_the_plain_sums(name, win):
    """The transcription's sums bit-equal to ``kinfu._gate_sums`` (and so
    the gate to the plain gate), on each case's first 48 rows and 64
    columns (every window clipped by some edge)."""
    gin = tuple(np.ascontiguousarray(a[:48, :64]) for a in gate_case(name))
    cfg = dataclasses.replace(DynamicFusionConfig.quality_dynamicfusion(), solver_p2p_gate_window=win)
    ts = tuple(torch.from_numpy(a) for a in gin)
    plain, zb = kinfu._gate_sums(*ts, win)
    got = _cluster_sums(gin, win)
    assert np.array_equal(_features(*gin)[1], zb.numpy())
    assert np.array_equal(got.view(np.int32), plain.numpy().view(np.int32))
    gate = kinfu._gate_closed_form(cfg, torch.from_numpy(got))
    assert torch.equal(gate.view(torch.int32), kinfu.p2p_gate(cfg, *ts, plain=True).view(torch.int32))


# --------------------------------------------------------------------------
# kernel F1
# --------------------------------------------------------------------------

RUN = _const("fuse_dense.cu", "kRun")
WARPS = _const("fuse_dense.cu", "kTileThreads") // 32
SIDES = tuple(int(v) for v in re.findall(r"kSides\[\] = \{([^}]*)\}", (CSRC / "fuse_dense.cu").read_text())[0]
              .split(","))


def _tiles(d):
    """(K, J, a block's rows along j, blocks along k, j, i) of a side, as
    ``Tiles<D>`` (a tile one plane along i)."""
    k = min(d, 64)
    j = 32 // (k // RUN)
    return k, j, WARPS * j, d // k, d // (WARPS * j), d


def _block_box(d, block):
    """(i0, j0, k0) of a block's tile."""
    k, j, bj, nk, nj, _ = _tiles(d)
    kt, jb, it = block % nk, (block // nk) % nj, block // (nk * nj)
    return it, jb * bj, kt * k


def _block_voxels(d, block):
    """The flat voxel indices of a block's tile, as its warps' lanes' runs
    address them."""
    k, j, bj, _, _, _ = _tiles(d)
    i0, j0, k0 = _block_box(d, block)
    lane = np.arange(32)
    warp = np.arange(WARPS)[:, None]
    jj = (j0 + warp * j + lane // (k // RUN)).ravel()
    kb = np.tile(k0 + (lane % (k // RUN)) * RUN, WARPS)
    return ((i0 * d + jj[:, None]) * d + kb[:, None] + np.arange(RUN)).ravel()


@pytest.mark.parametrize("d", [s for s in SIDES if s <= 128])
def test_tiles_cover_every_voxel_once(d):
    k, j, bj, nk, nj, ni = _tiles(d)
    assert k % RUN == 0 and d % bj == 0 and 32 % (k // RUN) == 0
    seen = np.zeros(d ** 3, np.int32)
    for block in range(nk * nj * ni):
        np.add.at(seen, _block_voxels(d, block), 1)
    assert bool((seen == 1).all())


def test_sides_are_the_config_sides():
    """Every preset's volume side is compiled (no preset takes the
    reference mode)."""
    assert SIDES == (32, 64, 128, 256, 512)
    for cfg in (DynamicFusionConfig(), DynamicFusionConfig.default_dynamicfusion(),
                DynamicFusionConfig.reference_parity(), DynamicFusionConfig.default_kinfu(),
                DynamicFusionConfig.quality_dynamicfusion(), DynamicFusionConfig.small()):
        assert cfg.volume_dims in SIDES
