"""Kernel M's cluster design and kernel F1's tiled design, their choices
timed on the card.

Kernel M (``csrc/p2p_gate.cu``: ``gate_features_kernel``, then
``gate_cluster_kernel``): the kernel as it is (the features in one
launch; then clusters of 11 CTAs, one a channel, a strip of 4 columns,
256 threads and at most 64 registers a thread, the features staged 8
loads at a time, the bins in passes of 8, a thread a (row, column) in
the horizontal pass with a register a bin, a thread a pixel in the
vertical pass) beside variants of the same source with one choice
changed: strips of 8 columns (``strip8``), passes of 4 or 16 bins
(``slots4``, ``slots16``), 85 registers a thread (``ctas3``: three CTAs
an SM, not four), 128 or 512 threads a CTA (``threads128``,
``threads512``), the tap loop unrolled by 4 (``taps_unroll4``), the
staging loop not unrolled (``stage_unroll1``), the horizontal pass's
threads down the columns (``column_threads``), the horizontal pass with
the current bin's sum in one register moved to and from its slot where
the bin changes (``flush``), the vertical pass with a thread a column
and 5 rows over the union of a warp's bins (``segments``); and probes
whose gate is
wrong and not held: every CTA returns at once (``probe_launch``: both
launches), after waiting for the features (``probe_wait``), after
staging them (``probe_staged``), after the first pass's horizontal sums
(``probe_horizontal``) or after every pass (``probe_vertical``); beside
the reference mode (the two-launch design before), the library route
(``chip_smoke.library_p2p_gate``) and the plain version, on the gate's
inputs of the preset's state after three frames (160x120, as phase 2 of
``chip_smoke.py`` builds them) and on ``chip_smoke.gate_case("random")``
(every bin in use); the kernel, the reference mode, the library route
and the plain version alone on ``chip_smoke.gate_case("vga")`` (640x480,
the cluster design at 480 rows). Prints how many clusters the card holds
at once at 120, 240, 480 and the most rows (from an occupancy entry,
``M_OCCUPANCY``, added to a library of its own).

Kernel F1 (``csrc/fuse_dense.cu``, ``fuse_dense_tiles_kernel``): the
kernel as it is (runs of 8 voxels along k, a warp a tile of 1 plane, 128
threads a block, no block culled) beside runs of 4 (``run4``), 2 or 4
planes a tile (``planes2``, ``planes4``), 64 threads a block
(``threads64``), a block culled where a conservative float64 test of its
corners proves that none of its voxels can update (``cull``), a run's
projections, then its pixels' loads together, then the band test
(``phased``), and a probe that returns after the culling test
(``probe_cull``); beside the reference mode (a thread a voxel) and the
plain version, at 256^3 on the preset's state and its next frame (phase
2's F1 row, i16/u16), at the poses of ``chip_smoke.dense_poses`` (turned
away: no voxel in front of the camera; the volume's centre in the image
plane; a border cutting the volume).

    python3 scripts/torch_gate_dense_variants.py [--rounds 3] [--runs 2]

Variants are built with the kernels' nvcc flags into libraries of their
own by text substitution (the anchors must match the sources: edit both
together; check them on the CPU with ``check_anchors()``) and launched
through the port's wrappers with the variant's library in place. Each
variant but the probes is held bit for bit against the kernel; one that
differs is reported and not timed, and the script then exits 1. Times by
``chip_smoke.cuda_ms`` (CUDA events, 20 calls); the variants take turns,
``--rounds`` times, in each of ``--runs`` runs, the order reversed from
one run to the next. Prints the card, each variant's registers and
spills, each run's median with the spread between the runs' medians, and
a JSON line of every run's medians.
"""

import argparse
import contextlib
import ctypes
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# M's horizontal pass as it is (a register a slot, each tap compared with
# every slot's bin) and with the current bin's sum in one register, moved
# to and from its slot where the bin changes (FLUSH); its vertical pass as
# it is (a thread a pixel over its own bins) and with a thread a column and
# 5 rows, their sums in registers, a warp over the union of its pixels'
# bins (SEGMENTS)
M_HORIZONTAL = """\
    // 2. horizontal sums of channel c for the pass's bins: each tap once,
    // added into its own bin's register (a tap of another bin, or of a
    // pixel that is not valid, into none)
    int sb[kSlots];
    {
      unsigned g = grp;
#pragma unroll
      for (int n = 0; n < kSlots; ++n) {
        sb[n] = g ? __ffs(g) - 1 : -1;
        g &= g - 1u;
      }
    }
    for (int o = tid; o < rows * kStrip; o += kGateThreads) {
      const int y = o / kStrip, xl = o % kStrip;
      const int x = x0 + xl;
      if (x >= cols) continue;
      float acc[kSlots];
#pragma unroll
      for (int n = 0; n < kSlots; ++n) acc[n] = 0.0f;
      const float* fr = feat + y * kRegion;
      const unsigned char* cr = code + y * kRegion;
      const int t1 = min(x + a.hi, cols - 1) - rx0;
#pragma unroll 1
      for (int t = max(x - a.lo, 0) - rx0; t <= t1; ++t) {
        const int cd = cr[t];
        const float f = fr[t];
#pragma unroll
        for (int n = 0; n < kSlots; ++n)
          if (cd == sb[n]) acc[n] = acc[n] + f;
      }
      float* h = hs + y * kStrip + xl;  // slot n at h[n * rows * kStrip]
#pragma unroll
      for (int n = 0; n < kSlots; ++n) h[n * rows * kStrip] = acc[n];
    }
    __syncthreads();

"""
M_FLUSH = """\
    // 2. horizontal sums of channel c for the pass's bins: a thread a (row,
    // column) walks its taps once, the current bin's sum in a register
    // (moved to and from its slot where a tap of another of the pass's
    // bins comes; a tap of no bin of the pass, or of a pixel that is not
    // valid, is skipped)
    for (int o = tid; o < rows * kStrip; o += kGateThreads) {
      const int y = o / kStrip, xl = o % kStrip;
      const int x = x0 + xl;
      if (x >= cols) continue;
      float* h = hs + y * kStrip + xl;  // slot n at h[n * rows * kStrip]
#pragma unroll
      for (int n = 0; n < kSlots; ++n) h[n * rows * kStrip] = 0.0f;
      const float* fr = feat + y * kRegion;
      const unsigned char* cr = code + y * kRegion;
      const int t1 = min(x + a.hi, cols - 1) - rx0;
      int cb = -1;  // the current bin
      float cur = 0.0f;
#pragma unroll 4
      for (int t = max(x - a.lo, 0) - rx0; t <= t1; ++t) {
        const int cd = cr[t];
        if (cd != cb) {
          if (!(grp >> cd & 1u)) continue;
          if (cb >= 0) h[slot_of(grp, cb) * rows * kStrip] = cur;
          cb = cd;
          cur = h[slot_of(grp, cb) * rows * kStrip];
        }
        cur = cur + fr[t];
      }
      if (cb >= 0) h[slot_of(grp, cb) * rows * kStrip] = cur;
    }
    __syncthreads();

"""
M_VERTICAL = """\
    // 3. vertical sums: a thread a pixel adds, for each of its three bins in
    // the pass in ascending order, the bin's window rows from +0
    for (int o = tid; o < rows * kStrip; o += kGateThreads) {
      const int y = o / kStrip, xl = o % kStrip;
      if (x0 + xl >= cols) continue;
      const int zb = code[y * kRegion + (x0 + xl - rx0)] % kBins;
      const unsigned mine = (7u << zb >> 1) & grp;
      if (!mine) continue;
      const int y1 = min(y + a.hi, rows - 1);
      float s = vs[o];
#pragma unroll 1
      for (unsigned m = mine; m; m &= m - 1u) {
        const float* col = hs + slot_of(grp, __ffs(m) - 1) * rows * kStrip + xl;
        float acc = 0.0f;
#pragma unroll 4
        for (int yy = max(y - a.lo, 0); yy <= y1; ++yy) acc = acc + col[yy * kStrip];
        s = s + acc;
      }
      vs[o] = s;
    }
"""
M_SEGMENTS = """\
    {
      // kSeg rows a thread, a warp over the union of its pixels' bins
      constexpr int kSeg = 5, kWin = 0, kTaps = kMaxWin;
      const int win = a.lo + a.hi + 1;
      const int nseg = (rows + kSeg - 1) / kSeg;
    // 3. vertical sums: a thread a (column, segment of kSeg rows); a warp
    // walks the pass's bins that its pixels read, in ascending order
    for (int base = 0; base < nseg * kStrip; base += kGateThreads) {
      const int w = base + tid;
      const int xl = w % kStrip, seg = w / kStrip;
      const int y0 = seg * kSeg;
      const bool active = w < nseg * kStrip && x0 + xl < cols;
      int zbs[kSeg];
      unsigned mine = 0;
#pragma unroll
      for (int r = 0; r < kSeg; ++r) {
        zbs[r] = -4;  // a row past the image takes no bin
        if (active && y0 + r < rows) {
          zbs[r] = code[(y0 + r) * kRegion + (x0 + xl - rx0)] % kBins;
          mine |= 7u << zbs[r] >> 1;
        }
      }
      mine &= grp;
      unsigned todo = __reduce_or_sync(0xffffffffu, mine);
      float s[kSeg];
#pragma unroll
      for (int r = 0; r < kSeg; ++r) s[r] = active && y0 + r < rows ? vs[(y0 + r) * kStrip + xl] : 0.0f;
      while (todo) {
        const int b = __ffs(todo) - 1;
        todo &= todo - 1u;
        if (!(mine >> b & 1u)) continue;
        const float* col = hs + __popc(grp & ((1u << b) - 1u)) * rows * kStrip + xl;
        float v[kSeg + kTaps - 1];
#pragma unroll
        for (int j = 0; j < kSeg + kTaps - 1; ++j) {
          const int yy = y0 - a.lo + j;
          v[j] = ((kWin > 0 || j < kSeg + win - 1) && yy >= 0 && yy < rows) ? col[yy * kStrip] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < kSeg; ++r) {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < kTaps; ++t)
            if (kWin > 0 || t < win) acc = acc + v[r + t];
          if (b >= zbs[r] - 1 && b <= zbs[r] + 1) s[r] = s[r] + acc;
        }
      }
      if (active) {
#pragma unroll
        for (int r = 0; r < kSeg; ++r)
          if (y0 + r < rows) vs[(y0 + r) * kStrip + xl] = s[r];
      }
    }
    }
"""
M_VARIANTS = {
    "strip8": [("p2p_gate.cu", "constexpr int kStrip = 4;", "constexpr int kStrip = 8;"),
               ("p2p_gate.cu", "constexpr int kRegion = 52;", "constexpr int kRegion = 56;"),
               ("p2p_gate.cu", "constexpr int kMaxWin = 49;", "constexpr int kMaxWin = 41;")],
    "stage_unroll1": [("p2p_gate.cu", "#pragma unroll 8\n    for (int q = tid; q < rows * rw; q += kGateThreads) {",
                       "#pragma unroll 1\n    for (int q = tid; q < rows * rw; q += kGateThreads) {")],
    "slots4": [("p2p_gate.cu", "constexpr int kSlots = 8;", "constexpr int kSlots = 4;")],
    "slots16": [("p2p_gate.cu", "constexpr int kSlots = 8;", "constexpr int kSlots = 16;"),
                ("p2p_gate.cu", "__launch_bounds__(kGateThreads, 4)", "__launch_bounds__(kGateThreads, 2)")],
    "ctas3": [("p2p_gate.cu", "__launch_bounds__(kGateThreads, 4)", "__launch_bounds__(kGateThreads, 3)")],
    "threads128": [("p2p_gate.cu", "constexpr int kGateThreads = 256;", "constexpr int kGateThreads = 128;")],
    "threads512": [("p2p_gate.cu", "constexpr int kGateThreads = 256;", "constexpr int kGateThreads = 512;"),
                   ("p2p_gate.cu", "__launch_bounds__(kGateThreads, 4)", "__launch_bounds__(kGateThreads, 1)")],
    "taps_unroll4": [("p2p_gate.cu", "#pragma unroll 1\n      for (int t = max(x - a.lo, 0) - rx0; t <= t1; ++t) {",
                      "#pragma unroll 4\n      for (int t = max(x - a.lo, 0) - rx0; t <= t1; ++t) {")],
    "column_threads": [("p2p_gate.cu", "      const int y = o / kStrip, xl = o % kStrip;\n      const int x = x0 + xl;\n",
                        "      const int y = o % rows, xl = o / rows;\n      const int x = x0 + xl;\n")],
    "flush": [("p2p_gate.cu", M_HORIZONTAL, M_FLUSH)],
    "segments": [("p2p_gate.cu", M_VERTICAL, M_SEGMENTS)],
    "probe_launch": [("p2p_gate.cu", "  if (tid == 0) s_need = 0u;\n", "  if (rows > 0) return;\n")],
    "probe_wait": [("p2p_gate.cu", '  asm volatile("griddepcontrol.wait;" ::: "memory");\n',
                    '  asm volatile("griddepcontrol.wait;" ::: "memory");\n  if (rows > 0) return;\n')],
    "probe_staged": [("p2p_gate.cu", "  __syncthreads();\n\n  // the bins the strip's pixels read",
                      "  __syncthreads();\n  if (rows > 0) return;\n\n  // the bins the strip's pixels read")],
    "probe_horizontal": [("p2p_gate.cu", "    __syncthreads();\n\n    // 3. vertical sums",
                          "    __syncthreads();\n    if (rows > 0) return;\n\n    // 3. vertical sums")],
    "probe_vertical": [("p2p_gate.cu", "    __syncthreads();\n  }\n\n  // 4. each pixel's sum",
                        "    __syncthreads();\n  }\n  if (rows > 0) return;\n\n  // 4. each pixel's sum")],
}
# F1's kernel body as it is (a tile one plane along i), the anchor of the
# plane variants (a tile PLANES planes, the body looped over them)
F_BODY = """\
  const int kt = b % S::kBlocksK, jb = (b / S::kBlocksK) % S::kBlocksJ, i = b / (S::kBlocksK * S::kBlocksJ);
  const int j = jb * S::kBlockJ + warp * S::kJ + lane / S::kLanesK;
  const int kb = kt * S::kK + (lane % S::kLanesK) * kRun;
  const float fi = static_cast<float>(i), fj = static_cast<float>(j);
"""
F_RUN = """\
  // the run's partial r0 fi + r1 fj, then + r2 fk, then + t, as before
  const float px = r[0] * fi + r[1] * fj, py = r[3] * fi + r[4] * fj, pz = r[6] * fi + r[7] * fj;
  unsigned upd = 0;
  float obs[kRun];
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    const float fk = static_cast<float>(kb + e);
    const float x = (px + r[2] * fk) + r[9];
    const float y = (py + r[5] * fk) + r[10];
    const float z = (pz + r[8] * fk) + r[11];
    obs[e] = 0.0f;
    if (rigid_obs(dists, p, x, y, z, obs[e])) upd |= 1u << e;
  }
  if (!upd) return;
  const size_t addr = (static_cast<size_t>(i) * D + j) * D + kb;
  Run<T> tc = *reinterpret_cast<const Run<T>*>(tsdf + addr);
  Run<W> wc = *reinterpret_cast<const Run<W>*>(weight + addr);
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    if (!(upd >> e & 1u)) continue;
    const float q = 1.0f;
    const float t32 = dfk::code_value(tc.v[e]) * p.tsdf_decode;
    const float w32 = dfk::decode_weight(wc.v[e]);
    const float wq = w32 + q;
    if (wq > 1e-12f) tc.v[e] = dfk::encode_tsdf<T>((t32 * w32 + obs[e] * q) / fmaxf(wq, 1e-12f));
    wc.v[e] = dfk::encode_weight<W>(fminf(wq, p.max_w));
  }
  *reinterpret_cast<Run<T>*>(tsdf + addr) = tc;
  *reinterpret_cast<Run<W>*>(weight + addr) = wc;
}
"""
F_BLOCKS = "  static constexpr int kBlocks = kBlocksK * kBlocksJ * D;\n"


def planes(n: int):
    """F1 with a tile of ``n`` planes along i, the run's body looped over
    them."""
    head = F_BODY.replace(", i = b / (S::kBlocksK * S::kBlocksJ);", ", it = b / (S::kBlocksK * S::kBlocksJ);")
    head = head.replace("  const float fi = static_cast<float>(i), fj = static_cast<float>(j);\n",
                        f"  const float fj = static_cast<float>(j);\n#pragma unroll 1\n"
                        f"  for (int i = it * {n}; i < it * {n} + {n}; ++i) {{\n"
                        f"    const float fi = static_cast<float>(i);\n")
    body = "".join("  " + ln if ln.strip() and not ln.startswith("#") else ln
                   for ln in F_RUN[:-2].splitlines(keepends=True))
    body = body.replace("if (!upd) return;", "if (!upd) continue;")
    return [("fuse_dense.cu", F_BLOCKS, F_BLOCKS.replace("* D;", f"* (D / {n});")),
            ("fuse_dense.cu", F_BODY + F_RUN, head + body + "  }\n}\n")]


# F1's block culling: a block returns where a conservative test of its
# tile's corners (its first warp's, shared by a barrier vote) proves that
# none of its voxels can update. Lane l takes corner l & 7 and the signs
# of bits 3 (x, y) and 4 (z) of the widening; the position is evaluated
# in float64, widened by 1e-5 of its largest magnitude; behind: every
# corner's z + dl <= 0; off the image on one side: every corner has
# z - dl > 0 and every widened corner's projection lies past the side by
# a margin of 1e-5 (|cx| + the image side) + 1e-3 pixels.
F_CULL_TEST = """\
constexpr unsigned kFull = 0xffffffffu;

template <int D>
__device__ __forceinline__ bool tile_culled(const float* r, const Proj& p, int i0, int j0, int k0, int nj,
                                            int nk) {
  const int lane = threadIdx.x & 31;
  const double ci = i0;
  const double cj = j0 + ((lane & 2) ? nj - 1 : 0);
  const double ck = k0 + ((lane & 4) ? nk - 1 : 0);
  const double sx = (lane & 8) ? 1.0 : -1.0, sz = (lane & 16) ? 1.0 : -1.0;
  double c[3], dl[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c[a] = static_cast<double>(r[3 * a]) * ci + static_cast<double>(r[3 * a + 1]) * cj +
           static_cast<double>(r[3 * a + 2]) * ck + static_cast<double>(r[9 + a]);
    dl[a] = 1e-5 * ((fabs(static_cast<double>(r[3 * a])) + fabs(static_cast<double>(r[3 * a + 1])) +
                     fabs(static_cast<double>(r[3 * a + 2]))) * (D - 1) + fabs(static_cast<double>(r[9 + a])));
  }
  if (__all_sync(kFull, c[2] + dl[2] <= 0.0)) return true;
  if (!__all_sync(kFull, c[2] - dl[2] > 0.0)) return false;
  const double z = c[2] + sz * dl[2];
  const double ux = static_cast<double>(p.fx) * (c[0] + sx * dl[0]);
  const double vy = static_cast<double>(p.fy) * (c[1] + sx * dl[1]);
  const double cx = p.cx, cy = p.cy;
  const double mu = 1e-5 * (fabs(cx) + p.cols) + 1e-3;
  const double mv = 1e-5 * (fabs(cy) + p.rows) + 1e-3;
  return __all_sync(kFull, ux + (cx + mu) * z < 0.0) || __all_sync(kFull, ux + (cx - p.cols - mu) * z > 0.0) ||
         __all_sync(kFull, vy + (cy + mv) * z < 0.0) || __all_sync(kFull, vy + (cy - p.rows - mv) * z > 0.0);
}

"""
F_OBS = "// the rigid update's observation of a voxel at camera-frame (x, y, z), or\n"
F_J = "  const int j = jb * S::kBlockJ + warp * S::kJ + lane / S::kLanesK;\n"
F_VOTE = """\
  if (__syncthreads_or(warp == 0 && tile_culled<D>(r, p, i, jb * S::kBlockJ, kt * S::kK, S::kBlockJ, S::kK) &&
                       lane == 0))
    return;
"""


def cull(probe: bool = False):
    """F1 with block culling (``probe``: every block returns after the
    test)."""
    vote = F_VOTE.replace("lane == 0))", "lane == 0) || i >= 0)") if probe else F_VOTE
    return [("fuse_dense.cu", F_OBS, F_CULL_TEST + F_OBS), ("fuse_dense.cu", F_J, vote + F_J)]


# F1's phased variant: the run's projections first, then its pixels' loads
# together, then the band test
OLD_RUN = """\
  unsigned upd = 0;
  float obs[kRun];
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    const float fk = static_cast<float>(kb + e);
    const float x = (px + r[2] * fk) + r[9];
    const float y = (py + r[5] * fk) + r[10];
    const float z = (pz + r[8] * fk) + r[11];
    obs[e] = 0.0f;
    if (rigid_obs(dists, p, x, y, z, obs[e])) upd |= 1u << e;
  }
  if (!upd) return;
  const size_t addr = (static_cast<size_t>(i) * D + j) * D + kb;
  Run<T> tc = *reinterpret_cast<const Run<T>*>(tsdf + addr);
  Run<W> wc = *reinterpret_cast<const Run<W>*>(weight + addr);
"""
PHASED = """\
  // the run's projections, then its pixels' loads together, then the band
  unsigned act = 0, upd = 0;
  float xs[kRun], ys[kRun], zs[kRun], dp[kRun], obs[kRun];
  int pix[kRun];
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    const float fk = static_cast<float>(kb + e);
    xs[e] = (px + r[2] * fk) + r[9];
    ys[e] = (py + r[5] * fk) + r[10];
    zs[e] = (pz + r[8] * fk) + r[11];
    pix[e] = 0;
    if (zs[e] > 0.0f) {
      const float u = xs[e] * p.fx / zs[e] + p.cx;
      if (u >= 0.0f && u < p.cols) {
        const float v = ys[e] * p.fy / zs[e] + p.cy;
        if (v >= 0.0f && v < p.rows) {
          pix[e] = dfk::floor_clamp(v, p.rows - 1) * p.cols + dfk::floor_clamp(u, p.cols - 1);
          act |= 1u << e;
        }
      }
    }
  }
  if (!act) return;
  const size_t addr = (static_cast<size_t>(i) * D + j) * D + kb;
#pragma unroll
  for (int e = 0; e < kRun; ++e) dp[e] = (act >> e & 1u) ? __ldg(dists + pix[e]) : 0.0f;
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    obs[e] = 0.0f;
    if (!(act >> e & 1u) || !(dp[e] != 0.0f)) continue;
    const float psdf = dp[e] - sqrtf(xs[e] * xs[e] + ys[e] * ys[e] + zs[e] * zs[e]);
    if (!(psdf >= -p.trunc)) continue;
    const float scale = 1.0f;
    obs[e] = fminf(psdf * scale / p.trunc, 1.0f);
    upd |= 1u << e;
  }
  if (!upd) return;
  Run<T> tc = *reinterpret_cast<const Run<T>*>(tsdf + addr);
  Run<W> wc = *reinterpret_cast<const Run<W>*>(weight + addr);
"""
F_VARIANTS = {
    "run4": [("fuse_dense.cu", "constexpr int kRun = 8;          // voxels a lane along k",
              "constexpr int kRun = 4;          // voxels a lane along k")],
    "planes2": planes(2),
    "planes4": planes(4),
    "threads64": [("fuse_dense.cu", "constexpr int kTileThreads = 128;", "constexpr int kTileThreads = 64;")],
    "cull": cull(),
    "phased": [("fuse_dense.cu", OLD_RUN, PHASED)],
    "probe_cull": cull(probe=True),
}

# M's cluster occupancy: an entry that asks how many clusters of the
# cluster design the card holds at once for a map of ``rows`` rows
# (cudaOccupancyMaxActiveClusters), added to a library of its own
M_OCCUPANCY = [("p2p_gate.cu", "}  // namespace\n\n// The most rows", """\
}  // namespace

extern "C" int df_p2p_gate_clusters(int rows, int* n) {
  *n = 0;
  cudaError_t e = cluster_setup();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(kCh, 1, 1);
  cfg.blockDim = dim3(kGateThreads, 1, 1);
  cfg.dynamicSmemBytes = gate_smem(rows);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCh;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, reinterpret_cast<const void*>(gate_cluster_kernel), &cfg));
}

// The most rows""")]


def check_anchors(csrc=HERE / "dynamicfusion_tpu_torch" / "csrc"):
    """Every variant's anchors occur once in their sources (no card needed)."""
    for variants in (M_VARIANTS, F_VARIANTS, {"occupancy": M_OCCUPANCY}):
        for name, subs in variants.items():
            for f, a, _ in subs:
                if (csrc / f).read_text().count(a) != 1:
                    raise RuntimeError(f"{name}: anchor not found once in {f}: {a!r}")


@contextlib.contextmanager
def library(kernels, lib):
    """The port's wrappers launch from ``lib`` inside the block."""
    prev = kernels._lib
    kernels._lib = lib
    try:
        yield
    finally:
        kernels._lib = prev


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=3, help="turns of every variant in a run")
    ap.add_argument("--runs", type=int, default=2, help="runs, the variants' order reversed from one to the next")
    args = ap.parse_args()

    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("torch_gate_dense_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(HERE / "scripts"))
    import chip_smoke as cs
    from torch_data_term_variants import bind, build, median, turns
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.core import se3
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.models.volume import TsdfVolume
    from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops
    from dynamicfusion_tpu_torch.pipeline import kinfu

    check_anchors()
    card = cs.smi()
    print(card, flush=True)
    kernels.load()
    tmp = Path(tempfile.mkdtemp(prefix="gate_dense_variants_"))
    procs = {f"M {name}": build(kernels, name, "p2p_gate.cu", subs, tmp) for name, subs in M_VARIANTS.items()}
    procs.update({f"F1 {name}": build(kernels, name, "fuse_dense.cu", subs, tmp) for name, subs in F_VARIANTS.items()})
    procs["occupancy"] = build(kernels, "occupancy", "p2p_gate.cu", M_OCCUPANCY, tmp)
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and ("gate_cluster" in ln or ("tiles_kernel" in ln and "IstLi256" in ln)):
                props = [x.split("info    :")[-1].strip() for x in lines[i + 1:i + 4]
                         if "registers" in x or "spill" in x]
                print(f"[ptxas] {name}: " + " | ".join(props), flush=True)
        if name == "occupancy":
            occupancy = ctypes.CDLL(str(so))
            occupancy.df_p2p_gate_clusters.argtypes = [ctypes.c_int, ctypes.c_void_p]
            continue
        libs[name] = bind(kernels, so, ["df_p2p_gate"] if name.startswith("M ") else ["df_fuse_dense"])

    dev = torch.device("cuda")
    times, bad = {}, []

    def timed(tag, calls):
        """Every call's median in each run, printed with their spread."""
        names = list(calls)
        runs = []
        for k in range(args.runs):
            order = names if k % 2 == 0 else names[::-1]
            runs.append(turns(cs, torch, {name: calls[name] for name in order}, args.rounds))
        times[tag] = {name: [median(r[name]) for r in runs] for name in names}
        for k, r in enumerate(runs):
            print(f"[round] {card} | {tag}, run {k}: " + ", ".join(
                f"{name} {' '.join(f'{t:.4f}' for t in r[name])}" for name in names), flush=True)
        print(f"[time] {card} | {tag}, medians of the runs (spread): " + ", ".join(
            f"{name} {' / '.join(f'{m:.4f}' for m in times[tag][name])} ms "
            f"({(max(times[tag][name]) - min(times[tag][name])) / min(times[tag][name]):.1%})" for name in names),
            flush=True)

    # the preset's state after three frames and its next frame tracked (phase 2)
    nr = DynamicFusionConfig.default_dynamicfusion()
    depths = synthetic.deforming_frames(nr.intr, nr.rows, nr.cols, 4)
    df = kinfu.DynamicFusion(nr, device=dev)
    for d in depths[:3]:
        df(d)
    st = df.state
    tr = kinfu.track(nr, st, torch.from_numpy(depths[3]).to(dev))
    del df

    # ------------------------------------------------------------------ M
    gcfg = dataclasses.replace(DynamicFusionConfig.quality_dynamicfusion(), solver_p2p_adaptive=True)
    fields = {"preset": cs.gate_inputs(torch, gcfg, st, tr)}
    fields.update({name: tuple(torch.from_numpy(a).to(dev) for a in cs.gate_case(name)) for name in ("random", "vga")})
    max_rows, _, strip = kernels.p2p_gate_plan()
    for rows_m in (120, 240, 480, max_rows):
        n = ctypes.c_int(0)
        rc = occupancy.df_p2p_gate_clusters(rows_m, ctypes.byref(n))
        print(f"[plan] {card} | M: {n.value} clusters of 11 CTAs at once at {rows_m} rows (error {rc}); "
              f"a map of W columns launches ceil(W / {strip})", flush=True)
    for tag, gin in fields.items():
        ref = kinfu.p2p_gate_kernel(gcfg, *gin)
        calls = {"kernel": lambda gin=gin: kinfu.p2p_gate_kernel(gcfg, *gin)}
        for name, lib in libs.items():
            # the variants at the 160x120 maps (some take more shared
            # memory than a CTA has at 480 rows)
            if not name.startswith("M ") or tag == "vga":
                continue

            def call(lib=lib, gin=gin):
                with library(kernels, lib):
                    return kinfu.p2p_gate_kernel(gcfg, *gin)

            got = call()
            if "probe" not in name and not (cs.same_bits(torch, got[0], ref[0]) and torch.equal(got[1], ref[1])):
                print(f"M {tag}: {name} differs from the kernel: not timed", file=sys.stderr)
                bad.append(f"{name} ({tag})")
                continue
            calls[name[2:]] = call
        calls["reference"] = lambda gin=gin: kinfu.p2p_gate_kernel(gcfg, *gin, reference=True)
        calls["library"] = lambda gin=gin: cs.library_p2p_gate(torch, gcfg, *gin)
        calls["plain"] = lambda gin=gin: kinfu.p2p_gate(gcfg, *gin, plain=True)
        timed(f"M {tag} ({gin[3].shape[1]}x{gin[3].shape[0]})", calls)

    # ------------------------------------------------------------------ F1
    dense = dataclasses.replace(nr, integrate_mode="dense")
    vol2cam = se3.compose(se3.inverse(tr.pose), kinfu._vol_pose(dense, dev))
    on = torch.ones((), dtype=torch.bool, device=dev)
    scratch = TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
    for tag, pose in cs.dense_poses(torch, dense, vol2cam).items():
        def fuse(pose=pose, reference=False):
            tsdf_ops.integrate_dense(dense, scratch, tr.dists, pose, dense.intr, on, reference=reference)

        def fused(lib=None, pose=pose):
            v = TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
            with library(kernels, lib or kernels._lib):
                tsdf_ops.integrate_dense(dense, v, tr.dists, pose, dense.intr, on)
            return v

        ref = fused()
        calls = {"kernel": fuse}
        for name, lib in libs.items():
            if not name.startswith("F1 "):
                continue
            if "probe" not in name and not cs.same_volume(torch, fused(lib), ref):
                print(f"F1 {tag}: {name} differs from the kernel: not timed", file=sys.stderr)
                bad.append(f"{name} ({tag})")
                continue

            def call(lib=lib, pose=pose):
                with library(kernels, lib):
                    tsdf_ops.integrate_dense(dense, scratch, tr.dists, pose, dense.intr, on)

            calls[name[3:]] = call
        calls["reference"] = lambda pose=pose: fuse(pose, reference=True)
        if tag == "tracked":
            calls["plain"] = lambda pose=pose: tsdf_ops.integrate_dense(dense, scratch, tr.dists, pose, dense.intr, on,
                                                                         plain=True)
        timed(f"F1 {tag} ({dense.volume_dims}^3)", calls)
    print(json.dumps({"card": card, "median_ms_by_run": times, "differ": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
