"""Kernel G's block inverse and kernel I's frame maps, their design choices
timed on the card.

Kernel G's spd6_inv (``csrc/pcg.cu``, entry ``df_spd6_inv``): the damped
entry as it is (a thread a node in blocks of 16, each node read and its
inverse written in place) beside variants of the same source with one
choice changed: 8, 32 and 128 nodes a block (``nodes8``, ``nodes32``,
``nodes128``), and blocks of 128 threads whose 16 nodes are staged in
shared memory, inverted there by one thread each and stored as coalesced
float4s, the staging by float4 loads into rows padded to 37 floats
(``staged``; with 32 nodes, the first design of this entry: ``staged32``)
or by one bulk asynchronous copy on an mbarrier (``bulk``); beside the
composition it replaced in the LM loop (two damping kernels,
``diag_embed`` and the add, the reference mode, ``where``), the reference
mode alone, the damped entry with rebuild false (``kept``), the undamped
entry, the plain version and ``torch.linalg.inv``. Shape: the preset's
damped blocks (1 024 nodes of ``default_dynamicfusion()`` after three
frames of the deforming scene, the next frame tracked).

Kernel I's frame maps (``csrc/preprocess.cu``, entry ``df_frame_maps``):
the multi-map entry as it is (a pixel a thread, 128 threads a block)
beside 2 and 4 consecutive pixels a thread with vector loads and stores
(``px2``, ``px4``), 64 and 256 threads (``threads64``, ``threads256``), at
most 264 or 528 blocks a task with each thread looping over its pixels
(``grid264``, ``grid528``) and a warp a strip of 31 columns by 1 or 2 rows
sharing its back-projections by shuffles (``strip1``, ``strip2``), and
two probes whose maps are wrong and not held: no pixel computed
(``probe_empty``, the launch and its blocks) and the divisions of the
back-projection and the normal as products by reciprocals
(``probe_mul``); beside the design before (the single-map kernel, a
launch a map, normals and all, as the parent's frame made them) and that
kernel at each of the preset frame's four shapes (640x480 with the
confidence, 160x120, 80x60, the raw 160x120 at stride 4). Task sets: the
preset frame's (``kinfu.track_maps``), the rigid step's (levels 2 and 3),
``reference_parity()``'s (levels 0-3 and the raw points at stride 1) and
the depth-variant ICP's eight point maps.

    python3 scripts/torch_spd6_maps_variants.py [--rounds 3] [--runs 2] [--parent DIR]

Variants are built with the kernels' nvcc flags into libraries of their
own by text substitution (the anchors must match the sources: edit both
together; check them on the CPU with ``check_anchors()``) and launched
through the port's wrappers with the variant's library in place. Each
variant but the probes is held bit for bit against the kernel (G's damp
and inverses, I's maps); one that differs is reported and not timed, and
the script then exits 1. ``--parent DIR`` also builds that tree's
``pcg.cu`` and ``preprocess.cu`` (the designs before: blocks of 128 nodes;
a launch a map) and times them at the same shapes. Times by
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

# the kernel as it is: a thread a node, read and written in place
_NODES_KERNEL = r'''template <bool kDamped>
__global__ void __launch_bounds__(kSpdNodes)
spd6_inv_nodes_kernel(const float* __restrict__ blocks, const float* __restrict__ diag_eff,
                      const float* __restrict__ unit, const float* __restrict__ lm_lambda,
                      const bool* __restrict__ rebuild, int n, float* __restrict__ out, float* __restrict__ damp) {
  const int i = blockIdx.x * kSpdNodes + threadIdx.x;
  if (i >= n) return;
  const float* m = blocks + 36 * static_cast<size_t>(i);
  float a[36];
  if constexpr (kDamped) {
    const float lam = *lm_lambda;
    float d[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const size_t g = 6 * static_cast<size_t>(i) + c;
      d[c] = lam * diag_eff[g] + unit[g];
      damp[g] = d[c];
    }
    if (!*rebuild) return;
#pragma unroll
    for (int e = 0; e < 36; ++e) a[e] = m[e] + (e % 7 == 0 ? d[e / 7] : 0.0f);
  } else {
#pragma unroll
    for (int e = 0; e < 36; ++e) a[e] = m[e];
  }
  spd6_inv_one(a, out + 36 * static_cast<size_t>(i));
}
'''
# the same in blocks of kSpdThreads threads whose kSpdNodes nodes are
# staged in shared rows (LOAD), each inverted by one thread in place, then
# stored as coalesced float4s
_TILE_KERNEL = r'''constexpr int kSpdThreads = 128;
constexpr int kSpdRow = ROW;

template <bool kDamped>
__global__ void __launch_bounds__(kSpdThreads)
spd6_inv_nodes_kernel(const float* __restrict__ blocks, const float* __restrict__ diag_eff,
                      const float* __restrict__ unit, const float* __restrict__ lm_lambda,
                      const bool* __restrict__ rebuild, int n, float* __restrict__ out, float* __restrict__ damp) {
  __shared__ alignas(16) float rows[kSpdNodes * kSpdRow];
  __shared__ float sd[kSpdNodes * 6];
  __shared__ alignas(8) unsigned long long bar;
  const int node0 = blockIdx.x * kSpdNodes;
  const int nodes = min(kSpdNodes, n - node0);
  const int t = threadIdx.x;
  if constexpr (kDamped) {
    const float lam = *lm_lambda;
    for (int q = t; q < 6 * nodes; q += kSpdThreads) {
      const size_t g = 6 * static_cast<size_t>(node0) + q;
      const float d = lam * diag_eff[g] + unit[g];
      damp[g] = d;
      sd[q] = d;
    }
    if (!*rebuild) return;
  }
LOAD  if (t < nodes) {
    float* r = rows + t * kSpdRow;
    float a[36], o[36];
#pragma unroll
    for (int e = 0; e < 36; ++e) {
      if constexpr (kDamped) {
        a[e] = r[e] + (e % 7 == 0 ? sd[6 * t + e / 7] : 0.0f);
      } else {
        a[e] = r[e];
      }
    }
    spd6_inv_one(a, o);
#pragma unroll
    for (int e = 0; e < 36; ++e) r[e] = o[e];
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(out + 36 * static_cast<size_t>(node0));
  for (int q = t; q < 9 * nodes; q += kSpdThreads) {
    const float* r = rows + (q / 9) * kSpdRow + 4 * (q % 9);
    dst[q] = make_float4(r[0], r[1], r[2], r[3]);
  }
}
'''
# coalesced float4 loads into rows padded to 37 floats (odd: a warp's 32
# rows on 32 banks)
_STAGE = '''  const float4* src = reinterpret_cast<const float4*>(blocks + 36 * static_cast<size_t>(node0));
  for (int q = t; q < 9 * nodes; q += kSpdThreads) {
    const float4 v = src[q];
    float* r = rows + (q / 9) * kSpdRow + 4 * (q % 9);
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  }
  __syncthreads();
'''
# the block's contiguous 144 B x nodes in one bulk asynchronous copy (the
# Tensor Memory Accelerator), completed on an mbarrier, into unpadded rows
_BULK = '''  const unsigned bar_a = static_cast<unsigned>(__cvta_generic_to_shared(&bar));
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    const unsigned bytes = 144u * static_cast<unsigned>(nodes);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_a), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(rows))),
                 "l"(blocks + 36 * static_cast<size_t>(node0)), "r"(bytes), "r"(bar_a)
                 : "memory");
  }
  asm volatile("{\\n .reg .pred p;\\n WAIT_%=:\\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\\n"
               " @!p bra WAIT_%=;\\n}" ::"r"(bar_a) : "memory");
'''
_NODES = "constexpr int kSpdNodes = 16;"


def _tile(load, row):
    """The tile design with ``load`` as its staging into rows of ``row``."""
    return [("pcg.cu", _NODES_KERNEL, _TILE_KERNEL.replace("LOAD", load).replace("ROW", str(row))),
            *[("pcg.cu", f"    spd6_inv_nodes_kernel<{d}><<<(n + kSpdNodes - 1) / kSpdNodes, kSpdNodes, 0, s>>>(",
               f"    spd6_inv_nodes_kernel<{d}><<<(n + kSpdNodes - 1) / kSpdNodes, kSpdThreads, 0, s>>>(")
              for d in ("true", "false")]]


G_VARIANTS = {
    "kernel": [],
    **{f"nodes{k}": [("pcg.cu", _NODES, f"constexpr int kSpdNodes = {k};")] for k in (8, 32, 128)},
    "staged": _tile(_STAGE, 37),
    "bulk": _tile(_BULK, 36),
    # the first tile design: float4 staging, 32 nodes a block
    "staged32": _tile(_STAGE, 37) + [("pcg.cu", _NODES, "constexpr int kSpdNodes = 32;")],
}
# the kernel as it is: a thread a pixel
_MAPS_KERNEL = r'''__global__ void __launch_bounds__(kMapThreads) frame_maps_kernel(const MapLaunch launch) {
  int ti = 0;
#pragma unroll 1
  while (ti + 1 < launch.n && static_cast<int>(blockIdx.x) >= launch.first_block[ti + 1]) ++ti;
  const MapTaskArgs& t = launch.t[ti];
  const int h = t.h, w = t.w;
  const int i = (static_cast<int>(blockIdx.x) - launch.first_block[ti]) * kMapThreads + threadIdx.x;
  if (i >= h * w) return;
  const int y = i / w, x = i - y * w;
  const uint16_t* depth = static_cast<const uint16_t*>(t.depth);
  float* const points = static_cast<float*>(t.points);
  float* const normals = static_cast<float*>(t.normals);
  float* const conf = static_cast<float*>(t.conf);
  float p[3], n[3], c;
  pixel_maps(Intr{t.fx, t.fy, t.cx, t.cy}, x, y, h, w, depth_m(depth, y, x, h, w, t.stride, t.src_cols),
             depth_m(depth, y, x + 1, h, w, t.stride, t.src_cols), depth_m(depth, y + 1, x, h, w, t.stride, t.src_cols),
             normals != nullptr, conf != nullptr, p, n, c);
  if (points != nullptr) {
#pragma unroll
    for (int a = 0; a < 3; ++a) points[3 * static_cast<size_t>(i) + a] = p[a];
  }
  if (normals != nullptr) {
#pragma unroll
    for (int a = 0; a < 3; ++a) normals[3 * static_cast<size_t>(i) + a] = n[a];
  }
  if (conf != nullptr) conf[i] = c;
}
'''
# kMapPx consecutive pixels of the flattened map a thread: where the width
# is a multiple of kMapPx at stride 1, the depth row and the row below
# loaded as kMapPx-wide vectors, and a full run's points and normals
# stored as three kMapPx-float vectors each, its confidence as one
_PX_KERNEL = r'''constexpr int kMapPx = PX;

struct alignas(2 * kMapPx) DepthRun {
  uint16_t v[kMapPx];
};

// kMapPx floats at dst, aligned to their size, as one store
__device__ __forceinline__ void store_run(float* dst, const float* v) {
  if constexpr (kMapPx == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kMapPx == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < kMapPx; ++q) dst[q] = v[q];
  }
}

// task t's maps at its kMapPx pixels from i0 (< h w)
__device__ __forceinline__ void map_run(const MapTaskArgs& t, int i0) {
  const int h = t.h, w = t.w, npx = h * w;
  const Intr k{t.fx, t.fy, t.cx, t.cy};
  const uint16_t* __restrict__ depth = static_cast<const uint16_t*>(t.depth);
  const int y0 = i0 / w, x0 = i0 - y0 * w;
  float z00[kMapPx], z01[kMapPx], z10[kMapPx];
  if (t.stride == 1 && t.src_cols == w && w % kMapPx == 0 && reinterpret_cast<uintptr_t>(depth) % sizeof(DepthRun) == 0) {
    // the run lies in one row: the row and the row below as vectors
    const size_t at = static_cast<size_t>(y0) * w + x0;
    const DepthRun r0 = *reinterpret_cast<const DepthRun*>(depth + at);
#pragma unroll
    for (int q = 0; q < kMapPx; ++q) z00[q] = static_cast<float>(r0.v[q]) * 0.001f;
#pragma unroll
    for (int q = 0; q + 1 < kMapPx; ++q) z01[q] = z00[q + 1];
    z01[kMapPx - 1] = x0 + kMapPx < w ? static_cast<float>(__ldg(depth + at + kMapPx)) * 0.001f : 0.0f;
    if (y0 + 1 < h) {
      const DepthRun r1 = *reinterpret_cast<const DepthRun*>(depth + at + w);
#pragma unroll
      for (int q = 0; q < kMapPx; ++q) z10[q] = static_cast<float>(r1.v[q]) * 0.001f;
    } else {
#pragma unroll
      for (int q = 0; q < kMapPx; ++q) z10[q] = 0.0f;
    }
  } else {
    int y = y0, x = x0;
#pragma unroll
    for (int q = 0; q < kMapPx; ++q) {
      z00[q] = depth_m(depth, y, x, h, w, t.stride, t.src_cols);
      z01[q] = depth_m(depth, y, x + 1, h, w, t.stride, t.src_cols);
      z10[q] = depth_m(depth, y + 1, x, h, w, t.stride, t.src_cols);
      if (++x == w) {
        x = 0;
        ++y;
      }
    }
  }
  const bool want_n = t.normals != nullptr, want_c = t.conf != nullptr;
  float p[3 * kMapPx], n[3 * kMapPx], c[kMapPx];
  {
    int y = y0, x = x0;
#pragma unroll
    for (int q = 0; q < kMapPx; ++q) {
      pixel_maps(k, x, y, h, w, z00[q], z01[q], z10[q], want_n, want_c, p + 3 * q, n + 3 * q, c[q]);
      if (++x == w) {
        x = 0;
        ++y;
      }
    }
  }
  float* const outs[2] = {static_cast<float*>(t.points), static_cast<float*>(t.normals)};
  const float* const vals[2] = {p, n};
  float* const conf = static_cast<float*>(t.conf);
  if (i0 + kMapPx <= npx) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (outs[m] != nullptr) {
#pragma unroll
        for (int j = 0; j < 3; ++j) store_run(outs[m] + 3 * static_cast<size_t>(i0) + j * kMapPx, vals[m] + j * kMapPx);
      }
    }
    if (conf != nullptr) store_run(conf + i0, c);
  } else {
    const int nq = npx - i0;
#pragma unroll
    for (int q = 0; q < kMapPx; ++q) {
      if (q >= nq) break;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (outs[m] != nullptr) {
#pragma unroll
          for (int a = 0; a < 3; ++a) outs[m][3 * static_cast<size_t>(i0 + q) + a] = vals[m][3 * q + a];
        }
      }
      if (conf != nullptr) conf[i0 + q] = c[q];
    }
  }
}

__global__ void __launch_bounds__(kMapThreads) frame_maps_kernel(const MapLaunch launch) {
  int ti = 0;
#pragma unroll 1
  while (ti + 1 < launch.n && static_cast<int>(blockIdx.x) >= launch.first_block[ti + 1]) ++ti;
  const MapTaskArgs& t = launch.t[ti];
  const int i0 = ((static_cast<int>(blockIdx.x) - launch.first_block[ti]) * kMapThreads + threadIdx.x) * kMapPx;
  if (i0 < t.h * t.w) map_run(t, i0);
}
'''
_BLOCKS_I = "    blocks += (static_cast<long long>(t.h) * t.w + kMapThreads - 1) / kMapThreads;\n"
I_VARIANTS = {
    "kernel": [],
    **{f"px{k}": [("preprocess.cu", _MAPS_KERNEL, _PX_KERNEL.replace("PX", str(k))),
                  ("preprocess.cu", _BLOCKS_I, "    blocks += (static_cast<long long>(t.h) * t.w + kMapThreads * kMapPx "
                                               "- 1) / (kMapThreads * kMapPx);\n")] for k in (2, 4)},
    **{f"threads{k}": [("preprocess.cu", "constexpr int kMapThreads = 128; ", f"constexpr int kMapThreads = {k}; ")]
       for k in (64, 256)},
    # probes (not held): no pixel computed or stored (the launch and its
    # blocks); the divisions of the back-projection and the normal as
    # products by reciprocals
    "probe_empty": [("preprocess.cu", "  if (i >= h * w) return;\n", "  if (i >= 0) return;\n")],
    "probe_mul": [("preprocess.cu", "  p[0] = z * (u - k.cx) / k.fx;\n  p[1] = z * (v - k.cy) / k.fy;\n",
                   "  p[0] = z * (u - k.cx) * (1.0f / k.fx);\n  p[1] = z * (v - k.cy) * (1.0f / k.fy);\n"),
                  ("preprocess.cu", "  for (int a = 0; a < 3; ++a) n[a] = -(n[a] / nn);\n",
                   "  for (int a = 0; a < 3; ++a) n[a] = -(n[a] * (1.0f / nn));\n")],
}
# a warp a strip of 31 columns x kStripRows rows: a lane's column of
# kStripRows + 1 back-projected points, its right neighbour's points by a
# shuffle (lane 31 only provides), so a pixel back-projects ~1.3 points, not 3
_STRIP = r'''constexpr int kStripRows = ROWS;

__global__ void __launch_bounds__(kMapThreads) frame_maps_kernel(const MapLaunch launch) {
  int ti = 0;
#pragma unroll 1
  while (ti + 1 < launch.n && static_cast<int>(blockIdx.x) >= launch.first_block[ti + 1]) ++ti;
  const MapTaskArgs& t = launch.t[ti];
  const int h = t.h, w = t.w;
  const int lane = threadIdx.x & 31;
  const int warp = ((static_cast<int>(blockIdx.x) - launch.first_block[ti]) * kMapThreads + threadIdx.x) >> 5;
  const int tiles_x = (w + 30) / 31;
  const int ty = warp / tiles_x, tx = warp - ty * tiles_x;
  const int y0 = ty * kStripRows;
  if (y0 >= h) return;
  const int x = tx * 31 + lane;
  const Intr k{t.fx, t.fy, t.cx, t.cy};
  const uint16_t* __restrict__ depth = static_cast<const uint16_t*>(t.depth);
  float P[kStripRows + 1][3], Z[kStripRows + 1];
#pragma unroll
  for (int r = 0; r <= kStripRows; ++r) {
    Z[r] = depth_m(depth, y0 + r, x, h, w, t.stride, t.src_cols);
    backproject(k, static_cast<float>(x), static_cast<float>(y0 + r), Z[r], P[r]);
  }
  float* const points = static_cast<float*>(t.points);
  float* const normals = static_cast<float*>(t.normals);
  float* const conf = static_cast<float*>(t.conf);
#pragma unroll
  for (int r = 0; r < kStripRows; ++r) {
    const int y = y0 + r;
    float v01[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) v01[a] = __shfl_down_sync(0xffffffffu, P[r][a], 1);
    const float z01 = __shfl_down_sync(0xffffffffu, Z[r], 1);
    if (lane == 31 || x >= w || y >= h) continue;
    const float* v00 = P[r];
    const float* v10 = P[r + 1];
    const size_t i = static_cast<size_t>(y) * w + x;
    const bool valid = (Z[r] * z01 * Z[r + 1]) != 0.0f && x < w - 1 && y < h - 1;
    if (points != nullptr) {
#pragma unroll
      for (int a = 0; a < 3; ++a) points[3 * i + a] = valid ? v00[a] : nan_f();
    }
    if (normals == nullptr && conf == nullptr) continue;
    const float a0 = v01[0] - v00[0], a1 = v01[1] - v00[1], a2 = v01[2] - v00[2];
    const float b0 = v10[0] - v00[0], b1 = v10[1] - v00[1], b2 = v10[2] - v00[2];
    float n[3] = {a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0};
    const float nn = fmaxf(sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]), 1e-12f);
#pragma unroll
    for (int a = 0; a < 3; ++a) n[a] = -(n[a] / nn);
    if (normals != nullptr) {
#pragma unroll
      for (int a = 0; a < 3; ++a) normals[3 * i + a] = valid ? n[a] : nan_f();
    }
    if (conf != nullptr) {
      float c = 0.0f;
      if (valid) {
        const float pn = fmaxf(sqrtf(v00[0] * v00[0] + v00[1] * v00[1] + v00[2] * v00[2]), 1e-9f);
        c = fabsf(n[0] * (v00[0] / pn) + n[1] * (v00[1] / pn) + n[2] * (v00[2] / pn));
        if (isnan(c)) c = 0.0f;
      }
      conf[i] = c;
    }
  }
}

'''
_STRIP_BLOCKS = ("    blocks += ((static_cast<long long>(t.w) + 30) / 31 * ((t.h + kStripRows - 1) / kStripRows) * 32 "
                 "+ kMapThreads - 1) / kMapThreads;\n")
for _r in (1, 2):
    I_VARIANTS[f"strip{_r}"] = [("preprocess.cu", _MAPS_KERNEL, _STRIP.replace("ROWS", str(_r))),
                                ("preprocess.cu", _BLOCKS_I, _STRIP_BLOCKS)]


def check_anchors(csrc=HERE / "dynamicfusion_tpu_torch" / "csrc"):
    """Every variant's anchors occur once in their sources (no card needed)."""
    for variants in (G_VARIANTS, I_VARIANTS):
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
    ap.add_argument("--parent", default=None, help="a tree whose pcg.cu and preprocess.cu to time beside them")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_spd6_maps_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(HERE / "scripts"))
    import chip_smoke as cs
    from torch_data_term_variants import bind, build, median, turns
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.ops import preprocess
    from dynamicfusion_tpu_torch.pipeline import kinfu
    from dynamicfusion_tpu_torch.solvers import icp, warp_solver as ws

    check_anchors()
    card = cs.smi()
    print(card, flush=True)
    kernels.load()
    tmp = Path(tempfile.mkdtemp(prefix="spd6_maps_variants_"))
    procs = {f"G {name}": build(kernels, name, "pcg.cu", subs, tmp) for name, subs in G_VARIANTS.items()}
    procs.update({f"I {name}": build(kernels, name, "preprocess.cu", subs, tmp) for name, subs in I_VARIANTS.items()})
    if args.parent:
        pcsrc = Path(args.parent).resolve() / "dynamicfusion_tpu_torch" / "csrc"
        procs["G parent"] = build(kernels, "parent", "pcg.cu", [], tmp, csrc=pcsrc)
        procs["I parent"] = build(kernels, "parent", "preprocess.cu", [], tmp, csrc=pcsrc)
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and ("spd6" in ln or "maps" in ln or "points_normals" in ln):
                props = [x.split("info    :")[-1].strip() for x in lines[i + 1:i + 4]
                         if "registers" in x or "spill" in x]
                fn = ln.split("'")[1] if "'" in ln else ln
                print(f"[ptxas] {name}: {fn}: " + " | ".join(props), flush=True)
        if name == "G parent":
            lib = ctypes.CDLL(str(so))
            lib.df_spd6_inv.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            lib.df_spd6_inv.restype = ctypes.c_int
            libs[name] = lib
        elif name == "I parent":
            libs[name] = bind(kernels, so, ["df_points_normals"])
        else:
            libs[name] = bind(kernels, so, ["df_spd6_inv"] if name.startswith("G ") else ["df_frame_maps"])

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

    # ------------------------------------------------------------------ G
    cfg = DynamicFusionConfig.default_dynamicfusion()
    depths = synthetic.deforming_frames(cfg.intr, cfg.rows, cfg.cols, 5)
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in depths[:3]:
        df(d)
    st = df.state
    tr = kinfu.track(cfg, st, torch.from_numpy(depths[3]).to(dev))
    s = ws.prepare(cfg, st.warp, tr.inputs)
    used, stride = ws.row_mode(cfg)
    dt = ws.data_term(cfg, s, st.warp.dq, True, row_stride=stride)
    et = ws.edge_term(cfg, s, st.warp.dq)
    blocks = dt.blocks + et.diag
    diag_eff, unit = ws.damping_terms(cfg, st.warp.active, blocks)
    n = blocks.shape[0]
    lm = torch.full((), cfg.solver_lm_lambda_init, device=dev)
    on, off = torch.ones((), dtype=torch.bool, device=dev), torch.zeros((), dtype=torch.bool, device=dev)
    minv0 = torch.empty_like(blocks)
    damp0 = kernels.spd6_inv_damped(blocks, diag_eff, unit, lm, on, minv0)
    calls = {}
    for name, lib in libs.items():
        if not name.startswith("G ") or name == "G parent":
            continue
        minv = torch.empty_like(blocks)

        def call(lib=lib, minv=minv, flag=on):
            with library(kernels, lib):
                return kernels.spd6_inv_damped(blocks, diag_eff, unit, lm, flag, minv)

        got = call()
        if not (cs.same_bits(torch, got, damp0) and cs.same_bits(torch, minv, minv0)):
            print(f"G: {name} differs from the kernel: not timed", file=sys.stderr)
            bad.append(name)
            continue
        calls[name[2:]] = call
    kept = minv0.clone()
    calls["kept"] = lambda: kernels.spd6_inv_damped(blocks, diag_eff, unit, lm, off, kept)

    def composition():
        damp = lm * diag_eff + unit
        fresh = kernels.spd6_inv(blocks + torch.diag_embed(damp.reshape(n, 6)), reference=True)
        return damp, torch.where(on, fresh, minv0)

    m = blocks + torch.diag_embed(damp0.reshape(n, 6))
    calls["composition"] = composition
    calls["reference"] = lambda: kernels.spd6_inv(m, reference=True)
    calls["undamped"] = lambda: kernels.spd6_inv(m)
    if "G parent" in libs:
        out = torch.empty_like(m)
        stream = torch.cuda.current_stream().cuda_stream

        def parent():
            rc = libs["G parent"].df_spd6_inv(m.data_ptr(), n, out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"the parent's spd6_inv failed to launch: error {rc}")
            return out

        parent()
        if not cs.same_bits(torch, out, kernels.spd6_inv(m, reference=True)):
            print("G: the parent's kernel differs from the reference mode", file=sys.stderr)
            return 1
        calls["parent"] = parent
    calls["plain"] = lambda: ws.spd6_inv_damped(blocks, diag_eff, unit, lm, on, kept.clone(), plain=True)
    calls["library"] = lambda: torch.linalg.inv(m)
    timed(f"G {n} nodes", calls)

    # ------------------------------------------------------------------ I
    rng = np.random.RandomState(5)
    noisy = depths[4].astype(np.int32)
    noisy = np.where(noisy > 0, noisy + rng.randint(-3, 4, noisy.shape), 0)
    noisy = torch.from_numpy(np.where(rng.rand(*noisy.shape) < 0.01, 0, noisy).astype(np.uint16)).to(dev)
    rigid = DynamicFusionConfig.rigid_slice()
    parity = DynamicFusionConfig.reference_parity()
    sets = {}
    for tag, c, maps in (("preset", cfg, kinfu.track_maps(cfg)), ("rigid", rigid, dict(first_point_level=2)),
                         ("parity", parity, kinfu.track_maps(parity))):
        pyr = preprocess.build_frame_pyramid(c, noisy, **maps)
        sets[tag] = preprocess.pyramid_map_tasks(c, pyr[0], noisy, **maps)[0]
    pyr_r = preprocess.build_frame_pyramid(rigid, noisy)
    sets["depth_icp"] = icp.depth_map_tasks(rigid, pyr_r[0], pyr_r[0])
    for tag, tasks in sets.items():
        ref = kernels.frame_maps(tasks)
        calls = {}
        for name, lib in libs.items():
            if not name.startswith("I ") or name == "I parent":
                continue

            def call(lib=lib, tasks=tasks):
                with library(kernels, lib):
                    return kernels.frame_maps(tasks)

            if "probe" not in name and not all(cs.same_bits(torch, a, b) for ga, ra in zip(call(), ref)
                                               for a, b in zip(ga, ra)):
                print(f"I {tag}: {name} differs from the kernel: not timed", file=sys.stderr)
                bad.append(f"{name} ({tag})")
                continue
            calls[name[2:]] = call
        # the design before: a launch a map, normals and all (with the
        # confidence where the task asks for it)
        calls["reference"] = lambda tasks=tasks: [kernels.points_normals(t.depth, t.intr, t.stride, conf=t.conf)
                                                  for t in tasks]
        if "I parent" in libs:
            def parent(tasks=tasks):
                with library(kernels, libs["I parent"]):
                    return [kernels.points_normals(t.depth, t.intr, t.stride, conf=t.conf) for t in tasks]

            calls["parent"] = parent
        calls["plain"] = lambda tasks=tasks: preprocess.frame_maps(tasks, plain=True)
        timed(f"I {tag} ({len(tasks)} maps)", calls)
    # the single-map kernel at each of the preset frame's four shapes, as
    # the parent's frame launched it (and, with --parent, the parent's own)
    calls = {}
    for t in sets["preset"]:
        shape = f"{t.depth.shape[1] // t.stride}x{t.depth.shape[0] // t.stride}/{t.stride}{' conf' if t.conf else ''}"
        calls[f"reference {shape}"] = lambda t=t: kernels.points_normals(t.depth, t.intr, t.stride, conf=t.conf)
        if "I parent" in libs:
            def parent(t=t):
                with library(kernels, libs["I parent"]):
                    return kernels.points_normals(t.depth, t.intr, t.stride, conf=t.conf)

            calls[f"parent {shape}"] = parent
    timed("I the single-map kernel at the preset's shapes", calls)
    print(json.dumps({"card": card, "median_ms_by_run": times, "differ": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
