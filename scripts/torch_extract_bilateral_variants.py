"""Kernels L and A, their design choices timed on the card.

Kernel L (``csrc/extract.cu``, entry ``df_extract_cloud``): the row
listing as it is (a warp a k-row of voxels, 64 rows a block; pass 1
keeping each row's crossing bits and counting, its row loop unrolled by
4, the last block's scan; pass 2 a programmatic dependent launch reading
the bits, gathering t0 and t1 at the crossings, then the flags and the
NaN rows) beside variants of the same source with one choice changed:
pass 2 re-reading the three rows of every row instead of the bits
(``reread``), 32 and 128 rows a block (``rows32``, ``rows128``), the
scan in a launch of its own (``scan_launch``), pass 1's row loop not
unrolled and unrolled by 2 (``unroll1``, ``unroll2``), pass 2 launched
after pass 1 ends (``no_pdl``), every row's defaults (NaN, flag 0)
written by pass 1 while the volume streams in (``fill_pass1``), the
i16/u16 pair through the other pairs' per-voxel float tests instead of
its two-voxels-a-word tests (``float_lanes``), its runs loaded through
``ld.global.nc`` without and with an ``L2::256B`` prefetch hint (``nc``,
``nc_l2_256``); beside its reference mode (the design before: four
launches over tiles of the concatenated tests), the library route
(``chip_smoke.library_extract``) and a copy of the volume (``copy``, a
yardstick of the card's rate). Shapes: ``default_dynamicfusion()``'s
frame-0 volume of the deforming scene (256^3) as i16/u16 and re-encoded
as f32/f32, into 1 << 20 rows, and ``default_kinfu()``'s (512^3). The
probes return from pass 2 at once (``probe_count``: pass 1 and the scan
alone), skip its flags and NaN rows (``probe_no_fill``) or its gathers
(``probe_no_gather``); their results are wrong and not held.

Kernel A (``csrc/bilateral.cu``, entry ``df_bilateral``): the tiled
filter as it is (32x4 threads, a pixel a thread, the tile and halo in
shared memory, the spatial table, the interior blocks without the marker
test) beside 2 and 4 consecutive pixels a thread (``px2``, ``px4``),
32x2 and 32x8 threads (``by2``, ``by8``), 2 pixels a thread in 32x8
blocks (``px2_by8``, the first design) and every block through the
marker test (``no_interior``);
beside its reference mode (a thread a pixel, the design before), the
plain version and the library route (``chip_smoke.library_bilateral``).
Shapes: the rigid slice's noisy 640x480 frame and
``chip_smoke.border_frame(480, 640)``.

    python3 scripts/torch_extract_bilateral_variants.py [--rounds 3] [--runs 2]

Variants are built with the kernels' nvcc flags into libraries of their
own by text substitution (the anchors must match the sources: edit both
together; check them on the CPU with ``check_anchors()``) and launched
through the port's wrappers with the variant's library in place. Each
variant is held bit for bit against the kernel (L's points, flags and
count; A's output). Times by ``chip_smoke.cuda_ms`` (CUDA events, 20
calls); the variants take turns, ``--rounds`` times, in each of ``--runs``
runs, the order reversed from one run to the next. Prints the card, each
variant's registers and spills, each run's median with the spread
between the runs' medians, and a JSON line of every run's medians.
"""

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# pass 2 re-reading the rows: the row's tests (pass 1's loads and tests),
# each crossing's point from the values in registers
_REREAD = r'''template <typename T>
__device__ __forceinline__ void put_values(const Place<T>& p, int rank, int axis, int i, int j, int k, float t0,
                                           float t1) {
  if (rank >= p.max_points) return;
  const float den = t0 - t1;
  const float alpha = t0 / (fabsf(den) > 1e-12f ? den : 1e-12f);
  const float fi = static_cast<float>(i) + (axis == 0 ? alpha : 0.0f);
  const float fj = static_cast<float>(j) + (axis == 1 ? alpha : 0.0f);
  const float fk = static_cast<float>(k) + (axis == 2 ? alpha : 0.0f);
  float* q = p.points + 3 * static_cast<size_t>(rank);
  q[0] = fi * p.vs + p.ox;
  q[1] = fj * p.vs + p.oy;
  q[2] = fk * p.vs + p.oz;
}

template <typename T, typename W, int V>
__global__ void __launch_bounds__(kRowThreads)
row_reread_kernel(RowVol<T, W> v, Place<T> p, const int* __restrict__ offsets, int nblocks,
                  const int* __restrict__ count, bool* __restrict__ valid) {
  using L = FloatLanes<T, W, V>;
  constexpr int D = 32 * V;
  __shared__ int sm[2][3][kRowWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) base[a] = offsets[a * nblocks + blockIdx.x];
  for (int k = 0; k < kRounds; ++k) {
    const int r = blockIdx.x * kRowsPerBlock + k * kRowWarps + warp;
    const int i = r / D, j = r % D, k0 = lane * V, at = r * D + k0;
    const typename L::State own = L::load(v, at);
    typename L::State x, y;
    unsigned m[3] = {0u, 0u, 0u};
    if (i < D - 1) {
      x = L::load(v, at + D * D);
      m[0] = L::cross(own, x);
    }
    if (j < D - 1) {
      y = L::load(v, at + D);
      m[1] = L::cross(own, y);
    }
    m[2] = L::cross_z(own, lane);
    float tz[V];
#pragma unroll
    for (int q = 0; q < V - 1; ++q) tz[q] = own.t[q + 1];
    tz[V - 1] = __shfl_down_sync(kFull, own.t[0], 1);
    int cnt[3], incl[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      cnt[a] = __popc(m[a]);
      incl[a] = warp_incl_scan(cnt[a], lane);
      if (lane == 31) sm[k & 1][a][warp] = incl[a];
    }
    __syncthreads();
    int rank[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w) {
        const int c = sm[k & 1][a][w];
        before += w < warp ? c : 0;
        total += c;
      }
      rank[a] = base[a] + before + incl[a] - cnt[a];
      base[a] += total;
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if ((m[0] >> q) & 1u) put_values(p, rank[0]++, 0, i, j, k0 + q, own.t[q], x.t[q]);
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if ((m[1] >> q) & 1u) put_values(p, rank[1]++, 1, i, j, k0 + q, own.t[q], y.t[q]);
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if ((m[2] >> q) & 1u) put_values(p, rank[2]++, 2, i, j, k0 + q, own.t[q], tz[q]);
    }
  }
  const int n = min(count[0], p.max_points);
  const float nan = __int_as_float(0x7fc00000);
  for (int r = blockIdx.x * kRowThreads + threadIdx.x; r < p.max_points; r += nblocks * kRowThreads) {
    valid[r] = r < n;
    if (r >= n) {
      p.points[3 * static_cast<size_t>(r)] = nan;
      p.points[3 * static_cast<size_t>(r) + 1] = nan;
      p.points[3 * static_cast<size_t>(r) + 2] = nan;
    }
  }
}

template <int V>
struct Lanes'''
_LANES = "template <int V>\nstruct Lanes"
_MASK_STORE = "      masks[(a * kRows + r) * 32 + lane] = static_cast<Bits<V>>(m[a]);\n"
_WRITE_LAUNCH = ("        const int rc = launch_write<T, V>(p, bits, static_cast<const int*>(offsets), nblocks,\n"
                 "                                          static_cast<const int*>(count), static_cast<bool*>(valid), st);\n")
_ROWS = "constexpr int kRowsPerBlock = 64;"
_UNROLL = "#pragma unroll 4\n  for (int k = 0; k < kRounds; ++k) {\n    const int r = r0 + k"
_SCAN_ONLY = r'''__global__ void __launch_bounds__(kRowThreads)
scan_only_kernel(const int* __restrict__ counts, int* __restrict__ offsets, int nblocks, int* __restrict__ count) {
  scan_block_counts(counts, offsets, nblocks, count);
}

template <int V>
struct Lanes'''
L_VARIANTS = {
    "kernel": [],
    "reread": [("extract.cu", _LANES, _REREAD), ("extract.cu", _MASK_STORE, ""),
               ("extract.cu", _WRITE_LAUNCH,
                "        row_reread_kernel<T, W, V><<<nblocks, kRowThreads, 0, st>>>(v, p, "
                "static_cast<const int*>(offsets), nblocks,\n            static_cast<const int*>(count), "
                "static_cast<bool*>(valid));\n        const int rc = static_cast<int>(cudaGetLastError());\n")],
    **{f"rows{k}": [("extract.cu", _ROWS, f"constexpr int kRowsPerBlock = {k};")] for k in (32, 128)},
    "scan_launch": [
        ("extract.cu", _LANES, _SCAN_ONLY),
        ("extract.cu", "  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(nblocks - 1);",
         "  if (threadIdx.x == 0) last = false;"),
        ("extract.cu", "        ++*ran;\n        const Place<T> p{",
         "        ++*ran;\n        scan_only_kernel<<<1, kRowThreads, 0, st>>>(static_cast<const int*>(counts), "
         "static_cast<int*>(offsets), nblocks, static_cast<int*>(count));\n        ++*ran;\n        const Place<T> p{"),
    ],
    **{f"unroll{k}": [("extract.cu", _UNROLL, _UNROLL.replace("unroll 4", f"unroll {k}"))] for k in (1, 2)},
    # pass 2 launched after pass 1 ends (not a programmatic dependent launch)
    "no_pdl": [("extract.cu", "  cfg.numAttrs = 1;\n  return static_cast<int>(cudaLaunchKernelEx(&cfg, row_write_kernel",
                "  cfg.numAttrs = 0;\n  return static_cast<int>(cudaLaunchKernelEx(&cfg, row_write_kernel")],
    # every row's defaults (NaN, flag 0) written by pass 1 while the volume
    # streams in, pass 2 writing only the flags below the count
    "fill_pass1": [
        ("extract.cu", "                 int nblocks, unsigned int* __restrict__ ticket, int* __restrict__ count) {",
         "                 int nblocks, unsigned int* __restrict__ ticket, int* __restrict__ count,\n"
         "                 float* __restrict__ points, bool* __restrict__ valid, int max_points) {"),
        ("extract.cu", "  asm volatile(\"griddepcontrol.launch_dependents;\");",
         "  const int nthreads = nblocks * kRowThreads, tid = blockIdx.x * kRowThreads + threadIdx.x;\n"
         "  nan_rows(points, 0, max_points, nthreads, tid);\n"
         "  flag_rows(valid, 0, max_points, nthreads, tid);\n"
         "  asm volatile(\"griddepcontrol.launch_dependents;\");"),
        ("extract.cu", "  flag_rows(valid, n, p.max_points, nthreads, tid);\n"
                       "  nan_rows(p.points, n, p.max_points, nthreads, tid);\n",
         "  for (int r = tid; r < n; r += nthreads) valid[r] = true;\n"),
        ("extract.cu", "            static_cast<unsigned int*>(ticket), static_cast<int*>(count));",
         "            static_cast<unsigned int*>(ticket), static_cast<int*>(count), static_cast<float*>(points),\n"
         "            static_cast<bool*>(valid), max_points);"),
    ],
    "float_lanes": [("extract.cu", "                                             (V >= 2),",
                     "                                             (V >= 2) && false,")],
    # probes (not held: pass 2 does nothing, or writes no flags and NaN
    # rows): pass 1 and the scan alone; pass 2 without its fill
    "probe_count": [("extract.cu", "  __shared__ int sm[3][kRowsPerBlock];\n",
                     "  __shared__ int sm[3][kRowsPerBlock];\n  if (nblocks > 0) return;\n")],
    "probe_no_fill": [("extract.cu", "  flag_rows(valid, n, p.max_points, nthreads, tid);\n"
                                     "  nan_rows(p.points, n, p.max_points, nthreads, tid);\n", "")],
}
# 16-byte pieces of the i16/u16 runs through ld.global.nc with an L2
# prefetch hint (or none)
_LD = r'''template <typename S>
__device__ __forceinline__ S ld_hint(const void* p) {
  S s;
  if constexpr (sizeof(S) % 16 == 0) {
#pragma unroll
    for (int c = 0; c < static_cast<int>(sizeof(S) / 16); ++c) {
      uint4 x;
      asm("HINT {%0, %1, %2, %3}, [%4];" : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
          : "l"(static_cast<const char*>(p) + 16 * c));
      reinterpret_cast<uint4*>(&s)[c] = x;
    }
  } else {
    s = *reinterpret_cast<const S*>(p);
  }
  return s;
}

template <int V>
struct PairLanes {'''
_PAIR_LOADS = ("    const Words t = *reinterpret_cast<const Words*>(v.tsdf + at);\n"
               "    const Words w = *reinterpret_cast<const Words*>(v.weight + at);\n")
for _name, _op in (("nc", "ld.global.nc.v4.u32"), ("nc_l2_256", "ld.global.nc.L2::256B.v4.u32")):
    L_VARIANTS[_name] = [
        ("extract.cu", "template <int V>\nstruct PairLanes {", _LD.replace("HINT", _op)),
        ("extract.cu", _PAIR_LOADS, "    const Words t = ld_hint<Words>(v.tsdf + at);\n"
                                    "    const Words w = ld_hint<Words>(v.weight + at);\n"),
    ]
# a probe (not held): pass 2 without its gathers of t0 and t1
L_VARIANTS["probe_no_gather"] = [
    ("extract.cu", "  const float t0 = dfk::load_code(p.tsdf + a) * p.scale;\n"
                   "  const float t1 = dfk::load_code(p.tsdf + b) * p.scale;\n",
     "  const float t0 = static_cast<float>(a & 7) - 3.5f;\n  const float t1 = static_cast<float>(b & 7) + 0.5f;\n"),
]
# the rows a block of each L variant (the wrapper's grid)
L_ROWS = {"rows32": 32, "rows128": 128}
A_VARIANTS = {
    "kernel": [],
    **{f"px{k}": [("bilateral.cu", "constexpr int kPx = 1;", f"constexpr int kPx = {k};")] for k in (2, 4)},
    **{f"by{k}": [("bilateral.cu", "constexpr int kBx = 32, kBy = 4;", f"constexpr int kBx = 32, kBy = {k};")]
       for k in (2, 8)},
    "px2_by8": [("bilateral.cu", "constexpr int kBx = 32, kBy = 4;", "constexpr int kBx = 32, kBy = 8;"),
                ("bilateral.cu", "constexpr int kPx = 1;", "constexpr int kPx = 2;")],
    "no_interior": [("bilateral.cu", "  const bool interior = x0 >= H", "  const bool interior = false && x0 >= H")],
}


def check_anchors(csrc=HERE / "dynamicfusion_tpu_torch" / "csrc"):
    """Every variant's anchors occur once in their sources (no card needed)."""
    for variants in (L_VARIANTS, A_VARIANTS):
        for name, subs in variants.items():
            for f, a, _ in subs:
                if (csrc / f).read_text().count(a) != 1:
                    raise RuntimeError(f"{name}: anchor not found once in {f}: {a!r}")


@contextlib.contextmanager
def library(kernels, lib, rows=None):
    """The port's wrappers launch from ``lib`` inside the block (L's grid
    for ``rows`` rows a block)."""
    prev, prev_rows = kernels._lib, kernels.EXTRACT_ROWS
    kernels._lib = lib
    kernels.EXTRACT_ROWS = rows or prev_rows
    try:
        yield
    finally:
        kernels._lib = prev
        kernels.EXTRACT_ROWS = prev_rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=3, help="turns of every variant in a run")
    ap.add_argument("--runs", type=int, default=2, help="runs, the variants' order reversed from one to the next")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_extract_bilateral_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(HERE / "scripts"))
    import chip_smoke as cs
    from torch_data_term_variants import bind, build, median, turns
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.ops import preprocess, tsdf as tsdf_ops
    from dynamicfusion_tpu_torch.pipeline import kinfu

    check_anchors()
    card = cs.smi()
    print(card, flush=True)
    kernels.load()
    tmp = Path(tempfile.mkdtemp(prefix="extract_bilateral_variants_"))
    procs = {f"L {name}": build(kernels, name, "extract.cu", subs, tmp) for name, subs in L_VARIANTS.items()}
    procs.update({f"A {name}": build(kernels, name, "bilateral.cu", subs, tmp) for name, subs in A_VARIANTS.items()})
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        lines = log.splitlines()
        regs, spills = [], []
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and ("row_" in ln or "bilateral_tile" in ln):
                for x in lines[i + 1:i + 4]:
                    if "registers" in x:
                        regs.append(int(x.split("Used ")[1].split(" registers")[0]))
                    if "spill stores" in x:
                        spills.append(int(x.split("bytes spill stores")[0].split(",")[-1]))
        print(f"[ptxas] {name}: {len(regs)} entries, registers {min(regs)}-{max(regs)}, most spill stores "
              f"{max(spills)} bytes", flush=True)
        libs[name] = bind(kernels, so, ["df_extract_cloud"] if name.startswith("L ") else ["df_bilateral"])

    dev = torch.device("cuda")
    times = {}

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

    # ------------------------------------------------------------------ A
    rigid = DynamicFusionConfig.rigid_slice()
    d0 = cs.rigid_frame_fn(rigid)(0).astype(np.int32)
    noisy = np.where(d0 > 0, d0 + np.random.RandomState(0).randint(-3, 4, d0.shape), 0).astype(np.uint16)
    a_args = (rigid.bilateral_kernel_size, rigid.bilateral_sigma_spatial, rigid.bilateral_sigma_depth)
    for sname, frame in (("noisy 640x480", noisy), ("border 640x480", cs.border_frame(480, 640, 1))):
        depth = torch.from_numpy(frame).to(dev)
        ref = kernels.bilateral_filter(depth, *a_args)
        calls = {}
        for name, lib in libs.items():
            if not name.startswith("A "):
                continue

            def call(lib=lib):
                with library(kernels, lib):
                    return kernels.bilateral_filter(depth, *a_args)

            if not torch.equal(call(), ref):
                print(f"A {sname}: {name} differs from the kernel", file=sys.stderr)
                return 1
            calls[name[2:]] = call
        calls["reference"] = lambda: kernels.bilateral_filter(depth, *a_args, reference=True)
        calls["library"] = lambda: cs.library_bilateral(torch, depth, *a_args)
        calls["plain"] = lambda: preprocess.bilateral_filter_plain(depth, *a_args)
        timed(f"A {sname}", calls)

    # ------------------------------------------------------------------ L
    vols = []
    for cfg in (DynamicFusionConfig.default_dynamicfusion(), DynamicFusionConfig.default_kinfu()):
        depths = synthetic.deforming_frames(cfg.intr, cfg.rows, cfg.cols, 1)
        df = kinfu.DynamicFusion(cfg, device=dev)
        df(depths[0])
        vols.append((f"{cfg.volume_dims}^3 i16/u16", cfg, df.state.vol))
        if cfg.volume_dims == 256:
            vols.append(("256^3 f32/f32", *cs.stored(cfg, df.state.vol, "f32", "f32")))
        del df
    for sname, cfg, vol in vols:
        maxp = max(cfg.max_nodes * cfg.node_sample_step, 1 << 20)
        org = tuple(float(v) for v in cfg.volume_origin)

        def run(reference=False, vol=vol, maxp=maxp, org=org, cfg=cfg):
            return kernels.extract_cloud(vol.tsdf, vol.weight, 1.0, maxp, cfg.voxel_size, org, reference=reference)

        ref = run()
        calls = {}
        for name, lib in libs.items():
            if not name.startswith("L "):
                continue

            def call(lib=lib, rows=L_ROWS.get(name[2:])):
                with library(kernels, lib, rows):
                    return run()

            got = call()
            if "probe" not in name and not (torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
                                            and cs.same_map(torch, got[0], ref[0])):
                print(f"L {sname}: {name} differs from the kernel", file=sys.stderr)
                return 1
            calls[name[2:]] = call
        calls["reference"] = lambda run=run: run(reference=True)
        calls["library"] = lambda cfg=cfg, vol=vol, maxp=maxp: cs.library_extract(torch, cfg, vol, maxp, 1.0)
        # a yardstick of the card's copy rate: the volume read and written once
        calls["copy"] = lambda vol=vol: (vol.tsdf.clone(), vol.weight.clone())
        timed(f"L {sname} ({int(ref[2])} crossings)", calls)
    print(json.dumps({"card": card, "median_ms_by_run": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
