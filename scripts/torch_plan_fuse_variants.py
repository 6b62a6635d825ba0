"""Kernels K and D, their design choices timed on the card.

Kernel K (``csrc/classify.cu``, entry ``df_brick_plan``): the cluster
plan as it is (16 CTAs of 256 to 1024 threads, up to 4 lanes a brick's
classification, a brick a group of lanes at least, mip levels 6.. built in
every CTA's shared memory, the cluster a programmatic dependent launch
after the mip tiles) beside variants of the same source with one choice
changed: clusters of 4 and 8 CTAs (``cluster4``, ``cluster8``), at most 1
and 2 lanes a brick (``lanes1``, ``lanes2``), 2 and 4 bricks a group of
lanes (``bricks2``, ``bricks4``), CTAs of at most 512 threads
(``threads512``), of at least 32 (``min_threads32``), the top mip levels
built by the last tile block by a ticket in device memory (``tile_top``),
an ordinary launch after the tiles (``no_pdl``) and the corner loop not
unrolled for w = 1 and 2 (``generic_w``: the generic loop of any w);
beside its one-block mode (the design before) and the plain version. Shapes: the preset's plan
(``default_dynamicfusion()`` after three frames of the deforming scene,
the next frame tracked: 4 096 bricks at grid stride 8), the same on the
4 slabs of the sharded fusion (4 x 1 024 bricks, the slabs one after
another), and ``chip_smoke.PLAN_CASES``' ``kinfu_warped`` (32 768 bricks).

Kernel D (``csrc/fuse_bricks.cu``, entry ``df_fuse_bricks``): the
persistent grid as it is (4 blocks an SM of 256 threads, z-runs of 8
voxels, the x and y contractions in shared memory) beside 1, 2 and 8
blocks an SM (``blocks1``, ``blocks2``, ``blocks8``), blocks of 128 and
512 threads (``threads128``, ``threads512``), runs of 4 and 16 voxels
(``run4``, ``run16``), each voxel contracting the staged corners
itself (``no_shared_xy``) and a run inside one grid cell reading its
y-values once (``one_cell``); beside its reference mode (a block a slot)
and the plain version. Shapes: the same frame's non-rigid fusion (grid
stride 8, the blend quality, the packed lookup), its rigid fusion (stride
16), both fusing and gated (ok false).

    python3 scripts/torch_plan_fuse_variants.py [--rounds 3] [--runs 2]

Variants are built with the kernels' nvcc flags into libraries of their
own by text substitution (the anchors must match the sources: edit both
together; check them on the CPU with ``check_anchors()``) and launched
through the port's wrappers with the variant's library in place. Each
variant is held bit for bit against the kernel: K's classes and list, D's
volume. Times by ``chip_smoke.cuda_ms`` (CUDA events, 20 calls); the
variants take turns, ``--rounds`` times, in each of ``--runs`` runs, the
order of the variants reversed from one run to the next. Prints the card,
each variant's registers and spills, each run's median (and each round's
times) with the spread between the runs' medians, and a JSON line of
every run's medians.
The ``probe_*`` variants cut a part of the work to show where the time
goes (K's mip tiles alone, its cluster alone; D without its update rule):
their results are wrong and not held.
"""

import argparse
import contextlib
import ctypes
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# (file, anchor, replacement): each anchor must occur once in its source
K_VARIANTS = {
    "kernel": [],
    "cluster4": [("classify.cu", "constexpr int kPlanCluster = 16;", "constexpr int kPlanCluster = 4;")],
    "cluster8": [("classify.cu", "constexpr int kPlanCluster = 16;", "constexpr int kPlanCluster = 8;")],
    **{f"bricks{k}": [("classify.cu", "  const int want = per * L;", f"  const int want = (per * L + {k - 1}) / {k};")]
       for k in (2, 4)},
    "threads512": [("classify.cu", "constexpr int kPlanThreads = 1024;", "constexpr int kPlanThreads = 512;")],
    **{f"lanes{k}": [("classify.cu", "constexpr int kMaxBrickLanes = 4;", f"constexpr int kMaxBrickLanes = {k};")]
       for k in (1, 2)},
    "no_pdl": [("classify.cu", "  cfg.numAttrs = 2;", "  cfg.numAttrs = 1;")],
    "min_threads32": [("classify.cu", "constexpr int kPlanMinThreads = 256;", "constexpr int kPlanMinThreads = 32;")],
    # levels 6.. by the last tile block to finish (a ticket in device
    # memory, back at zero after it), none in the cluster's shared memory
    "tile_top": [
        ("classify.cu", "// one 32x32 tile of the image a block of 16x16 threads",
         "__device__ unsigned int g_tile_ticket = 0u;\n\n// one 32x32 tile of the image a block of 16x16 threads"),
        ("classify.cu", "        m.av[off + gy * w + gx] = av;\n      }\n    }\n  }\n}\n",
         """        m.av[off + gy * w + gx] = av;
      }
    }
  }
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  const int nblocks = static_cast<int>(gridDim.x * gridDim.y);
  if (tx == 0 && ty == 0) last = atomicAdd(&g_tile_ticket, 1u) == static_cast<unsigned int>(nblocks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int flat = ty * kQuad + tx;
  build_top_levels(m, flat, kQuad * kQuad);
  if (flat == 0) g_tile_ticket = 0u;
}
"""),
        ("classify.cu", "      if (m.levels > kTileLevels + 1) {\n        int h5, w5;",
         "      if (false) {\n        int h5, w5;"),
        ("classify.cu", "  if (m.levels > kTileLevels + 1) {\n    int hh = m.rows, ww = m.cols;",
         "  if (false) {\n    int hh = m.rows, ww = m.cols;"),
    ],
    # every w through the generic corner loop (no unrolled w = 1, 2)
    "generic_w": [("classify.cu", "  if (w == 1)\n", "  if (false)\n"),
                  ("classify.cu", "  else if (w == 2)\n", "  else if (false)\n")],
    # probes (not held: their results are wrong): the mip tiles and an
    # empty cluster launch; the cluster after tiles that do nothing
    "probe_tiles_only": [("classify.cu", "    if (rank == 0 && threadIdx.x == 0) write_gated(p);\n    return;\n  }\n",
                          "    if (rank == 0 && threadIdx.x == 0) write_gated(p);\n    return;\n  }\n  return;\n")],
    "probe_cluster_only": [("classify.cu", "  if (ok != nullptr && !*ok) return;\n  __shared__ float smin",
                            "  return;\n  __shared__ float smin")],
}
# a probe (held: the marks change nothing): CTA 0's thread 0 adds the
# global timer's ns between marks into g_probe (``df_probe`` reads and
# resets it): 0 from the tiles' first block's start to the end of the
# cluster's wait for the tiles (its first corner extents before it), 1
# the top mip levels, 2 the classification, 3 the first cluster barrier,
# 4 the counts, 5 the second barrier and the scan, 6 the lists, 7 the last
# barrier
_PMARK = "if (rank == 0 && threadIdx.x == 0) probe_mark({});\n"
K_PHASES = ("tiles to the wait", "top levels", "classify", "barrier 1", "counts", "barrier 2 and scan", "lists",
            "barrier 3")
K_VARIANTS["probe_phases"] = [
    ("classify.cu", "__device__ __forceinline__ float inf_f()", """__device__ unsigned long long g_probe[9];
__device__ __forceinline__ void probe_mark(int k) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (k >= 0) g_probe[k] += now - g_probe[8];
  g_probe[8] = now;
}

__device__ __forceinline__ float inf_f()"""),
    ("classify.cu", "  if (ok != nullptr && !*ok) return;\n  __shared__ float smin",
     "  if (ok != nullptr && !*ok) return;\n  if (blockIdx.x + blockIdx.y + threadIdx.x + threadIdx.y == 0) "
     "probe_mark(-1);\n  __shared__ float smin"),
    ("classify.cu", "      asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n",
     "      asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n      " + _PMARK.format(0)),
    ("classify.cu", "        top.n = top_n;\n      }\n", "        top.n = top_n;\n      }\n      " + _PMARK.format(1)),
    ("classify.cu", "  cl.sync();  // every CTA's codes, for the permuted band list\n",
     "  " + _PMARK.format(2) + "  cl.sync();\n  " + _PMARK.format(3)),
    ("classify.cu", "rank * 4 + tid] = s;\n  }\n  cl.sync();\n",
     "rank * 4 + tid] = s;\n  }\n  " + _PMARK.format(4) + "  cl.sync();\n"),
    ("classify.cu", "  // the padding past the list", "  " + _PMARK.format(5) + "  // the padding past the list"),
    ("classify.cu", "  cl.sync();  // no CTA leaves while another reads its codes\n",
     "  " + _PMARK.format(6) + "  cl.sync();\n  " + _PMARK.format(7)),
    ("classify.cu", "// ok: the device flag of the gate", """extern "C" int df_probe(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[9] = {};
    err = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}

// ok: the device flag of the gate"""),
]
D_VARIANTS = {
    "kernel": [],
    **{f"blocks{k}": [("fuse_bricks.cu", "constexpr int kBlocksPerSm = 4;", f"constexpr int kBlocksPerSm = {k};")]
       for k in (1, 2, 8)},
    **{f"threads{k}": [("fuse_bricks.cu", "constexpr int kFuseThreads = 256;", f"constexpr int kFuseThreads = {k};")]
       for k in (128, 512)},
    **{f"run{k}": [("fuse_bricks.cu", "constexpr int kRun = 8;", f"constexpr int kRun = {k};")] for k in (4, 16)},
    # the corners alone in shared memory, each voxel contracting its cell's
    # 8 a channel (x, then y, then z)
    "no_shared_xy": [
        ("fuse_bricks.cu", "  static constexpr int kSmem = 4 * (kX + (kY > kCorners ? kY : kCorners));",
         "  static constexpr int kSmem = 4 * kCorners;"),
        ("fuse_bricks.cu", "  float* ys = sm + 4 * S::kX;", "  float* ys = sm;"),
        ("fuse_bricks.cu", "    // x, once for each (vx, grid j, grid k)\n",
         "    if (false) {\n    // x, once for each (vx, grid j, grid k)\n"),
        ("fuse_bricks.cu", "    __syncthreads();  // the y-contraction, for the voxels\n", "    __syncthreads();\n    }\n"),
        ("fuse_bricks.cu", """          const float* y = ys + ch * S::kY + (vx * B + vy) * kC + ck;
          pos[ch] = y[0] * (1.0f - fk) + y[1] * fk;
""", """          const float fi = static_cast<float>(vx % G) / static_cast<float>(G);
          const float fj = static_cast<float>(vy % G) / static_cast<float>(G);
          const float* c = ys + ch * S::kCorners + ((vx / G) * kC + vy / G) * kC + ck;
          float f2[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float f10 = c[cc] * (1.0f - fi) + c[kC * kC + cc] * fi;
            const float f11 = c[kC + cc] * (1.0f - fi) + c[kC * kC + kC + cc] * fi;
            f2[cc] = f10 * (1.0f - fj) + f11 * fj;
          }
          pos[ch] = f2[0] * (1.0f - fk) + f2[1] * fk;
"""),
    ],
    # a run inside one grid cell (G a multiple of kRun) reads its row's two
    # y-values a channel once
    "one_cell": [
        ("fuse_bricks.cu", """      Run<W> w = *reinterpret_cast<const Run<W>*>(weight + addr);
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
""", """      Run<W> w = *reinterpret_cast<const Run<W>*>(weight + addr);
      constexpr bool kOneCell = G % kRun == 0;
      const float* yrow = ys + (vx * B + vy) * kC + (kOneCell ? vz0 / G : 0);
      float y0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, y1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (kOneCell) {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          if (ch >= nch) break;
          y0[ch] = yrow[ch * S::kY];
          y1[ch] = yrow[ch * S::kY + 1];
        }
      }
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
"""),
        ("fuse_bricks.cu", "          pos[ch] = y[0] * (1.0f - fk) + y[1] * fk;\n",
         "          pos[ch] = kOneCell ? y0[ch] * (1.0f - fk) + y1[ch] * fk : y[0] * (1.0f - fk) + y[1] * fk;\n"),
    ],
    # a probe (not held): the voxels' loads, positions and stores without
    # the update rule
    "probe_no_update": [("fuse_bricks.cu", "        fuse_band(a, kind == kBand, u0, v0, pos, t.v[i], w.v[i]);",
                         "        if (pos[0] == -12345.0f) fuse_band(a, kind == kBand, u0, v0, pos, t.v[i], w.v[i]);")],
}


def check_anchors(csrc=HERE / "dynamicfusion_tpu_torch" / "csrc"):
    """Every variant's anchors occur once in their sources (no card needed)."""
    for variants in (K_VARIANTS, D_VARIANTS):
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

    import torch

    if not torch.cuda.is_available():
        print("torch_plan_fuse_variants: torch.cuda.is_available() is False", file=sys.stderr)
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
    from dynamicfusion_tpu_torch.ops import bricks, fusion, tsdf as tsdf_ops
    from dynamicfusion_tpu_torch.parallel import sharded_fusion
    from dynamicfusion_tpu_torch.pipeline import kinfu

    check_anchors()
    card = cs.smi()
    print(card, flush=True)
    kernels.load()
    tmp = Path(tempfile.mkdtemp(prefix="plan_fuse_variants_"))
    procs = {f"K {name}": build(kernels, name, "classify.cu", subs, tmp) for name, subs in K_VARIANTS.items()}
    procs.update({f"D {name}": build(kernels, name, "fuse_bricks.cu", subs, tmp) for name, subs in D_VARIANTS.items()})
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        lines = log.splitlines()
        regs, spills = [], []
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and ("classify_plan_cluster" in ln or "persistent" in ln):
                for x in lines[i + 1:i + 4]:
                    if "registers" in x:
                        regs.append(int(x.split("Used ")[1].split(" registers")[0]))
                    if "spill stores" in x:
                        spills.append(int(x.split("bytes spill stores")[0].split(",")[-1]))
        print(f"[ptxas] {name}: {len(regs)} instantiations, registers {min(regs)}-{max(regs)}, most spill stores "
              f"{max(spills)} bytes", flush=True)
        libs[name] = bind(kernels, so, ["df_brick_plan"] if name.startswith("K ") else ["df_fuse_bricks"])
        if name == "K probe_phases":
            libs[name].df_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
            libs[name].df_probe.restype = ctypes.c_int

    dev = torch.device("cuda")
    cfg = DynamicFusionConfig.default_dynamicfusion()
    depths = synthetic.deforming_frames(cfg.intr, cfg.rows, cfg.cols, 4)
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in depths[:3]:
        df(d)
    st = df.state
    tr = kinfu.track(cfg, st, torch.from_numpy(depths[3]).to(dev))
    g, b = cfg.knn_field_stride, cfg.brick_size
    cf = fusion.coarse_field(cfg, st.warp)
    w2c = se3.inverse(tr.pose)
    grid = se3.transform_points(w2c, cf.warped).contiguous()
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

    # ------------------------------------------------------------------ K
    n = 4
    band_cap, wide_cap = sharded_fusion.caps(cfg, n)
    dl = cfg.volume_dims // n
    slabs = [(bricks.corner_slab(grid, k, n, b, g).contiguous(), k * dl // b) for k in range(n)]
    kc, kd, kg, _, _, _ = cs.plan_inputs(torch, dev, "kinfu_warped")
    shapes = {
        "preset": lambda **kw: [bricks.plan(cfg, tr.dists, grid, g, cfg.intr, **kw)],
        "slab": lambda **kw: [bricks.plan_slab(cfg, tr.dists, gk, g, cfg.intr, x0, band_cap, wide_cap, **kw)
                              for gk, x0 in slabs],
        "kinfu": lambda **kw: [bricks.plan(kc, kd, kg, cfg.knn_field_stride, kc.intr, **kw)],
    }
    for sname, plan in shapes.items():
        ref = plan()
        calls = {}
        for name, lib in libs.items():
            if not name.startswith("K "):
                continue

            def call(lib=lib):
                with library(kernels, lib):
                    return plan()

            got = call()
            if "probe" not in name and not all(cs.same_plan(torch, x, y) for x, y in zip(got, ref)):
                print(f"K {sname}: {name} differs from the kernel", file=sys.stderr)
                return 1
            calls[name[2:]] = call
        calls["one-block"] = lambda plan=plan: plan(reference=True)
        calls["plain"] = lambda plan=plan: plan(plain=True)
        timed(f"K {sname}", calls)
        # the phases of CTA 0, a mean over 20 calls
        probe = (ctypes.c_ulonglong * 9)()
        libs["K probe_phases"].df_probe(probe, 1)
        for _ in range(20):
            calls["probe_phases"]()
        torch.cuda.synchronize()
        libs["K probe_phases"].df_probe(probe, 1)
        print(f"[probe] {card} | K {sname}, CTA 0's phases (us a call): " + ", ".join(
            f"{ph} {probe[i] / 20 / 1e3:.2f}" for i, ph in enumerate(K_PHASES)), flush=True)

    # ------------------------------------------------------------------ D
    lookup = bricks.pack_depth_conf(tr.dists, tr.conf)
    rgrid = tsdf_ops.brick_grid(cfg, se3.compose(w2c, kinfu._vol_pose(cfg, dev)))
    on = torch.ones((), dtype=torch.bool, device=dev)
    cases = {
        "nonrigid": (lookup, grid, g, cf.q, True, bricks.plan(cfg, tr.dists, grid, g, cfg.intr)),
        "rigid": (tr.dists, rgrid, b, None, False, bricks.plan(cfg, tr.dists, rgrid, b, cfg.intr)),
    }
    for sname, (lk, gr, gs, q, packed, bp) in cases.items():
        ref = TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
        bricks.fuse(cfg, ref, lk, gr, gs, cfg.intr, bp, on, q, packed)
        scratch = TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
        for ok, tag in ((on, ""), (~on, " gated")):
            calls = {}
            for name, lib in libs.items():
                if not name.startswith("D "):
                    continue

                def call(lib=lib, ok=ok, vol=scratch):
                    with library(kernels, lib):
                        bricks.fuse(cfg, vol, lk, gr, gs, cfg.intr, bp, ok, q, packed)

                if not tag and "probe" not in name:
                    got = TsdfVolume(st.vol.tsdf.clone(), st.vol.weight.clone())
                    call(vol=got)
                    if not cs.same_volume(torch, got, ref):
                        print(f"D {sname}: {name} differs from the kernel", file=sys.stderr)
                        return 1
                calls[name[2:]] = call
            calls["reference"] = lambda ok=ok: bricks.fuse(cfg, scratch, lk, gr, gs, cfg.intr, bp, ok, q, packed,
                                                           reference=True)
            if not tag:
                calls["plain"] = lambda: bricks.fuse(cfg, scratch, lk, gr, gs, cfg.intr, bp, on, q, packed,
                                                     plain=True)
            timed(f"D {sname}{tag} ({int(bp.work.count[0])} listed bricks)", calls)
    print(json.dumps({"card": card, "median_ms_by_run": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
