"""Kernel I's one-launch depth pyramid and kernel J's tiled march band,
their design choices timed on the card.

Kernel I's pyramid (``csrc/preprocess.cu``, entry ``df_depth_pyramid``):
the kernel as it is (its plan's tile and threads: at the preset a block
a 7x7 tile of the deepest level, 512 threads, 108 blocks; the level-0
region read with 4 loads a thread in flight, the regions staged as
float with a NaN outside the image) beside the plan forced to each tile
T = 4..8 and 256, 512 or 1 024 threads a block (``T4x256`` ...: the
entry's tile and threads arguments), and variants of the same source
with one choice changed: the region read one load at a time
(``batch1``) or 12 at a time (``batch12``), the regions staged as uint16
with a bounds test and a conversion a tap (``u16_regions``, the first
design's); and probes whose levels are wrong and not held: every block returns at
once (``probe_empty``, the launch and its blocks), after reading its
level-0 region (``probe_load``) or after level 1 (``probe_level1``); beside the design before
(``pyramid_down``, a launch a level, the reference mode), the library
route (``chip_smoke.library_pyramid``) and the plain version. Frames: the
preset's filtered noisy frame (640x480, four levels) and
``chip_smoke.pyramid_frame``'s threshold-edge frame.

Kernel J's band (``csrc/bands.cu``, entry ``df_march_bands``): the tiled
kernel as it is (16x8 tiles, a row pass then a column pass over the
staged sources) beside 32x8 and 16x4 tiles (``tile32x8``, ``tile16x4``)
and the 25 taps read from the staged sources directly (``taps25``);
beside the reference mode (a thread a pixel, 25 taps of recomputed
sources), the library route and the plain version, on the preset's state
after three frames (160x120, the band alone, as the frame step asks).

    python3 scripts/torch_pyramid_bands_variants.py [--rounds 3] [--runs 2]

Variants are built with the kernels' nvcc flags into libraries of their
own by text substitution (the anchors must match the sources: edit both
together; check them on the CPU with ``check_anchors()``) and launched
through the port's wrappers with the variant's library in place. Each
variant but the probe is held bit for bit against the kernel; one that
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

_BATCH = "constexpr int kPyrBatch = 4; "
_PYR_BODY = "  extern __shared__ float s_lv[];\n"
I_VARIANTS = {
    "batch1": [("preprocess.cu", _BATCH, "constexpr int kPyrBatch = 1; ")],
    "batch12": [("preprocess.cu", _BATCH, "constexpr int kPyrBatch = 12;")],
    "probe_empty": [("preprocess.cu", _PYR_BODY, _PYR_BODY + "  if (a.down > 0) return;\n")],
    "probe_load": [("preprocess.cu", "  __syncthreads();\n#pragma unroll 1\n  for (int k = 1; k <= a.down; ++k) {",
                    "  __syncthreads();\n  if (a.down > 0) return;\n#pragma unroll 1\n"
                    "  for (int k = 1; k <= a.down; ++k) {")],
    "probe_level1": [("preprocess.cu", "      if (k < a.down) dst[i] = v;\n    }\n    __syncthreads();\n",
                      "      if (k < a.down) dst[i] = v;\n    }\n    __syncthreads();\n    if (k == 1) return;\n")],
}
# the first design's regions: uint16, 0 outside the image, a bounds test
# and a conversion a tap (the kernel stages float with a NaN outside)
I_VARIANTS["u16_regions"] = [("preprocess.cu", a, b) for a, b in (
    ("  extern __shared__ float s_lv[];", "  extern __shared__ uint16_t s_lv[];"),
    ("    float* dst = s_lv + a.off[0];", "    uint16_t* dst = s_lv + a.off[0];"),
    ("      float v[kPyrBatch];", "      uint16_t v[kPyrBatch];"),
    ("                   ? static_cast<float>(__ldg(a.in + y * a.w[0] + x)) : nan_f();",
     "                   ? __ldg(a.in + y * a.w[0] + x) : uint16_t(0);"),
    ("    const int h = a.h[k], w = a.w[k];",
     "    const int hp = a.h[k - 1], wp = a.w[k - 1], h = a.h[k], w = a.w[k];"),
    ("    const float* src = s_lv + a.off[k - 1];\n    float* dst = s_lv + a.off[k];",
     "    const uint16_t* src = s_lv + a.off[k - 1];\n    uint16_t* dst = s_lv + a.off[k];"),
    ("      float v = nan_f();", "      uint16_t v = 0;"),
    ("        const float* ctr = src + (2 * r + 2) * np + (2 * c + 2);\n        const float d = *ctr;",
     "        const uint16_t* ctr = src + (2 * r + 2) * np + (2 * c + 2);\n"
     "        const float d = static_cast<float>(*ctr);"),
    ("#pragma unroll\n        for (int dy = -2; dy <= 2; ++dy) {\n#pragma unroll\n"
     "          for (int dx = -2; dx <= 2; ++dx) {\n            const float nbr = ctr[dy * np + dx];",
     "#pragma unroll\n        for (int dy = -2; dy <= 2; ++dy) {\n          const int yy = 2 * y + dy;\n#pragma unroll\n"
     "          for (int dx = -2; dx <= 2; ++dx) {\n            const int xx = 2 * x + dx;\n"
     "            if (yy < 0 || yy >= hp || xx < 0 || xx >= wp) continue;\n"
     "            const float nbr = static_cast<float>(ctr[dy * np + dx]);"),
    ("        v = static_cast<float>(q);", "        v = q;"),
    ("    return total * static_cast<int>(sizeof(float));",
     "    return total * static_cast<int>(sizeof(uint16_t));"),
)]

_BX = "constexpr int kBandX = 16;"
_BY = "constexpr int kBandY = 8; "
# the column pass's source: the row pass's output (the kernel) or, for
# taps25, the staged sources themselves read 25 times
_ROW_PASS = "  // the row pass: each staged row's 5-wide min (max) at the tile's columns\n"
_COLUMN = """  float near = r_near[ty][tx], lo = kBand ? r_lo[ty][tx] : 0.0f, hi = kBand ? r_hi[ty][tx] : 0.0f;
#pragma unroll
  for (int d = 1; d < 5; ++d) {
    near = fminf(near, r_near[ty + d][tx]);
    if (kBand) {
      lo = fminf(lo, r_lo[ty + d][tx]);
      hi = fmaxf(hi, r_hi[ty + d][tx]);
    }
  }
"""
_TAPS25 = """  float near = s_near[ty][tx], lo = kBand ? s_lo[ty][tx] : 0.0f, hi = kBand ? s_hi[ty][tx] : 0.0f;
#pragma unroll
  for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 5; ++dx) {
      near = fminf(near, s_near[ty + dy][tx + dx]);
      if (kBand) {
        lo = fminf(lo, s_lo[ty + dy][tx + dx]);
        hi = fmaxf(hi, s_hi[ty + dy][tx + dx]);
      }
    }
  }
"""
J_VARIANTS = {
    "tile32x8": [("bands.cu", _BX, "constexpr int kBandX = 32;")],
    "tile16x4": [("bands.cu", _BY, "constexpr int kBandY = 4; ")],
    "taps25": [("bands.cu", _ROW_PASS, "  if (false)\n" + _ROW_PASS), ("bands.cu", _COLUMN, _TAPS25)],
}


def check_anchors(csrc=HERE / "dynamicfusion_tpu_torch" / "csrc"):
    """Every variant's anchors occur once in their sources (no card needed)."""
    for variants in (I_VARIANTS, J_VARIANTS):
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

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_pyramid_bands_variants: torch.cuda.is_available() is False", file=sys.stderr)
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

    check_anchors()
    card = cs.smi()
    print(card, flush=True)
    kernels.load()
    tmp = Path(tempfile.mkdtemp(prefix="pyramid_bands_variants_"))
    procs = {f"I {name}": build(kernels, name, "preprocess.cu", subs, tmp) for name, subs in I_VARIANTS.items()}
    procs.update({f"J {name}": build(kernels, name, "bands.cu", subs, tmp) for name, subs in J_VARIANTS.items()})
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and ("pyramid" in ln or "bands" in ln):
                props = [x.split("info    :")[-1].strip() for x in lines[i + 1:i + 4]
                         if "registers" in x or "spill" in x]
                fn = ln.split("'")[1] if "'" in ln else ln
                print(f"[ptxas] {name}: {fn}: " + " | ".join(props), flush=True)
        libs[name] = bind(kernels, so, ["df_depth_pyramid"] if name.startswith("I ") else ["df_march_bands"])

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

    # ------------------------------------------------------------------ I
    cfg = DynamicFusionConfig.default_dynamicfusion()
    depths = synthetic.deforming_frames(cfg.intr, cfg.rows, cfg.cols, 5)
    rng = np.random.RandomState(5)
    noisy = depths[4].astype(np.int32)
    noisy = np.where(noisy > 0, noisy + rng.randint(-3, 4, noisy.shape), 0)
    noisy = torch.from_numpy(np.where(rng.rand(*noisy.shape) < 0.01, 0, noisy).astype(np.uint16)).to(dev)
    sig, levels = cfg.bilateral_sigma_depth, cfg.pyramid_levels
    frames = {
        "preset": preprocess.bilateral_filter(noisy, cfg.bilateral_kernel_size, cfg.bilateral_sigma_spatial, sig),
        "threshold_edges": torch.from_numpy(cs.pyramid_frame(cfg.rows, cfg.cols, 1)).to(dev),
    }
    klib = kernels.load()
    thresh = float(np.float32(sig * 1000.0 * 3.0))

    def run(f0, t, nt):
        """(levels, the plan's tile, threads) of the entry with the plan's
        tile and threads forced to t and nt (0: the plan's own)."""
        out = [f0]
        for _ in range(1, levels):
            out.append(torch.empty((out[-1].shape[0] // 2, out[-1].shape[1] // 2), dtype=torch.uint16, device=dev))
        ptrs = (ctypes.c_void_p * (levels - 1))(*(o.data_ptr() for o in out[1:]))
        tile, threads, ran = ctypes.c_int(t), ctypes.c_int(nt), ctypes.c_int(0)
        rc = klib.df_depth_pyramid(f0.data_ptr(), f0.shape[0], f0.shape[1], levels - 1, thresh, ptrs,
                                   kernels._sm_count(dev), ctypes.byref(tile), ctypes.byref(threads),
                                   ctypes.byref(ran), torch.cuda.current_stream().cuda_stream)
        if rc or (t and tile.value != t) or (nt and threads.value != nt):
            raise RuntimeError(f"df_depth_pyramid T {t} x {nt}: error {rc}, plan {tile.value} x {threads.value}")
        return out, tile.value, threads.value

    def forced(f0, t, nt):
        return run(f0, t, nt)[0]

    _, plan_t, plan_nt = run(frames["preset"], 0, 0)
    print(f"[plan] {card} | the kernel's plan at {cfg.cols}x{cfg.rows}: T {plan_t}, {plan_nt} threads a block",
          flush=True)
    for tag, f0 in frames.items():
        ref = kernels.depth_pyramid(f0, levels, sig)
        calls = {"kernel": lambda f0=f0: kernels.depth_pyramid(f0, levels, sig)}
        for t in range(4, 9):
            for nt in (256, 512, 1024):
                def call(f0=f0, t=t, nt=nt):
                    return forced(f0, t, nt)

                if not all(torch.equal(a.to(torch.int32), b.to(torch.int32)) for a, b in zip(call(), ref)):
                    print(f"I {tag}: T{t}x{nt} differs from the kernel: not timed", file=sys.stderr)
                    bad.append(f"T{t}x{nt} ({tag})")
                    continue
                calls[f"T{t}x{nt}"] = call
        for name, lib in libs.items():
            if not name.startswith("I "):
                continue

            def call(lib=lib, f0=f0):
                with library(kernels, lib):
                    return kernels.depth_pyramid(f0, levels, sig)

            if "probe" not in name and not all(torch.equal(a.to(torch.int32), b.to(torch.int32))
                                               for a, b in zip(call(), ref)):
                print(f"I {tag}: {name} differs from the kernel: not timed", file=sys.stderr)
                bad.append(f"{name} ({tag})")
                continue
            calls[name[2:]] = call

        def reference(f0=f0):
            out = [f0]
            for _ in range(1, levels):
                out.append(kernels.pyramid_down(out[-1], sig))
            return out

        calls["reference"] = reference
        calls["library"] = lambda f0=f0: cs.library_pyramid(torch, f0, levels, sig)
        calls["plain"] = lambda f0=f0: preprocess.depth_pyramid(f0, levels, sig, plain=True)
        timed(f"I {tag} ({' -> '.join(f'{p.shape[1]}x{p.shape[0]}' for p in ref)})", calls)

    # ------------------------------------------------------------------ J
    df = kinfu.DynamicFusion(cfg, device=dev)
    for d in depths[:3]:
        df(d)
    st = df.state
    dists = preprocess.compute_dists(cfg.intr, torch.from_numpy(depths[3]).to(dev))
    can = st.can_points.contiguous()
    s, m = cfg.raycast_subsample, cfg.raycast_band_margin
    _, ref = kernels.march_bands(dists, s, can, m, False)
    calls = {"kernel": lambda: kernels.march_bands(dists, s, can, m, False)}
    for name, lib in libs.items():
        if not name.startswith("J "):
            continue

        def call(lib=lib):
            with library(kernels, lib):
                return kernels.march_bands(dists, s, can, m, False)

        got = call()[1]
        if not all(cs.same_bits(torch, a, b) for a, b in zip(got, ref)):
            print(f"J: {name} differs from the kernel: not timed", file=sys.stderr)
            bad.append(name)
            continue
        calls[name[2:]] = call
    calls["reference"] = lambda: kernels.march_bands(dists, s, can, m, False, reference=True)
    calls["library"] = lambda: cs.library_march_band(torch, dists, s, can, m)
    calls["plain"] = lambda: kinfu._march_bands(cfg, st.can_points, dists, plain=True)
    timed(f"J {can.shape[1]}x{can.shape[0]}", calls)
    print(json.dumps({"card": card, "median_ms_by_run": times, "differ": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
