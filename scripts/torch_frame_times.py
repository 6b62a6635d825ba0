"""Frame times of one of the port's non-rigid configurations on the card,
for a tree given on the command line: the kernel path through
``DynamicFusion`` over ``bench.py``'s hinge scene (``quality``) or its
deforming scene (``default``, ``base``: the base ``DynamicFusionConfig()``
with the direct solve, ``kinfu``: ``default_kinfu()``'s 512^3 volume at
its own intrinsics) or ``chip_smoke.py``'s rigid orbit (``ref_rigid``: the
reference-shaped rigid cell, ``reference_parity()`` rigid with dense
fusion and the six-sample normals) at full width, then ``--profile`` frames under
torch.profiler (``chip_smoke.profile_frames``: device busy time, idle
share, launches); with ``--frame0`` also frame 0 of a fresh
``DynamicFusion`` (the extraction, the node sampling, the first fusion).

    python3 scripts/torch_frame_times.py --root DIR [--preset quality] [--storage f32/f32] [--frames 20]
                                         [--profile OUT [--frame0] [--focus NAME ...]]

``--root`` is the directory holding the ``dynamicfusion_tpu_torch`` to time
(this checkout by default; an unpacked ``git archive`` of another commit
for an A/B on one card: run parent, change, change, parent in one call,
each in its own process). The kernels build from that tree's sources.
Prints the card, every frame's host time around one frame ending in
``torch.cuda.synchronize()``, and the median of the steady frames
(2..N-1) as chip_smoke.py measures it. ``--storage TSDF/WEIGHT`` runs the
preset with that volume storage (``f32/f32``, ``bf16/f32``, ...; the
preset's ``i16/u16`` by default): alternate storages in one call for an
A/B of the storage.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(HERE), help="directory holding the dynamicfusion_tpu_torch to time")
    ap.add_argument("--preset", choices=("quality", "default", "base", "kinfu", "ref_rigid"), default="quality",
                    help="quality_dynamicfusion() on the hinge scene, default_dynamicfusion(), "
                         "DynamicFusionConfig() or default_kinfu() on the deforming scene, or the reference-shaped "
                         "rigid cell on the rigid orbit")
    ap.add_argument("--storage", default=None, help="the volume's tsdf/weight storage, e.g. f32/f32 (default: the "
                                                    "configuration's)")
    ap.add_argument("--frames", type=int, default=20, help="timed frames (frame 0 included)")
    ap.add_argument("--profile", default=None, help="profile 3 more frames and write the table and trace here")
    ap.add_argument("--frame0", action="store_true",
                    help="with --profile, also profile frame 0 of a fresh DynamicFusion after the timed frames")
    ap.add_argument("--focus", nargs="*", default=(),
                    help="with --profile, also print the device time of the kernels whose names hold these strings")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_frame_times: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(HERE))
    from chip_smoke import profile_frames, rigid_frame_fn
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.pipeline import kinfu

    assert Path(kinfu.__file__).resolve().is_relative_to(root), kinfu.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kernels.load()
    print(f"[build] {root}: {time.perf_counter() - t0:.2f} s", flush=True)

    make = synthetic.hinge_frames if args.preset == "quality" else synthetic.deforming_frames
    cfg = {"quality": DynamicFusionConfig.quality_dynamicfusion, "default": DynamicFusionConfig.default_dynamicfusion,
           "base": DynamicFusionConfig, "kinfu": DynamicFusionConfig.default_kinfu,
           "ref_rigid": DynamicFusionConfig.reference_parity}[args.preset]()
    if args.preset == "ref_rigid":
        cfg = dataclasses.replace(cfg, rigid_only=True, integrate_mode="dense", raycast_smooth_normals=True)

        def make(intr, rows, cols, n):
            frame = rigid_frame_fn(cfg)
            return [frame(i) for i in range(n)]
    if args.storage:
        tsdf_dtype, weight_dtype = args.storage.split("/")
        cfg = dataclasses.replace(cfg, tsdf_dtype=tsdf_dtype, weight_dtype=weight_dtype)
    args.storage = f"{cfg.tsdf_dtype}/{cfg.weight_dtype}"
    n_prof = 3 if args.profile else 0
    frames = make(cfg.intr, cfg.rows, cfg.cols, args.frames + n_prof)
    df = kinfu.DynamicFusion(cfg, device=dev)
    ms = []
    for d in frames[: args.frames]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        df(d, block=False)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    steady = sorted(ms[2:])
    print(f"[time] {card} | {root.name} {args.preset} {args.storage} frame ms median {steady[len(steady) // 2]:.3f} "
          f"(frames 2..{len(ms) - 1}), min {steady[0]:.3f}, max {steady[-1]:.3f}; per frame "
          + " ".join(f"{v:.1f}" for v in ms), flush=True)
    if args.profile:
        tag = f"{root.name}_{args.preset}_{args.storage.replace('/', '_')}"
        profile_frames(torch, args, dev, card, df, frames[args.frames:], focus=tuple(args.focus), tag=tag)
        if args.frame0:
            profile_frames(torch, args, dev, card, kinfu.DynamicFusion(cfg, device=dev), frames[:1],
                           focus=tuple(args.focus), tag=f"{tag}_frame0")
    print(json.dumps({"root": str(root), "preset": args.preset, "storage": args.storage,
                      "median_ms": steady[len(steady) // 2],
                      "frame_ms": ms, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
