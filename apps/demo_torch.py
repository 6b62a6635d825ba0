#!/usr/bin/env python3
"""Dataset demo app of the PyTorch/CUDA port: ``apps/demo.py`` on
``dynamicfusion_tpu_torch``.

Runs DynamicFusion over a VolumeDeform-layout dataset directory
(``<dir>/depth/*.png`` 16-bit mm, optional ``<dir>/color``), or over a
synthetic deforming scene with ``--synthetic N``, on the card (``--device
cuda``, the default) or on the CPU (``--device cpu``, the plain PyTorch
path). With ``--out`` it renders each frame (Phong + normal colours) and
saves the final canonical cloud with its normals, the checkpoint (the JAX
package's format: ``dynamicfusion_tpu.utils.checkpoint.load`` reads it),
and the canonical and live meshes.

Usage:
  python apps/demo_torch.py <data-dir> [--out out_dir] [--frames N] [--small] [--device cpu]
  python apps/demo_torch.py --synthetic 50 --out out_dir
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.io import export as export_mod
from dynamicfusion_tpu_torch.io import synthetic
from dynamicfusion_tpu_torch.ops import tsdf as tsdf_ops
from dynamicfusion_tpu_torch.pipeline import kinfu
from dynamicfusion_tpu_torch.pipeline import render as render_mod
from dynamicfusion_tpu_torch.utils import checkpoint, metrics


def build_cfg(args) -> DynamicFusionConfig:
    if args.small:
        return dataclasses.replace(
            DynamicFusionConfig.small(dims=64, rows=120, cols=160),
            max_nodes=256,
            node_sample_step=7,
        )
    return DynamicFusionConfig.default_dynamicfusion()


def frame_source(args, cfg):
    """Open a FrameSource (io.capture): dataset dir, synthetic, or OpenNI."""
    from dynamicfusion_tpu_torch.io import capture

    spec = f"synthetic:{args.synthetic}" if args.synthetic else args.data_dir
    src = capture.open_source(spec, cfg=cfg)
    n = len(src)
    if args.frames is not None:
        n = min(args.frames, n)
    return ((f[0], f[1]) for _, f in zip(range(n), src)), n


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("data_dir", nargs="?", help="dataset dir with depth/ (and color/)")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="run N synthetic deforming frames instead of a dataset")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None, help="save rendered frames + artifacts here")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--show-warp", action="store_true",
                    help="overlay the warp-field nodes on saved frames (the reference's show_warp view)")
    ap.add_argument("--orbit", type=int, default=0, metavar="N",
                    help="after the run, save N turntable renders of the "
                         "canonical model from orbiting viewpoints")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    if not args.synthetic and not args.data_dir:
        ap.error("need a data dir or --synthetic N")
    return args


def main(argv=None) -> dict:
    """Run the demo; returns the DynamicFusion, its PhaseTimer and the saved
    meshes' (vertex, face) counts by file name."""
    args = parse_args(argv)
    cfg = build_cfg(args)
    frames, n = frame_source(args, cfg)
    df = kinfu.DynamicFusion(cfg, device=args.device)
    timer = metrics.PhaseTimer()

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    t_start = time.time()
    for i, (depth, color) in enumerate(frames):
        with timer.phase("frame", sync=None):
            ok = df(depth)
        if i > 0 and not ok:
            print(f"[{i}] tracking failed — reset", flush=True)
            df.reset()
            df(depth)
            continue
        if args.out:
            img = df.render(mode=3).cpu().numpy()
            if args.show_warp and i > 0:
                img = render_mod.overlay_nodes(cfg, img, df.state)
            if color is not None and color.ndim == 3 and color.shape[0] == img.shape[0]:
                # the colour stream beside the render, display only (the
                # algorithm is depth-only)
                img = np.concatenate([np.ascontiguousarray(color[..., :3], dtype=np.uint8), img], axis=1)
            save_png(os.path.join(args.out, f"frame_{i:05d}.png"), img)
        if args.checkpoint_every and i and i % args.checkpoint_every == 0:
            checkpoint.save(os.path.join(args.out or ".", f"ckpt_{i:05d}.npz"), df.state)
        if i > 0:
            band, wide, dropped = (int(x) for x in df.last_outputs.brick_counts.tolist())
            if dropped > 0:
                # dropped bricks keep stale TSDF this frame (see
                # config.integrate_band_cap/integrate_wide_cap)
                print(
                    f"[{i}] WARNING: brick cap overflow ({dropped} bricks "
                    f"dropped; band {band}, wide {wide}) — part of the "
                    f"surface kept stale values; raise the caps", flush=True,
                )
        if i % 10 == 0 and i > 0:
            o = df.last_outputs
            print(
                f"[{i}/{n}] {i / (time.time() - t_start):.2f} fps  "
                f"nodes={int(o.node_count)} solver {float(o.solver_cost0):.4f}->"
                f"{float(o.solver_cost1):.4f}",
                flush=True,
            )

    elapsed = time.time() - t_start
    print(json.dumps({"frames": n, "fps": round(n / elapsed, 3), "seconds": round(elapsed, 1)}))

    meshes = {}
    if args.out:
        with timer.phase("cloud", sync=None):
            cloud = tsdf_ops.extract_cloud(cfg, df.state.vol, max_points=1 << 20)
            normals = tsdf_ops.extract_normals(cfg, df.state.vol, cloud.points)
            export_mod.save_ply(
                os.path.join(args.out, "canonical_cloud.ply"), cloud.points.cpu().numpy(), normals.cpu().numpy(),
            )
        with timer.phase("checkpoint", sync=None):
            checkpoint.save(os.path.join(args.out, "final_state.npz"), df.state)
        for name, live in (("canonical_mesh.ply", False), ("live_mesh.ply", True)):
            with timer.phase("mesh_live" if live else "mesh", sync=None):
                mesh = df.extract_mesh(live=live)
            with timer.phase("mesh_write", sync=None):
                export_mod.save_mesh(os.path.join(args.out, name), mesh)
            meshes[name] = (len(mesh.vertices), len(mesh.faces))
            print(f"[mesh] {name}: {len(mesh.vertices)} vertices, {len(mesh.faces)} faces", flush=True)
        if args.orbit > 0:
            # turntable renders of the canonical model (a fresh raycast from
            # each orbiting viewpoint)
            center = np.asarray(cfg.volume_origin) + cfg.volume_size / 2.0
            for k in range(args.orbit):
                a = 2.0 * np.pi * k / args.orbit
                pose = synthetic.orbit_pose(a, target=center)
                img = df.render(mode=3, pose=pose).cpu().numpy()
                if args.show_warp:
                    img = render_mod.overlay_nodes(cfg, img, df.state, pose=pose)
                save_png(os.path.join(args.out, f"orbit_{k:03d}.png"), img)
        print(timer.report())
        print(f"saved canonical cloud + meshes + state to {args.out}")
    return dict(df=df, timer=timer, meshes=meshes)


if __name__ == "__main__":
    main()
