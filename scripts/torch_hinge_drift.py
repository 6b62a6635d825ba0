"""The static camera's drift on bench.py's hinge scene (or its bulge) at
full width, in the JAX package and in the port's plain path, both on the
CPU.

The hinge scene (two spheres scissoring about a hinge over the plane
z = 1.3) is seen by a camera that does not move, so the distance of the
tracked pose from the identity is the tracker's drift. This script renders
the frames once (``dynamicfusion_tpu_torch.io.synthetic.hinge_frames``),
hands the same arrays to both packages under ``quality_dynamicfusion()``
(640x480 / 256^3 / 1024 nodes) and prints, frame by frame, each package's
drift: JAX jitted, JAX again from frame-0 node positions moved by 1e-7
relative (its own spread: the solve's bf16 rows let a last bit move the LM
step), and the port's plain PyTorch path; beside them the port's step from
JAX's previous state, against JAX's step (what a fault of the port would
show in one step, where free-running paths part chaotically). It stops
after ``--frames`` frames or once ``--minutes`` have passed, whichever
comes first.

    python3 scripts/torch_hinge_drift.py [--frames 20] [--minutes 15] [--adaptive] [--scene bulge]

``--adaptive`` turns on ``solver_p2p_adaptive`` (the aperture gate) in both
packages and prints, per step, each package's mean gate over the moving
part's pixels (the spheres, nearer than 1.25 m; the bump, nearer than
1.095 m) and over the rest of the surface, on its own trajectory: JAX's
``_p2p_gate`` of its own tracking, the port's gate from its ``track``.
``--scene bulge`` runs ``bench.py``'s travelling bump over the plane
z = 1.1 (``io/synthetic.bulge_frames``) in place of the hinge. Imports both
packages, as the parity tests do; CPU only.
"""

import argparse
import dataclasses
import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg  # noqa: E402
from dynamicfusion_tpu.core import se3 as jse3  # noqa: E402
from dynamicfusion_tpu.ops import preprocess as jpreprocess  # noqa: E402
from dynamicfusion_tpu.pipeline import kinfu as jkinfu  # noqa: E402
from dynamicfusion_tpu.solvers import icp as jicp  # noqa: E402
from dynamicfusion_tpu_torch import interop  # noqa: E402
from dynamicfusion_tpu_torch.core import se3 as tse3  # noqa: E402
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg  # noqa: E402
from dynamicfusion_tpu_torch.io import synthetic  # noqa: E402
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu  # noqa: E402


def drift(pose) -> tuple:
    """(max |t| in m, max |R - I| entry) of a camera-to-world pose."""
    p = np.asarray(pose, np.float64)
    return float(np.abs(p[:3, 3]).max()), float(np.abs(p[:3, :3] - np.eye(3)).max())


# the moving part is what stands nearer than this (m): the hinge's spheres
# before the plane z = 1.3, the bump's top 5 mm and more above z = 1.1
MOVING_Z = {"hinge": 1.25, "bulge": 1.095}


def jax_gate(cfg, state, depth):
    """JAX's aperture gate of a step, as ``step`` computes it
    (``kinfu.py:425-441, 540-553``): (gate, live depth) at the model maps'
    resolution."""
    shift = cfg.raycast_shift
    _, pts, nrm, _ = jpreprocess.build_frame_pyramid(cfg, depth)
    res = jicp.estimate_transform(cfg, list(pts[shift:]), list(nrm[shift:]), list(state.prev_points),
                                  list(state.prev_normals), level_offset=shift)
    pose = jnp.where(res.ok, jse3.compose(state.pose, res.transform), state.pose)
    gate = jkinfu._p2p_gate(cfg, jse3.transform_points(pose, pts[shift]), jse3.rotate_dirs(pose, nrm[shift]),
                            jse3.transform_points(state.pose, state.prev_points[0]), pts[shift][..., 2])
    return gate, pts[shift][..., 2]


def port_gate(cfg, state, depth):
    """The port's aperture gate of a step, from its ``track``: (gate, live
    depth) at the model maps' resolution."""
    shift = cfg.raycast_shift
    tr = tkinfu.track(cfg, state, depth)
    pose = torch.where(tr.icp_res.ok, tse3.compose(state.pose, tr.icp_res.transform), state.pose)
    gate = tkinfu.p2p_gate(cfg, tse3.transform_points(pose, tr.points[shift]), tse3.rotate_dirs(pose, tr.normals[shift]),
                           tse3.transform_points(state.pose, state.prev_points[0]), tr.points[shift][..., 2])
    return gate.numpy(), tr.points[shift][..., 2].numpy()


def gate_means(gate, z, z_moving) -> tuple:
    """(mean gate over the moving part, over the rest of the surface)."""
    gate, z = np.asarray(gate), np.asarray(z)
    mov = np.isfinite(z) & (z < z_moving)
    rest = np.isfinite(z) & ~mov
    return float(gate[mov].mean()), float(gate[rest].mean())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=20, help="frames of the hinge scene (frame 0 included)")
    ap.add_argument("--minutes", type=float, default=15.0, help="stop after the frame that passes this")
    ap.add_argument("--adaptive", action="store_true", help="solver_p2p_adaptive=True (the aperture gate)")
    ap.add_argument("--scene", choices=sorted(MOVING_Z), default="hinge", help="bench.py's hold-out scene")
    ap.add_argument("--threads", type=int, default=4, help="PyTorch intra-op threads")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)

    jc, tc = JCfg.quality_dynamicfusion(), TCfg.quality_dynamicfusion()
    if args.adaptive:
        jc = dataclasses.replace(jc, solver_p2p_adaptive=True)
        tc = dataclasses.replace(tc, solver_p2p_adaptive=True)
    frames_fn = synthetic.hinge_frames if args.scene == "hinge" else synthetic.bulge_frames
    depths = frames_fn(tc.intr, tc.rows, tc.cols, args.frames)
    print(f"{args.scene} scene, quality_dynamicfusion(){' + solver_p2p_adaptive' if args.adaptive else ''}: "
          f"{tc.cols}x{tc.rows} / {tc.volume_dims}^3 / {tc.max_nodes} nodes, up to {args.frames} frames, "
          f"{args.minutes} min; CPU, torch threads {args.threads}", flush=True)

    first = jax.jit(lambda s, d: jkinfu.first_frame(jc, s, d))
    step = jax.jit(lambda s, d: jkinfu.step(jc, s, d))
    jgate = jax.jit(lambda s, d: jax_gate(jc, s, d))
    t0 = time.perf_counter()
    js = first(jkinfu.init_state(jc), jnp.asarray(depths[0]))
    pos = np.asarray(js.warp.positions)
    noise = 1.0 + 1e-7 * np.random.RandomState(0).randn(*pos.shape)
    jp = js._replace(warp=js.warp._replace(positions=jnp.asarray((pos * noise).astype(np.float32))))
    ts = tkinfu.first_frame(tc, tkinfu.init_state(tc, "cpu"), torch.from_numpy(depths[0]))
    print(f"frame 0 done at {time.perf_counter() - t0:.1f} s", flush=True)
    print("frame | drift |t| (m): JAX, JAX perturbed, port | port - JAX (m) | rotation entry: JAX, port | "
          "port step from JAX's state - JAX: |t| (m), rotation entry, cost0 relative | icp_ok JAX/port | "
          "solver cost0 JAX, port" + (" | mean gate moving/rest: JAX, port" if args.adaptive else ""), flush=True)
    rows, means = [], []
    for f in range(1, len(depths)):
        d = depths[f]
        prev = interop.state_from_numpy(jax.tree_util.tree_map(np.array, js), "cpu")
        js_prev = js
        js, jo = step(js, jnp.asarray(d))
        _, so = tkinfu.step(tc, prev, torch.from_numpy(d))
        ps = so.pose.numpy()
        s_t = float(np.abs(ps[:3, 3] - np.asarray(jo.pose)[:3, 3]).max())
        s_r = float(np.abs(ps[:3, :3] - np.asarray(jo.pose)[:3, :3]).max())
        s_c = abs(float(so.solver_cost0) - float(jo.solver_cost0)) / float(jo.solver_cost0)
        gates = ""
        if args.adaptive:  # each package's gate on its own trajectory, before its step
            mj = gate_means(*jgate(js_prev, jnp.asarray(d)), MOVING_Z[args.scene])
            mt = gate_means(*port_gate(tc, ts, torch.from_numpy(d)), MOVING_Z[args.scene])
            # and the port's gate from JAX's state against JAX's gate
            g_diff = float(np.nanmax(np.abs(port_gate(tc, prev, torch.from_numpy(d))[0]
                                            - np.asarray(jgate(js_prev, jnp.asarray(d))[0]))))
            means.append((mj, mt, g_diff))
            gates = f" | {mj[0]:.3f}/{mj[1]:.3f} {mt[0]:.3f}/{mt[1]:.3f} (from JAX's state, max |diff| {g_diff:.2e})"
        jp, jpo = step(jp, jnp.asarray(d))
        ts, to = tkinfu.step(tc, ts, torch.from_numpy(d))
        pj, pp, pt = np.asarray(jo.pose), np.asarray(jpo.pose), to.pose.numpy()
        (tj, rj), (tp, _), (tt, rt) = drift(pj), drift(pp), drift(pt)
        diff = float(np.abs(pt[:3, 3] - pj[:3, 3]).max())
        spread = float(np.abs(pp[:3, 3] - pj[:3, 3]).max())
        rows.append((f, tj, tp, tt, diff, spread, s_t))
        print(f"{f:5d} | {tj:.3e} {tp:.3e} {tt:.3e} | {diff:.3e} (JAX spread {spread:.3e}) | {rj:.3e} {rt:.3e} | "
              f"{s_t:.3e} {s_r:.3e} {s_c:.3e} | {bool(jo.icp_ok)}/{bool(to.icp_ok)} | "
              f"{float(jo.solver_cost0):.6e} {float(to.solver_cost0):.6e}{gates} | "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if time.perf_counter() - t0 > args.minutes * 60.0:
            break
    f, tj, tp, tt, diff, spread, _ = rows[-1]
    print(f"after {f} steps: drift JAX {tj:.3e} m, JAX perturbed {tp:.3e} m, port {tt:.3e} m; "
          f"port - JAX {diff:.3e} m against JAX's own spread {spread:.3e} m; "
          f"largest drift over the run: JAX {max(r[1] for r in rows):.3e}, port {max(r[3] for r in rows):.3e}; "
          f"largest |t| of the port's step from JAX's state against JAX's {max(r[6] for r in rows):.3e} m",
          flush=True)
    if means:
        mean = lambda k, i: float(np.mean([m[k][i] for m in means]))  # noqa: E731
        print(f"mean gate over the run, moving part / rest: JAX {mean(0, 0):.4f} / {mean(0, 1):.4f}, "
              f"port {mean(1, 0):.4f} / {mean(1, 1):.4f}; largest |port gate - JAX gate| from JAX's state "
              f"{max(m[2] for m in means):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
