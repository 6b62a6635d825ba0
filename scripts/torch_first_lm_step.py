"""The first LM iteration of the warp solve at full width, in the JAX
package and in the port's plain version, on the CPU.

Run mode (no argument): the JAX package runs ``default_dynamicfusion()``
(640x480 / 256^3 / 1024 nodes) jitted over ``--frames`` frames of the
deforming scene that ``chip_smoke.py`` drives (``io/synthetic.
deforming_frames``), and every step's warp field and solve point sets are
captured as the step hands them to the solve. For each captured system
both packages then run the first LM iteration and the whole solve, and the
script prints, for JAX and for the port's plain path from JAX's system:

- whether the first PCG step is finite (its non-finite entries, and the
  active nodes whose step the solve zeroes);
- whether iteration 0 accepts its candidate, and whether that candidate is
  the renormalized field (every active node's step zeroed);
- whether the solve then stops at its initial cost (one accepted step,
  the final cost within the stop test's 1e-6 of the initial one);

and the counts over the run for each package.

Dump mode: ``python3 chip_smoke.py --dump-solve FILE`` writes the warp
field and the solve's point sets of its phase-2 state (the preset after
three frames, the next frame tracked); given that file, the script builds
the first iteration's damped 6x6 blocks as the factored solve does,
inverts them with the closed-form ``spd6_inv``, runs the PCG from them and
prints how many entries of the step are not finite, the blocks' condition
numbers and the inverse's error against float64; then each package's
whole solve (initial and final cost, accepted steps).

    python3 scripts/torch_first_lm_step.py [--frames 20] [--threads 4]
    python3 scripts/torch_first_lm_step.py solve.npz

Imports both packages, as the parity tests do; runs on the CPU only (the
run mode takes ~10 min and a few GB).
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
from dynamicfusion_tpu.models import warpfield as jw  # noqa: E402
from dynamicfusion_tpu.pipeline import kinfu as jkinfu  # noqa: E402
from dynamicfusion_tpu.solvers import warp_solver as js  # noqa: E402
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg  # noqa: E402
from dynamicfusion_tpu_torch.io import synthetic  # noqa: E402
from dynamicfusion_tpu_torch.models import warpfield as tw  # noqa: E402
from dynamicfusion_tpu_torch.solvers import warp_solver as ts  # noqa: E402


def rel_to_f64(inv, m):
    """Largest block error of ``inv`` against the float64 inverse of ``m``,
    relative to that block's largest entry: (median, max) over blocks."""
    ref = np.linalg.inv(m.astype(np.float64))
    e = np.abs(np.asarray(inv, np.float64) - ref).max((1, 2)) / np.abs(ref).max((1, 2))
    e = e[np.isfinite(e)]
    return float(np.median(e)), float(e.max())


def jax_first_step(jc, field, inputs):
    n = field.positions.shape[0]
    s = js.prepare(jc, field, inputs, True)
    r, jac, _ = js.data_residual_and_jac(jc, s, field.dq, True)
    rows = jnp.einsum("prkd,pkn->prdn", jac.astype(jnp.bfloat16), jax.nn.one_hot(s.knn_idx, n, dtype=jnp.bfloat16))
    rows = rows.reshape(-1, 6 * n)
    re, je_i, je_j, _ = js.edge_residual_and_jac(jc, s, field.dq)
    eb = js.edge_blocks(s, je_i, je_j, n)
    hi = jax.lax.Precision.HIGHEST
    h_p = jnp.einsum("prkd,prke->pkde", jac, jac, precision=hi)
    blocks = jnp.einsum("pkn,pkde->nde", jax.nn.one_hot(s.knn_idx, n, dtype=jnp.float32), h_p, precision=hi)
    blocks_full = blocks + eb["diag_blocks"]
    diag = jnp.diagonal(blocks_full, axis1=-2, axis2=-1).reshape(-1)
    active = jnp.repeat(field.active, 6)
    mean = jnp.sum(jnp.where(active, diag, 0.0)) / jnp.maximum(jnp.sum(active.astype(jnp.float32)), 1.0)
    damp = jc.solver_lm_lambda_init * jnp.maximum(diag, jc.solver_damping_floor * mean) + jnp.where(
        active & (diag > 1e-12), 1e-8, 1.0)

    def mv(p):
        pd = p.reshape(n, 6).T.reshape(-1)
        t = jnp.dot(rows, pd.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
        apd = jnp.dot(t.astype(jnp.bfloat16), rows, preferred_element_type=jnp.float32)
        return apd.reshape(6, n).T.reshape(-1) + js.edge_matvec(s, eb, p, n) + damp * p

    m = np.asarray(blocks_full + jax.vmap(jnp.diag)(damp.reshape(n, 6)))
    jtr = js.data_jtr(s, jac, r, n) + js.edge_jtr(s, je_i, je_j, re, n)
    minv = js.spd6_inv(jnp.asarray(m))
    step = -js._pcg(mv, minv, jtr, n, jc.solver_linear_iters, jc.solver_linear_tol)
    step64 = -js._pcg(mv, jnp.asarray(np.linalg.inv(m.astype(np.float64)).astype(np.float32)), jtr, n,
                      jc.solver_linear_iters, jc.solver_linear_tol)
    return m, np.asarray(minv), np.asarray(step), np.asarray(step64)


def port_first_step(tc, field, inputs):
    n = field.positions.shape[0]
    s = ts.prepare(tc, field, inputs)
    dt = ts.data_term(tc, s, field.dq, True)
    et = ts.edge_term(tc, s, field.dq)
    blocks_full = dt.blocks + et.diag
    diag_eff, unit = ts.damping_terms(tc, field.active, blocks_full)
    damp = tc.solver_lm_lambda_init * diag_eff + unit
    m = blocks_full + torch.diag_embed(damp.reshape(n, 6))
    minv = ts.spd6_inv(m)
    sysm = ts.System(dt.rows, et, damp)
    on = torch.ones((), dtype=torch.bool)
    b = dt.jtr + et.jtr
    step = -ts.pcg(s, sysm, minv, b, tc.solver_linear_iters, tc.solver_linear_tol, on)
    inv64 = torch.linalg.inv(m.double()).float()
    step64 = -ts.pcg(s, sysm, inv64, b, tc.solver_linear_iters, tc.solver_linear_tol, on)
    return m.numpy(), minv.numpy(), step.numpy(), step64.numpy()


def report(name, m, minv, step, step64):
    cond = np.linalg.cond(m.astype(np.float64))
    med, mx = rel_to_f64(minv, m)
    print(f"[{name}] damped blocks: condition number median {np.median(cond):.3e}, max {cond.max():.3e}; "
          f"spd6_inv vs float64 inverse: median {med:.3e}, max {mx:.3e}; non-finite inverse entries "
          f"{int((~np.isfinite(minv)).sum())}")
    print(f"[{name}] first PCG step: non-finite entries {int((~np.isfinite(step)).sum())} of {step.size} with the "
          f"closed-form preconditioner, {int((~np.isfinite(step64)).sum())} with the float64 inverse")


def load_dump(path):
    """(warp field, solve inputs) of a ``--dump-solve`` file as numpy dicts."""
    z = np.load(path)
    warp = {k[5:]: z[k] for k in z.files if k.startswith("warp_")}
    ins = {k[7:]: z[k] for k in z.files if k.startswith("inputs_")}
    return warp, ins


def dump_main(path) -> int:
    jc, tc = JCfg.default_dynamicfusion(), TCfg.default_dynamicfusion()
    warp, ins = load_dump(path)
    jfield = jw.WarpField(**{k: jnp.asarray(v) for k, v in warp.items()})
    jin = js.WarpSolveInputs(**{k: jnp.asarray(v) for k, v in ins.items()})
    tfield = tw.WarpField(**{k: torch.from_numpy(v) for k, v in warp.items()})
    tin = ts.WarpSolveInputs(**{k: torch.from_numpy(v) for k, v in ins.items()})
    print(f"system: {int(warp['count'])} of {warp['active'].shape[0]} nodes active, "
          f"{ins['p_can'].shape[0]} map points")
    report("jax", *jax_first_step(jc, jfield, jin))
    report("port", *port_first_step(tc, tfield, tin))
    _, jst = jax.jit(lambda f, i: js.solve(jc, f, i))(jfield, jin)
    _, tst = ts.solve(tc, tfield, tin)
    for name, st in (("jax", jst), ("port", tst)):
        print(f"[{name}] solve: cost0 {float(st.initial_cost):.6e}, cost1 {float(st.final_cost):.6e}, "
              f"accepted {int(st.accepted_steps)} of {jc.solver_nonlinear_iters}")
    return 0


def zeroed_nodes(step, active) -> int:
    """Active nodes whose step has a non-finite entry: the solve zeroes them."""
    bad = ~np.isfinite(np.asarray(step).reshape(-1, 6)).all(-1)
    return int((bad & np.asarray(active)).sum())


def stops_at_initial(cfg, stats) -> bool:
    """One accepted step and the final cost within the stop test's
    tolerance of the initial one: the solve ended at iteration 0."""
    c0, c1 = float(stats.initial_cost), float(stats.final_cost)
    return int(stats.accepted_steps) == 1 and abs(c0 - c1) <= cfg.solver_function_tolerance * max(c1, 1e-20)


def classify_jax(jc, warp, ins, solve_full, solve_one):
    field = jw.WarpField(**{k: jnp.asarray(v) for k, v in warp.items()})
    inputs = js.WarpSolveInputs(**{k: jnp.asarray(v) for k, v in ins.items()})
    _, _, step, _ = jax_first_step(jc, field, inputs)
    _, one = solve_one(field, inputs)
    _, full = solve_full(field, inputs)
    return dict(nonfinite=int((~np.isfinite(step)).sum()), size=step.size,
                zeroed=zeroed_nodes(step, warp["active"]), accept0=bool(int(one.accepted_steps) == 1),
                stop=stops_at_initial(jc, full), cost0=float(full.initial_cost), cost1=float(full.final_cost),
                accepted=int(full.accepted_steps))


def classify_port(tc, warp, ins):
    field = tw.WarpField(**{k: torch.from_numpy(np.array(v)) for k, v in warp.items()})
    inputs = ts.WarpSolveInputs(**{k: torch.from_numpy(np.array(v)) for k, v in ins.items()})
    _, _, step, _ = port_first_step(tc, field, inputs)
    trace = []
    _, full = ts.solve(tc, field, inputs, trace=trace)
    return dict(nonfinite=int((~np.isfinite(step)).sum()), size=step.size,
                zeroed=zeroed_nodes(step, warp["active"]), accept0=bool(trace[0][4]),
                stop=stops_at_initial(tc, full), cost0=float(full.initial_cost), cost1=float(full.final_cost),
                accepted=int(full.accepted_steps))


def run_main(frames: int) -> int:
    jc, tc = JCfg.default_dynamicfusion(), TCfg.default_dynamicfusion()
    depths = synthetic.deforming_frames(tc.intr, tc.rows, tc.cols, frames)
    print(f"default_dynamicfusion(): {tc.cols}x{tc.rows} / {tc.volume_dims}^3 / {tc.max_nodes} nodes, "
          f"{frames} frames of the deforming scene; CPU", flush=True)
    captured = []

    def record(field, inputs):
        captured.append(({k: np.array(v) for k, v in field._asdict().items()},
                         {k: np.array(v) for k, v in inputs._asdict().items() if v is not None}))

    def solve_fn(field, inputs):
        jax.debug.callback(record, field, inputs)
        return js.solve(jc, field, inputs)

    first = jax.jit(lambda s, d: jkinfu.first_frame(jc, s, d))
    step = jax.jit(lambda s, d: jkinfu.step(jc, s, d, warp_solve_fn=solve_fn))
    solve_full = jax.jit(lambda f, i: js.solve(jc, f, i))
    jc1 = dataclasses.replace(jc, solver_nonlinear_iters=1)
    solve_one = jax.jit(lambda f, i: js.solve(jc1, f, i))
    t0 = time.perf_counter()
    state = first(jkinfu.init_state(jc), jnp.asarray(depths[0]))
    outs = []
    for d in depths[1:]:
        state, o = step(state, jnp.asarray(d))
        outs.append((bool(o.icp_ok), float(o.solver_cost0), float(o.solver_cost1)))
    jax.effects_barrier()
    print(f"JAX: {len(captured)} steps captured at {time.perf_counter() - t0:.1f} s", flush=True)
    print("step | icp_ok | package: first step non-finite entries / size, zeroed active nodes | iteration 0 "
          "accepts | candidate is the renormalized field | solve stops at its initial cost | cost0 -> cost1, "
          "accepted", flush=True)
    counts = {"jax": [0, 0, 0, 0], "port": [0, 0, 0, 0]}
    for i, ((warp, ins), (ok, c0, c1)) in enumerate(zip(captured, outs), start=1):
        n_active = int(np.asarray(warp["active"]).sum())
        for name, r in (("jax", classify_jax(jc, warp, ins, solve_full, solve_one)),
                        ("port", classify_port(tc, warp, ins))):
            null = r["zeroed"] == n_active
            for k, v in enumerate((r["nonfinite"] > 0, r["accept0"], r["accept0"] and null, r["stop"])):
                counts[name][k] += int(v)
            print(f"{i:4d} | {ok} | {name}: {r['nonfinite']} / {r['size']}, {r['zeroed']} of {n_active} | "
                  f"{r['accept0']} | {null} | {r['stop']} | {r['cost0']:.6e} -> {r['cost1']:.6e}, "
                  f"{r['accepted']}", flush=True)
    n = len(captured)
    for name, (nf, acc, acc_null, stop) in counts.items():
        print(f"[{name}] of {n} steps: first step non-finite on {nf}; iteration 0 accepts on {acc}, the "
              f"renormalized field on {acc_null}; the solve stops at its initial cost on {stop}", flush=True)
    print(f"done at {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("solve", nargs="?", default=None, help="a chip_smoke.py --dump-solve file (dump mode)")
    ap.add_argument("--frames", type=int, default=20, help="frames of the deforming scene (run mode)")
    ap.add_argument("--threads", type=int, default=4, help="PyTorch intra-op threads")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    return dump_main(args.solve) if args.solve else run_main(args.frames)


if __name__ == "__main__":
    sys.exit(main())
