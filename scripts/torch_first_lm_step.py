"""The first LM iteration of the warp solve at full width, in the JAX
package and in the port's plain version, on the CPU, from one dumped
system.

``python3 chip_smoke.py --dump-solve FILE`` writes the warp field and the
solve's point sets of its phase-2 state (the dynamicfusion preset after
three frames of the deforming scene, the next frame tracked: 1024 nodes,
19 200 map points). This script loads that file and, for both packages,
builds the first iteration's damped 6x6 blocks as the factored solve does,
inverts them with the closed-form ``spd6_inv``, runs the PCG from them and
prints how many entries of the step are not finite, the blocks' condition
numbers and the inverse's error against float64; then each package's whole
solve (initial and final cost, accepted steps).

    python3 scripts/torch_first_lm_step.py solve.npz

Imports both packages, as the parity tests do; runs on the CPU only.
"""

import os
import sys
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
from dynamicfusion_tpu.solvers import warp_solver as js  # noqa: E402
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg  # noqa: E402
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


def main() -> int:
    if len(sys.argv) != 2:
        print(f"usage: {sys.argv[0]} SOLVE_NPZ", file=sys.stderr)
        return 2
    z = np.load(sys.argv[1])
    jc, tc = JCfg.default_dynamicfusion(), TCfg.default_dynamicfusion()
    warp = {k[5:]: z[k] for k in z.files if k.startswith("warp_")}
    ins = {k[7:]: z[k] for k in z.files if k.startswith("inputs_")}
    jfield = jw.WarpField(**{k: jnp.asarray(v) for k, v in warp.items()})
    jin = js.WarpSolveInputs(**{k: jnp.asarray(v) for k, v in ins.items()})
    tfield = tw.WarpField(**{k: torch.from_numpy(v) for k, v in warp.items()})
    tin = ts.WarpSolveInputs(**{k: torch.from_numpy(v) for k, v in ins.items()})
    print(f"system: {int(warp['count'])} of {warp['active'].shape[0]} nodes active, "
          f"{ins['p_can'].shape[0]} map points")
    torch.set_num_threads(4)
    report("jax", *jax_first_step(jc, jfield, jin))
    report("port", *port_first_step(tc, tfield, tin))
    _, jst = jax.jit(lambda f, i: js.solve(jc, f, i))(jfield, jin)
    _, tst = ts.solve(tc, tfield, tin)
    for name, st in (("jax", jst), ("port", tst)):
        print(f"[{name}] solve: cost0 {float(st.initial_cost):.6e}, cost1 {float(st.final_cost):.6e}, "
              f"accepted {int(st.accepted_steps)} of {jc.solver_nonlinear_iters}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
