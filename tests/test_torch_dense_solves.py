"""The port's direct (dense/Cholesky) warp solve against the JAX package,
on the CPU: one solve each of the lagged loop with one factor reused, the
unlagged loop, the bf16 Gram and the dense-matrix PCG at ``small()``
widths (the tolerances of tests/test_torch_dense_solver.py: the initial
cost within TOL_COST0, the final cost and the warped surface within SPREAD
times the spread of JAX's own solves). A file of its own, so that
``--dist loadfile`` spreads the dense solve's JAX compiles over the
workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch.solvers import warp_solver as ts
from test_torch_dense_solver import JC, N, P, SPREAD, TC, TOL_COST0


# ---------------------------------------------------------------- one solve of each loop


@pytest.mark.parametrize("variant", [
    dict(),  # the base config: int8 Gram, lagged JᵀJ, one factor reused
    dict(solver_lagged_jtj=False),
    dict(solver_jtj_int8=False),
    dict(solver_linear="pcg", solver_lagged_jtj=False),  # block-Jacobi PCG over the dense matrix
], ids=["lagged_int8_reuse", "unlagged", "bf16_gram", "pcg_unlagged"])
def test_solve_matches_jax(variant):
    jfield, tfield, ji, ti = cases.sphere_problem(1, N, P)
    jc, tc = (dataclasses.replace(c, **variant) for c in (JC, TC))
    solve = jax.jit(lambda f, i: js.solve(jc, f, i))
    surface = jnp.nan_to_num(ji.p_can)

    def warped(field):
        return np.asarray(jw.warp_points(field, surface))

    jf, jst = solve(jfield, ji)
    costs, surfs = [], []
    pos = np.asarray(jfield.positions)
    for seed in range(3):
        noise = 1.0 + 1e-7 * np.random.RandomState(seed).randn(*pos.shape)
        f2, s2 = solve(jfield._replace(positions=jnp.asarray((pos * noise).astype(np.float32))), ji)
        costs.append(float(s2.final_cost))
        surfs.append(warped(f2))
    tf, tst = ts.solve(tc, tfield, ti)
    c0, c1 = float(jst.initial_cost), float(jst.final_cost)
    assert abs(float(tst.initial_cost) - c0) <= TOL_COST0 * c0
    assert float(tst.final_cost) < float(tst.initial_cost)
    spread_c = max(abs(c - c1) for c in costs)
    assert abs(float(tst.final_cost) - c1) <= SPREAD * spread_c + 1e-3 * c1
    ref = warped(jf)
    spread_s = max(float(np.abs(w - ref).max()) for w in surfs)
    got = warped(jw.WarpField(*(jnp.asarray(a.numpy()) for a in tf)))
    assert float(np.abs(got - ref).max()) <= SPREAD * spread_s + 1e-5
    inactive = ~tfield.active.numpy()
    np.testing.assert_array_equal(tf.dq.numpy()[inactive], tfield.dq.numpy()[inactive])
