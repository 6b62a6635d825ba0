"""The port's warp solver (factored-PCG path) against the JAX package on
the CPU: one LM solve at 12 and at 100 PCG iterations, and the rigid
pre-alignment, on tests/test_torch_warp_solver.py's sphere problem and
with its tolerances (the initial cost within TOL_COST0; the final cost and
the warped surface within SPREAD times JAX's own spread under three 1e-7
perturbations of p_live: that file's docstring says why). A file of its
own, so that ``--dist loadfile`` spreads the JAX compiles over the
workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch.solvers import warp_solver as ts
from test_torch_warp_solver import JC, P, SPREAD, TC, TOL_COST0, TOL_PREALIGN, _problem, _t


@pytest.mark.parametrize("linear_iters", [12, 100])
def test_solve_matches_jax(linear_iters):
    jfield, tfield, ji, ti = _problem(1)
    jc = dataclasses.replace(JC, solver_linear_iters=linear_iters)
    tc = dataclasses.replace(TC, solver_linear_iters=linear_iters)
    solve = jax.jit(lambda f, i: js.solve(jc, f, i))
    surface = jnp.nan_to_num(ji.p_can)

    def warped(field):
        return np.asarray(jw.warp_points(field, surface))

    jf, jst = solve(jfield, ji)
    rng = np.random.RandomState(5)
    costs, surfs = [], []
    for _ in range(3):
        pert = ji._replace(p_live=ji.p_live * (1.0 + jnp.asarray(rng.randn(P, 3).astype(np.float32)) * 1e-7))
        f2, s2 = solve(jfield, pert)
        costs.append(float(s2.final_cost))
        surfs.append(warped(f2))
    tf, tst = ts.solve(tc, tfield, ti)
    c0, c1 = float(jst.initial_cost), float(jst.final_cost)
    assert abs(float(tst.initial_cost) - c0) <= TOL_COST0 * c0
    assert int(tst.accepted_steps) == int(jst.accepted_steps)
    assert float(tst.final_cost) < float(tst.initial_cost)
    spread_c = max(abs(c - c1) for c in costs)
    assert abs(float(tst.final_cost) - c1) <= SPREAD * spread_c + 1e-3 * c1
    # the solved field where the data sees it: the warped surface (m)
    ref = warped(jf)
    spread_s = max(float(np.abs(w - ref).max()) for w in surfs)
    got = warped(jw.WarpField(*(jnp.asarray(a.numpy()) for a in tf)))
    assert float(np.abs(got - ref).max()) <= SPREAD * spread_s + 1e-5
    inactive = ~tfield.active.numpy()
    np.testing.assert_array_equal(tf.dq.numpy()[inactive], tfield.dq.numpy()[inactive])


def test_rigid_prealign_matches_jax():
    """On a sphere over a plane with two walls (every rigid motion
    observable by point-to-plane), shifted by a few millimetres."""
    jfield, tfield, ji, ti = _problem(2)
    rng = np.random.RandomState(7)
    pts, nrm = [np.nan_to_num(np.asarray(ji.p_can))], [np.asarray(ji.n_can)]
    for axis, at, sign in ((2, 1.25, -1.0), (0, -0.3, 1.0), (1, 0.25, -1.0)):
        p = (rng.uniform(-0.3, 0.3, (800, 3)) + [0.0, 0.0, 1.0]).astype(np.float32)
        p[:, axis] = at
        n = np.zeros((800, 3), np.float32)
        n[:, axis] = sign
        pts.append(p)
        nrm.append(n)
    p_can, n = np.concatenate(pts), np.concatenate(nrm)
    shift = np.array([0.004, -0.003, 0.002], np.float32)
    arrs = [p_can, n, p_can + shift, n]
    jt = np.asarray(js.rigid_prealign(JC, jfield, js.WarpSolveInputs(*(jnp.asarray(a) for a in arrs))))
    tt = ts.rigid_prealign(TC, tfield, ts.WarpSolveInputs(*(_t(a) for a in arrs))).numpy()
    np.testing.assert_allclose(tt, jt, atol=TOL_PREALIGN, rtol=0)
    assert np.abs(jt - np.eye(4)).max() > 1e-3  # it does move the pose
