"""The port's direct (dense/Cholesky) warp solve against the JAX package,
on the CPU: the dense Gram of the data rows (kernel N's plain version,
int8 and bf16), the ARAP blocks placed in it, the damping (kernel O's
plain version), the Cholesky step, the point-to-point data term, the JAX
package's solver-oracle scenes, one solve each of the lagged loop with one
factor reused, the unlagged loop and the bf16 Gram, and the base config's
and the non-rigid ``reference_parity()``'s steps on bench.py's deforming
scene at ``small()``.

The JAX package's functions run jitted here, as its pipeline runs them:
XLA folds data_jtj's division of the column maxima by the constant 127
into a product with the float32 reciprocal (op by op the division is
true), which moves some scales by an ulp and, through the quantization,
2% of the int8 Gram's entries.

Tolerances, each with its reason:
- the int8 Gram is bit-equal to the jitted JAX package's: the same bf16
  rows quantize alike (the scales as XLA takes them, a true division of
  the rows by them, round half to even), the integer Gram is exact in
  any order, and the scale product is taken in the JAX order;
- the bf16 Gram within TOL_BF16_GRAM of the matrix's largest entry: the
  products are exact in float32, the sums' order differs;
- the ARAP blocks placed, and the damping, within float32 last bits
  (TOL_EDGE, TOL_DAMP: the blocks come from two Jacobians that differ in
  their last bits, the mean diagonal is summed in another order);
- the system from the port's own rows within TOL_SYSTEM: a last-bit
  difference of a Jacobian entry may flip its bf16 rounding (2^-8 of the
  entry) and, in the int8 Gram, its quantization step;
- the Cholesky step within TOL_STEP relative (two LAPACK factorizations);
- a solve's initial cost within TOL_COST0 relative; its final cost and
  warped surface within SPREAD times the spread of JAX's own solves with
  the node positions moved by 1e-7 relative (as ``jax_spread`` moves
  them): at the first LM lambda the damped dense system is so ill
  conditioned that a bf16 rounding flipped by a last bit of a Jacobian
  entry moves the step by ~10% (a 1e-4 relative change of the system),
  and JAX's own solves part by ~1% in cost and cm on the surface;
- the oracle scenes within the JAX package's own test tolerances
  (tests/test_warp_solver.py), of the targets and of JAX's field; their
  initial cost within TOL_ORACLE_COST0 (the Tukey rho cancels there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import se3 as jse3
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.models import warpfield as tw
from dynamicfusion_tpu_torch.solvers import warp_solver as ts

TOL_BF16_GRAM = 1e-6
TOL_EDGE = 1e-5
TOL_DAMP = 1e-6
TOL_SYSTEM = 2e-2
TOL_DATA = 1e-4
TOL_STEP = 1e-4
TOL_COST0 = 1e-5
# the oracle's Tukey c = 10 puts its residuals at x^2 ~ 1e-5, where the
# float32 rho (c^2/6)(1 - (1 - x^2)^3) cancels: JAX takes the cube as a
# power, the port as two products, and the costs part by ~1e-4
TOL_ORACLE_COST0 = 1e-3
SPREAD = 4.0

N = 128
P = 2400
# the base config (direct, int8 Gram, lagged JᵀJ, one factor reused) at N nodes
JC = dataclasses.replace(JCfg.small(), max_nodes=N)
TC = dataclasses.replace(TCfg.small(), max_nodes=N)


# the JAX package's functions jitted, as its pipeline runs them
j_data = jax.jit(js.data_residual_and_jac, static_argnums=(0, 3))
j_edge = jax.jit(js.edge_residual_and_jac, static_argnums=0)
j_data_jtj = jax.jit(js.data_jtj, static_argnums=(0, 3))
j_edge_jtj = jax.jit(js.edge_jtj, static_argnums=3)
j_system = jax.jit(js.gn_system_dense, static_argnums=(0, 3, 4))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref):
    ref, got = np.asarray(ref), np.asarray(got)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _structures(jc, tc, prob):
    """JAX's structure and the port's, the port's on JAX's neighbour lists
    and weights (KNN's near ties are held in test_torch_warp_solver.py)."""
    jfield, tfield, ji, ti = prob
    s = js.prepare(jc, jfield, ji, jc.point_to_plane)
    t = ts.prepare(tc, tfield, ti)
    idx = _t(s.knn_idx).long()
    n = tfield.positions.shape[0]
    return s, t._replace(knn_idx=idx, w_knn=_t(s.w_knn), valid=_t(s.valid), pts_by_node=ts.node_lists(idx, n))


@pytest.fixture(scope="module")
def prob():
    return cases.sphere_problem(0, N, P)


@pytest.fixture(scope="module")
def sparse_prob():
    """Few active nodes: every point's 8 neighbours include inactive ones."""
    return cases.sphere_problem(1, 16, 600, active_frac=0.4)


def _rows(jac):
    return torch.from_numpy(np.array(jac.astype(jnp.float32))).to(torch.bfloat16)


# ---------------------------------------------------------------- D1: the data Gram


@pytest.mark.parametrize("point_to_plane", [True, False], ids=["R1", "R3"])
@pytest.mark.parametrize("which", ["prob", "sparse_prob"])
def test_data_gram_matches_jax(request, which, point_to_plane):
    pr = request.getfixturevalue(which)
    n = pr[1].positions.shape[0]
    jc = dataclasses.replace(JC, max_nodes=n, point_to_plane=point_to_plane)
    tc = dataclasses.replace(TC, max_nodes=n, point_to_plane=point_to_plane)
    s, t = _structures(jc, tc, pr)
    if which == "sparse_prob":
        assert not pr[1].active[t.knn_idx].all(1).any()
    _, jac, _ = j_data(jc, s, pr[0].dq, point_to_plane)
    assert jac.shape[1] == (1 if point_to_plane else 3)
    rows = _rows(jac)
    none = torch.zeros(0, dtype=torch.long)
    for int8 in (True, False):
        ref = np.asarray(j_data_jtj(dataclasses.replace(jc, solver_jtj_int8=int8), s, jac, n))
        got = ts.dense_gram_plain(rows, t.knn_idx, int8, torch.zeros((0, 6, 6)), torch.zeros((n, 6, 6)), none,
                                  none).numpy()
        if int8:
            np.testing.assert_array_equal(got, ref)
        else:
            assert _rel(got, ref) <= TOL_BF16_GRAM


def test_gram_scales_match_jax(prob):
    jfield, tfield, _, _ = prob
    s, t = _structures(JC, TC, prob)
    _, jac, _ = j_data(JC, s, jfield.dq, True)
    a = ts.dense_rows(_rows(jac), t.knn_idx, N)
    af = np.asarray(jnp.einsum("pkn,prkd->prnd", jax.nn.one_hot(s.knn_idx, N, dtype=jnp.bfloat16),
                               jac.astype(jnp.bfloat16)).reshape(-1, 6 * N).astype(jnp.float32))
    np.testing.assert_array_equal(a.numpy(), af)
    ref = np.maximum(np.abs(af).max(0), 1e-12) * np.float32(1.0 / 127.0)
    np.testing.assert_array_equal(ts.gram_scales_plain(a).numpy(), ref)


# ---------------------------------------------------------------- D2: the edge blocks placed; the system


def test_edge_blocks_placed_match_jax(prob):
    jfield, tfield, _, _ = prob
    s, t = _structures(JC, TC, prob)
    _, je_i, je_j, _ = j_edge(JC, s, jfield.dq)
    ref = np.asarray(j_edge_jtj(s, je_i, je_j, N))
    et = ts.edge_term(TC, t, tfield.dq)
    zero_rows = torch.zeros((1, 1, 8, 6), dtype=torch.bfloat16)
    got = ts.dense_gram_plain(zero_rows, torch.arange(8)[None], True, et.h_ij, et.diag, t.e_src, t.e_dst).numpy()
    assert _rel(got, ref) <= TOL_EDGE
    # the placement itself is exact: the port's blocks placed by JAX's einsums
    h = jnp.asarray(et.h_ij.numpy())
    oh = jax.nn.one_hot(s.e_dst, N, dtype=jnp.float32).reshape(N, -1, N)
    hi = jax.lax.Precision.HIGHEST
    hr = h.reshape(N, -1, 6, 6)
    full = jnp.einsum("ncm,ncab->namb", oh, hr, precision=hi) + jnp.einsum("ncm,ncab->mbna", oh, hr, precision=hi)
    full = full + jnp.einsum("nm,nab->namb", jnp.eye(N), jnp.asarray(et.diag.numpy()), precision=hi)
    np.testing.assert_array_equal(got, np.asarray(full).reshape(6 * N, 6 * N))


@pytest.mark.parametrize("int8", [True, False])
def test_dense_system_matches_jax(prob, int8):
    """The port's system (its own rows, kernel F's plain version) against
    gn_system_dense at the same state: Gram, gradient and cost."""
    jfield, tfield, _, _ = prob
    jc, tc = (dataclasses.replace(c, solver_jtj_int8=int8) for c in (JC, TC))
    s, t = _structures(jc, tc, prob)
    jtj, jtr, cost = j_system(jc, s, jfield.dq, N, True)
    dt = ts.data_term(tc, t, tfield.dq, system=True)
    et = ts.edge_term(tc, t, tfield.dq)
    got = ts.dense_gram(tc, t, dt, et)
    assert _rel(got.numpy(), jtj) <= TOL_SYSTEM
    assert _rel((dt.jtr + et.jtr).numpy(), jtr) <= TOL_DATA
    assert _rel((dt.cost + et.cost).numpy(), cost) <= TOL_DATA


# ---------------------------------------------------------------- D3: damping, factor, step


def _jax_damped(jtj, lm_lambda, active, floor):
    """The JAX package's _damped_system (solve's closure, warp_solver.py:1182)."""
    active_dof = jnp.repeat(active, 6)
    diag = jnp.diagonal(jtj)
    mean_diag = jnp.sum(jnp.where(active_dof, diag, 0.0)) / jnp.maximum(jnp.sum(active_dof.astype(jnp.float32)), 1.0)
    diag_eff = jnp.maximum(diag, floor * mean_diag)
    return jtj + jnp.diag(lm_lambda * diag_eff) + jnp.diag(jnp.where(active_dof & (diag > 1e-12), 1e-8, 1.0))


@pytest.fixture(scope="module")
def system(prob):
    jfield, _, _, _ = prob
    s, _ = _structures(JC, TC, prob)
    jtj, jtr, _ = j_system(JC, s, jfield.dq, N, True)
    return jfield.active, jtj, jtr


@pytest.mark.parametrize("lm_lambda", [1e-4, 8.0])
def test_damped_system_and_step_match_jax(system, lm_lambda):
    """The damped system; the Cholesky step against _solve_linear's to
    TOL_STEP where the damping makes the system well conditioned (lambda
    8, what a rejected step leads to), and at the solve's first lambda no
    further from the float64 solution than twice JAX's own step (its
    condition number, printed, amplifies the two float32 factorizations'
    last bits to ~1e-3)."""
    active, jtj, jtr = system
    floor = JC.solver_damping_floor
    ref = np.asarray(_jax_damped(jtj, jnp.float32(lm_lambda), active, floor))
    got = ts.dense_damp(_t(jtj), torch.tensor(lm_lambda, dtype=torch.float32), _t(active), floor)
    off = ~np.eye(6 * N, dtype=bool)
    np.testing.assert_array_equal(got.numpy()[off], ref[off])
    assert _rel(np.diagonal(got.numpy()), np.diagonal(ref)) <= TOL_DAMP
    step = ts.chol_step(ts.cholesky(_t(ref)), _t(jtr)).numpy()
    jstep = np.asarray(js._solve_linear(JC, jnp.asarray(ref), jtr, N))
    exact = -np.linalg.solve(ref.astype(np.float64), np.asarray(jtr, np.float64))
    print(f"lambda {lm_lambda}: condition number {np.linalg.cond(ref.astype(np.float64)):.3e}, step relative to "
          f"JAX's {_rel(step, jstep):.3e}, to float64 port {_rel(step, exact):.3e} JAX {_rel(jstep, exact):.3e}")
    if lm_lambda >= 1.0:
        assert _rel(step, jstep) <= TOL_STEP
    else:
        assert _rel(step, exact) <= 2.0 * _rel(jstep, exact)


def test_not_positive_definite_gives_a_zero_step(system):
    """JAX's factor of a matrix that is not positive definite is NaN, so
    its step is non-finite and ``solve`` zeroes it; cholesky_ex returns a
    finite partial factor, which the port turns into NaN."""
    _, jtj, jtr = system
    bad = np.array(jtj)
    bad[10, 10] = -1.0
    jstep = np.asarray(js._solve_linear(JC, jnp.asarray(bad), jtr, N)).reshape(N, 6)
    tstep = ts.chol_step(ts.cholesky(_t(bad)), _t(jtr)).reshape(N, 6)
    assert not np.isfinite(jstep).any() and not torch.isfinite(tstep).any()
    zero = torch.where(torch.isfinite(tstep).all(-1, keepdim=True), tstep, 0.0)
    assert not zero.any()
    chol, info = torch.linalg.cholesky_ex(_t(bad), check_errors=False)
    assert int(info) > 0 and torch.isfinite(chol).all()  # what the port must not use as it is


# ---------------------------------------------------------------- P1: the point-to-point term


def test_point_to_point_term_matches_jax(prob):
    jfield, tfield, _, _ = prob
    jc, tc = (dataclasses.replace(c, point_to_plane=False) for c in (JC, TC))
    s, t = _structures(jc, tc, prob)
    r, jac, cost = j_data(jc, s, jfield.dq, False)
    tr, tjac, tcost = ts.data_residual_and_jac(tc, t, tfield.dq)
    assert tr.shape == r.shape == (t.knn_idx.shape[0], 3) and tjac.shape == jac.shape
    assert _rel(tr.numpy(), r) <= TOL_DATA
    assert _rel(tjac.numpy(), jac) <= TOL_DATA
    assert _rel(tcost.numpy(), cost) <= TOL_DATA
    dt = ts.data_term(tc, t, tfield.dq, system=True)
    assert dt.rows.shape == (t.knn_idx.shape[0], 3, 8, 6)
    assert _rel(dt.jtr.numpy(), js.data_jtr(s, jac, r, N)) <= TOL_DATA
    jg, jcost = js.data_grad_cost(jc, s, jfield.dq, N, False)
    assert _rel(dt.jtr.numpy(), jg) <= TOL_DATA and _rel(dt.cost.numpy(), jcost) <= TOL_DATA


def test_prepare_point_to_point_ignores_the_normals(prob):
    """Point-to-point needs no live normal: a NaN normal leaves its point
    valid, as in the JAX package, and point-to-plane drops it."""
    jfield, tfield, ji, ti = prob
    n_live = np.array(ji.n_live)
    n_live[::5] = np.nan
    ji, ti = ji._replace(n_live=jnp.asarray(n_live)), ti._replace(n_live=_t(n_live))
    for p2pl in (False, True):
        jc, tc = (dataclasses.replace(c, point_to_plane=p2pl) for c in (JC, TC))
        s = js.prepare(jc, jfield, ji, p2pl)
        t = ts.prepare(tc, tfield, ti)
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(s.valid))
        assert bool(t.valid[::5].any()) != p2pl


# ---------------------------------------------------------------- the solver oracle's scenes

CUBE = np.array([[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1], [-1, 1, 1], [-1, 1, -1], [-1, -1, 1], [-1, -1, -1]],
                np.float32)
# tests/test_warp_solver.py's ORACLE_CFG: the dense solve, the bf16 Gram,
# the unlagged JᵀJ and the point-to-point term, on a cube of 8 nodes
ORACLE = dict(
    volume_dims=64, max_nodes=16, node_sample_step=1, node_radius=3.0, knn_k=8, solver_nonlinear_iters=8,
    solver_linear_iters=60, solver_tukey_c=10.0, solver_huber_delta=10.0, solver_arap_weight=1e-4,
    point_to_plane=False, knn_method="exact", solver_linear="direct", solver_jtj_int8=False,
    solver_lagged_jtj=False,
)


def _oracle_scene(name):
    """(config changes, canonical points, live points, tolerance) of the
    oracle scenes: tests/test_warp_solver.py's rigid shift, non-rigid
    multiple nodes, and its known rigid offset (TestRigidPrealign's scene,
    here through the whole solve)."""
    if name == "rigid_shift":
        can = np.array([[2.0, 2.0, 2.0], [3.0, 3.0, 3.0]], np.float32)
        return {}, can, can + 0.05, 1e-3
    if name == "multiple_nodes_nonrigid":
        can = np.array([[-1, -1, -1], [1, 1, 1], [1, -1, 1], [-1, 1, -1]], np.float32) * 0.8
        disp = np.array([[0.03, 0, 0], [0, 0.04, 0], [-0.02, 0.01, 0.02], [0.01, -0.03, 0.01]], np.float32)
        return dict(solver_arap_weight=0.0), can, can + disp, 2e-3
    rng = np.random.default_rng(7)
    can = rng.uniform(-0.5, 0.5, (400, 3)).astype(np.float32)
    t_true = np.asarray(jse3.exp_twist(jnp.asarray([0.01, -0.02, 0.015, 0.02, 0.01, -0.03])))
    live = ((can - t_true[:3, 3]) @ t_true[:3, :3]).astype(np.float32)
    return dict(solver_tukey_c=1.0), can, live, 2e-3


@pytest.mark.parametrize("scene", ["rigid_shift", "multiple_nodes_nonrigid", "known_rigid_offset"])
def test_oracle_scenes_match_jax(scene):
    changes, can, live, tol = _oracle_scene(scene)
    jc = dataclasses.replace(JCfg(**ORACLE), **changes)
    tc = dataclasses.replace(TCfg(**ORACLE), **changes)
    jfield = jw.init_from_cloud(jc, jnp.asarray(CUBE), jnp.ones(8, bool))
    tfield = tw.WarpField(*(_t(a) for a in jfield))
    nrm = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), can.shape).copy()
    arrs = (can, nrm, live, nrm)
    jf, jst = js.solve(jc, jfield, js.WarpSolveInputs(*(jnp.asarray(a) for a in arrs)), point_to_plane=False)
    tf, tst = ts.solve(tc, tfield, ts.WarpSolveInputs(*(_t(a) for a in arrs)))
    jwarped = np.asarray(jw.warp_points(jf, jnp.asarray(can)))
    twarped = tw.warp_points(tf, _t(can), k=8).numpy()
    np.testing.assert_allclose(twarped, live, atol=tol)
    np.testing.assert_allclose(twarped, jwarped, atol=tol)
    assert abs(float(tst.initial_cost) - float(jst.initial_cost)) <= TOL_ORACLE_COST0 * float(jst.initial_cost)
    assert float(tst.final_cost) < float(tst.initial_cost)


# ---------------------------------------------------------------- one solve of each loop


@pytest.mark.parametrize("variant", [
    dict(),  # the base config: int8 Gram, lagged JᵀJ, one factor reused
    dict(solver_lagged_jtj=False),
    dict(solver_jtj_int8=False),
], ids=["lagged_int8_reuse", "unlagged", "bf16_gram"])
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


# ---------------------------------------------------------------- the options the port takes


def test_check_cfg_takes_the_dense_options_and_refuses_the_rest():
    for changes in (dict(), dict(solver_lagged_jtj=False), dict(solver_jtj_int8=False), dict(point_to_plane=False),
                    dict(solver_chol_reuse=False), dict(point_to_plane=False, solver_linear="pcg")):
        ts._check_cfg(dataclasses.replace(TCfg(), **changes))
    ts._check_cfg(TCfg.reference_parity())
    with pytest.raises(NotImplementedError, match="solver_lagged_jtj=False"):
        ts._check_cfg(dataclasses.replace(TCfg(), solver_linear="pcg", solver_lagged_jtj=False))
    # the tangential rows' variants need the tangential rows
    ts._check_cfg(dataclasses.replace(TCfg(), point_to_plane=False, solver_p2p_weight=0.25,
                                      solver_p2p_lag_hessian=True))


# ---------------------------------------------------------------- the base config's steps

STEPS = 3
# the base config at small(): its fusion every second frame (small() fuses
# every frame)
BASE = dict(fusion_interval=2)
# reference_parity()'s solver and fusion options
PARITY = dict(node_radius=3.0, solver_tukey_c=0.01, solver_huber_delta=1e-4, solver_arap_weight=200.0,
              fusion_interval=1)


@pytest.fixture(scope="module")
def base_case():
    jc, tc = (dataclasses.replace(c.small(), **BASE) for c in (JCfg, TCfg))
    depths = cases.bench_depths(jc, STEPS + 1)
    jax_frames = cases.jax_run(jc, depths)
    return jc, tc, depths, jax_frames


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_base_config_step_from_jax_state_matches(base_case, frame):
    jc, tc, depths, jax_frames = base_case
    assert tc.solver_linear == "direct" and tc.solver_lagged_jtj and tc.solver_jtj_int8 and tc.solver_chol_reuse
    cases.check_step_from_jax_state(jc, tc, jax_frames, depths, frame)


def test_base_config_free_running_matches_jax(base_case):
    jc, tc, depths, jax_frames = base_case
    port_frames = cases.port_run(tc, depths)
    spread = cases.jax_spread(jc, depths, jax_frames)
    for frame in range(1, STEPS + 1):
        cases.check_free_running(jax_frames, port_frames, frame, spread)
    fused = [int(port_frames[f][1].brick_counts[:2].sum()) > 0 for f in range(1, STEPS + 1)]
    assert fused == [f % 2 == 0 for f in range(1, STEPS + 1)]


def test_reference_parity_step_from_jax_state_matches():
    jc, tc = (dataclasses.replace(c.small(), **PARITY) for c in (JCfg, TCfg))
    depths = cases.bench_depths(jc, 2)
    cases.check_step_from_jax_state(jc, tc, cases.jax_run(jc, depths), depths, 1)
