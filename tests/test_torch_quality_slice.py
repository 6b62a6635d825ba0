"""The port's tangential data term (``quality_dynamicfusion()``'s
``solver_p2p_weight=0.25``) against the JAX package, on the CPU, at
``small()`` with the slice's settings (tests/torch_nonrigid_cases.py) over
bench.py's articulated hold-out scene, the hinge: two spheres scissoring
about a hinge over a plane.

The terms are held on the solve of frame 2 from JAX's state after frame 1,
its point sets as the port tracks them (handed to both packages, with a
seeded per-point gate in place of ones), and JAX's neighbour lists:
tangent basis equal, residual rows (P, 3) and Jacobians (P, 3, K, 6)
within 1e-5 and the cost within 1e-5 relative, Jᵀr and the diagonal
blocks within 1e-4, the bf16 rows within one bf16 ulp of JAX's on every
entry. One LM solve: initial cost within 1e-5 relative, final cost within
four times JAX's own spread under 1e-7 perturbations of p_live (the bf16
rows make the LM step sensitive to last bits, test_torch_warp_solver.py).
The same solve with the tangential rows of every 2nd point, or only the
plane rows, in the PCG matrix (``solver_p2p_hessian_stride=2``,
``solver_p2p_lag_hessian``), on the same terms.
Then three steps of the pipeline, held as tests/test_torch_nonrigid_slice.py
holds the preset's: the port's step from JAX's state (pose 1e-4, initial
cost 1e-5, fusion, nodes and maps) and the free-running pose within
max(1e-3, 2 x JAX's own spread).
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)
from dynamicfusion_tpu.io import synthetic as jsynthetic
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.io import synthetic as tsynthetic
from dynamicfusion_tpu_torch.models import warpfield as tw
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu
from dynamicfusion_tpu_torch.solvers import warp_solver as ts

P2P = 0.25  # quality_dynamicfusion()'s solver_p2p_weight
JC, TC = (dataclasses.replace(c, solver_p2p_weight=P2P) for c in cases.configs())
STEPS = 3

TOL_TERMS = 1e-5   # residual rows, Jacobians and cost, relative to the largest entry
TOL_SYSTEM = 1e-4  # Jᵀr and the diagonal blocks, relative
TOL_BASIS = 1e-6   # tangent basis entries (unit vectors)
SPREAD = 4.0       # final cost: within this many times JAX's own spread (3 samples)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def depths():
    return tsynthetic.hinge_frames(TC.intr, TC.rows, TC.cols, STEPS + 1)


@pytest.fixture(scope="module")
def jax_frames(depths):
    return cases.jax_run(JC, depths)


@pytest.fixture(scope="module")
def port_frames(depths):
    return cases.port_run(TC, depths)


@pytest.fixture(scope="module")
def spread(depths, jax_frames):
    return cases.jax_spread(JC, depths, jax_frames)


def _bench_quality_frame():
    """bench.py's ``_quality_frame`` with its ``_hinge_centers`` and scene
    constants, taken from its source (importing bench.py would configure
    JAX's compilation cache for the whole process), rendering with the
    JAX package's ``io.synthetic``."""
    tree = ast.parse((Path(__file__).resolve().parents[1] / "bench.py").read_text())
    keep = [
        node for node in tree.body
        if (isinstance(node, ast.Assign) and node.targets[0].id in ("BG_SPHERE", "HINGE", "CONTACT"))
        or (isinstance(node, ast.FunctionDef) and node.name in ("_hinge_centers", "_contact_centers", "_quality_frame"))
    ]
    ns = {"np": np, "synthetic": jsynthetic}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "bench.py", "exec"), ns)
    return ns["_quality_frame"]


def test_hinge_frames_are_bench_hinge_scene(depths):
    """The port's frames equal bench.py's hinge scene rendered by the JAX
    package, but where the plane's whole-millimetre depths truncate on a
    last bit of the float64 render (at most 1 mm; ROADMAP Queue 3)."""
    frame = _bench_quality_frame()
    for t, d in enumerate(depths):
        ref = frame(JC, t, "hinge").astype(np.int64)
        got = d.astype(np.int64)
        np.testing.assert_array_equal(got > 0, ref > 0)
        assert np.abs(got - ref).max() <= 1
        sphere = (ref > 0) & (ref < 1250)
        assert sphere.mean() > 0.1
        np.testing.assert_array_equal(got[sphere], ref[sphere])
    # the scene moves: the spheres scissor
    assert (depths[0] != depths[-1]).mean() > 0.01


def test_tangent_basis_matches_jax():
    rng = np.random.RandomState(0)
    n = rng.randn(500, 3)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    special = np.array([
        [0.0, 0.0, 0.0],           # a NaN-zeroed normal: zero tangents
        [1.0, 1.0, 1.0] / np.sqrt(3.0),  # a three-way tie: the first axis
        [0.0, 0.0, 1.0],           # a tie of x and y
        [0.0, -1.0, 0.0],          # a tie of x and z
        [0.6, 0.0, -0.8],          # y alone smallest
        [0.5, 0.5, -np.sqrt(0.5)],  # a tie of x and y, not at zero
    ])
    n = np.concatenate([n, special]).astype(np.float32)
    jt1, jt2 = js.tangent_basis(jnp.asarray(n))
    tt1, tt2 = ts.tangent_basis(torch.from_numpy(n))
    np.testing.assert_allclose(tt1.numpy(), np.asarray(jt1), atol=TOL_BASIS, rtol=0)
    np.testing.assert_allclose(tt2.numpy(), np.asarray(jt2), atol=TOL_BASIS, rtol=0)
    assert not tt1[-6].any() and not tt2[-6].any()
    # an orthonormal frame of every nonzero normal
    t1, t2, nn = tt1.numpy()[:-6], tt2.numpy()[:-6], n[:-6]
    for a, b in ((t1, nn), (t2, nn), (t1, t2)):
        assert np.abs((a * b).sum(-1)).max() < 1e-6
    assert np.abs(np.linalg.norm(t1, axis=-1) - 1.0).max() < 1e-6


@pytest.fixture(scope="module")
def solve_case(jax_frames, depths):
    """(JAX field, port field, point sets as numpy): JAX's field after frame
    1 and frame 2's solve point sets as the port tracks them from JAX's
    state."""
    st = interop.state_from_numpy(jax_frames[1][0], "cpu")
    tr = tkinfu.track(TC, st, torch.from_numpy(depths[2]))
    assert bool(tr.icp_res.ok)
    arrs = [a.numpy().copy() for a in tr.inputs[:4]]
    jfield = jw.WarpField(*(jnp.asarray(a) for a in jax_frames[1][0].warp))
    return jfield, st.warp, arrs


@pytest.fixture(scope="module")
def terms(solve_case):
    """(JAX structure, port structure on JAX's neighbour lists, fields),
    with a seeded per-point gate (NaN and out-of-range entries included)."""
    jfield, tfield, arrs = solve_case
    rng = np.random.RandomState(3)
    gate = rng.uniform(-0.2, 1.2, (arrs[0].shape[0], 1)).astype(np.float32)
    gate[::29] = np.nan
    s = js.prepare(JC, jfield, js.WarpSolveInputs(*(jnp.asarray(a) for a in arrs), p2p_gate=jnp.asarray(gate)), True)
    t = ts.prepare(TC, tfield, ts.WarpSolveInputs(*(_t(a) for a in arrs), p2p_gate=_t(gate)))
    same = (np.asarray(s.knn_idx) == t.knn_idx.numpy()).all(1)
    assert (~same).mean() <= 1e-3  # KNN near ties (ROADMAP Queue 3)
    np.testing.assert_allclose(t.p2p_sw.numpy(), np.asarray(s.p2p_sw), rtol=1e-6, atol=0)
    idx = _t(s.knn_idx).long()
    n = tfield.positions.shape[0]
    t = t._replace(knn_idx=idx, w_knn=_t(s.w_knn), valid=_t(s.valid), pts_by_node=ts.node_lists(idx, n))
    return s, t, jfield, tfield


@pytest.fixture(scope="module")
def jax_terms(terms):
    """JAX's residuals, Jacobian and cost of the data term on ``terms``
    (op by op), computed once for the tests that hold the port's against
    them."""
    s, _, jfield, _ = terms
    return js.data_residual_and_jac(JC, s, jfield.dq, True)


def test_tangential_residuals_and_jacobians_match_jax(terms, jax_terms):
    s, t, jfield, tfield = terms
    r, jac, cost = jax_terms
    tr, tjac, tcost = ts.data_residual_and_jac(TC, t, tfield.dq)
    assert tr.shape == r.shape == (t.p_can.shape[0], 3) and tjac.shape == jac.shape
    assert float(np.abs(np.asarray(r)[:, 1:]).max()) > 0.0  # the tangential rows are on
    assert _rel(tr.numpy(), r) <= TOL_TERMS
    assert _rel(tjac.numpy(), jac) <= TOL_TERMS
    assert abs(float(tcost) - float(cost)) <= TOL_TERMS * float(cost)


def test_tangential_system_matches_jax(terms, jax_terms):
    s, t, jfield, tfield = terms
    n = tfield.positions.shape[0]
    r, jac, _ = jax_terms
    dt = ts.data_term(TC, t, tfield.dq, system=True)
    assert _rel(dt.jtr.numpy(), js.data_jtr(s, jac, r, n)) <= TOL_SYSTEM
    hi = jax.lax.Precision.HIGHEST
    h_p = jnp.einsum("prkd,prke->pkde", jac, jac, precision=hi)
    blocks = jnp.einsum("pkn,pkde->nde", jax.nn.one_hot(s.knn_idx, n, dtype=jnp.float32), h_p, precision=hi)
    assert _rel(dt.blocks.numpy(), blocks) <= TOL_SYSTEM
    # the lagged-JᵀJ evaluation: JAX's one vjp pass
    jg, jcost = js.data_grad_cost(JC, s, jfield.dq, n, True)
    ev = ts.data_term(TC, t, tfield.dq, system=False)
    assert _rel(ev.jtr.numpy(), jg) <= TOL_SYSTEM and _rel(ev.cost.numpy(), jcost) <= TOL_TERMS


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns as integers ordered like their values."""
    b = bits.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b & 0x7FFF)


def test_tangential_bf16_rows_within_one_ulp_of_jax(terms, jax_terms):
    s, t, jfield, tfield = terms
    _, jac, _ = jax_terms
    ref = np.asarray(jac.astype(jnp.bfloat16)).view(np.uint16)
    rows = ts.data_term(TC, t, tfield.dq, system=True).rows
    assert rows.dtype == torch.bfloat16 and rows.shape == jac.shape
    got = rows.view(torch.int16).numpy().view(np.uint16)
    assert np.abs(_ordered(got) - _ordered(ref)).max() <= 1


def test_tangential_solve_matches_jax(solve_case):
    jfield, tfield, arrs = solve_case
    ji = js.WarpSolveInputs(*(jnp.asarray(a) for a in arrs))
    ti = ts.WarpSolveInputs(*(_t(a) for a in arrs))
    solve = jax.jit(lambda f, i: js.solve(JC, f, i))
    _, jst = solve(jfield, ji)
    rng = np.random.RandomState(5)
    costs = []
    for _ in range(3):
        pert = ji._replace(p_live=ji.p_live * (1.0 + jnp.asarray(rng.randn(*arrs[2].shape).astype(np.float32)) * 1e-7))
        costs.append(float(solve(jfield, pert)[1].final_cost))
    _, tst = ts.solve(TC, tfield, ti)
    c0, c1 = float(jst.initial_cost), float(jst.final_cost)
    assert abs(float(tst.initial_cost) - c0) <= 1e-5 * c0
    assert float(tst.final_cost) <= float(tst.initial_cost)
    spread_c = max(abs(c - c1) for c in costs)
    assert abs(float(tst.final_cost) - c1) <= SPREAD * spread_c + 1e-3 * c1


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_step_from_jax_state_matches(jax_frames, depths, frame):
    cases.check_step_from_jax_state(JC, TC, jax_frames, depths, frame)


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_free_running_matches_jax(jax_frames, port_frames, spread, frame):
    cases.check_free_running(jax_frames, port_frames, frame, spread)


@pytest.mark.parametrize("option,value", [
    ("solver_p2p_hessian_stride", 2), ("solver_p2p_lag_hessian", True),
])
def test_unported_tangential_options_raise(solve_case, option, value):
    """The two row-matrix variants (off in every preset), once refused,
    now solve as the JAX package does: the tangential rows of every 2nd
    point scaled by sqrt(2) in the PCG matrix, or the plane rows only; the
    solve held as test_tangential_solve_matches_jax holds the preset's
    (tests/test_torch_row_modes.py holds the rows and the matvec)."""
    jfield, tfield, arrs = solve_case
    jc, tc = (dataclasses.replace(c, **{option: value}) for c in (JC, TC))
    ji = js.WarpSolveInputs(*(jnp.asarray(a) for a in arrs))
    solve = jax.jit(lambda f, i: js.solve(jc, f, i))
    _, jst = solve(jfield, ji)
    rng = np.random.RandomState(5)
    costs = []
    for _ in range(3):
        pert = ji._replace(p_live=ji.p_live * (1.0 + jnp.asarray(rng.randn(*arrs[2].shape).astype(np.float32)) * 1e-7))
        costs.append(float(solve(jfield, pert)[1].final_cost))
    tf, tst = ts.solve(tc, tfield, ts.WarpSolveInputs(*(_t(a) for a in arrs)))
    c0, c1 = float(jst.initial_cost), float(jst.final_cost)
    assert abs(float(tst.initial_cost) - c0) <= 1e-5 * c0
    assert float(tst.final_cost) <= float(tst.initial_cost)
    spread_c = max(abs(c - c1) for c in costs)
    assert abs(float(tst.final_cost) - c1) <= SPREAD * spread_c + 1e-3 * c1
    print(f"{option}={value}: accepted steps JAX {int(jst.accepted_steps)}, port {int(tst.accepted_steps)}; "
          f"final cost JAX {c1:.6e}, port {float(tst.final_cost):.6e}, JAX's spread {spread_c:.3e}")
    # with the term off the options change nothing, as in the JAX package
    ts._check_cfg(dataclasses.replace(tc, solver_p2p_weight=0.0))


def test_quality_preset_is_the_preset_with_the_tangential_term():
    from dynamicfusion_tpu.config import DynamicFusionConfig as J

    t = TC.quality_dynamicfusion()
    assert dataclasses.astuple(t) == dataclasses.astuple(J.quality_dynamicfusion())
    assert t.solver_p2p_weight == P2P and not t.solver_p2p_adaptive and t.solver_p2p_hessian_stride == 1
    ts._check_cfg(t)
