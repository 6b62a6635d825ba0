"""The tangential rows' row modes of the factored PCG matrix against the
JAX package, on the CPU: ``solver_p2p_hessian_stride`` (the plane row of
every point and the tangential rows of every s-th point, scaled by sqrt(s)
before the bf16 rounding) and ``solver_p2p_lag_hessian`` (the plane rows
only), on ``tests/torch_nonrigid_cases.py``'s sphere solve with the
quality preset's tangential weight.

Tolerances, each with its reason:
- the strided bf16 rows from JAX's float32 Jacobian equal JAX's row
  matrix bit for bit (one rounding of the same product); from the port's
  own Jacobian within one bf16 step of each entry (2^-7 of it: its last
  float32 bits may flip a rounding) plus TOL_JAC of the largest entry (the two
  Jacobians' own float32 difference, which tiny entries cancel into);
- the matvec within TOL_MATVEC of JAX's two bf16 matmuls over the row
  matrix (the same rows; a rounding of t to bf16 may flip with the sum
  order, 2^-8 of one entry);
- ``solver_p2p_weight=0`` leaves every mode off. The solves with the
  modes are held in test_torch_quality_slice.py (every 2nd point, the
  plane rows only) and test_torch_options_slice.py (every 4th point, in
  the pipeline).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)
from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.solvers import warp_solver as ts

TOL_MATVEC = 1e-3
TOL_JAC = 1e-6

N = 128
P = 2400
TANGENTIAL = dict(max_nodes=N, solver_linear="pcg", solver_linear_iters=12, solver_p2p_weight=0.25)
JC = dataclasses.replace(JCfg.small(), **TANGENTIAL)
TC = dataclasses.replace(TCfg.small(), **TANGENTIAL)
MODES = {"stride2": dict(solver_p2p_hessian_stride=2), "stride4": dict(solver_p2p_hessian_stride=4),
         "lag": dict(solver_p2p_lag_hessian=True)}

j_data = jax.jit(js.data_residual_and_jac, static_argnums=(0, 3))


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(rows: torch.Tensor) -> np.ndarray:
    return rows.view(torch.int16).numpy().view(np.uint16)


@pytest.fixture(scope="module")
def terms():
    """(JAX structure, port structure on JAX's neighbour lists, JAX field,
    port field, JAX's weighted Jacobian, the sphere's problem)."""
    prob = cases.sphere_problem(1, N, P)
    jfield, tfield, ji, ti = prob
    s = js.prepare(JC, jfield, ji, True)
    t = ts.prepare(TC, tfield, ti)
    idx = _t(s.knn_idx).long()
    t = t._replace(knn_idx=idx, w_knn=_t(s.w_knn), valid=_t(s.valid), pts_by_node=ts.node_lists(idx, N))
    _, jac, _ = j_data(JC, s, jfield.dq, True)
    return s, t, jfield, tfield, np.asarray(jac), prob


def test_row_modes_follow_the_options():
    assert ts.row_mode(TC) == (None, 1) or ts.row_mode(TC) == (3, 1)
    for name, changes in MODES.items():
        used, stride = ts.row_mode(dataclasses.replace(TC, **changes))
        assert (used, stride) == ((1, 1) if name == "lag" else (3, int(name[-1])))
    # the lag mode wins over a stride, as in the JAX package; without the
    # tangential term nothing changes
    assert ts.row_mode(dataclasses.replace(TC, solver_p2p_lag_hessian=True, solver_p2p_hessian_stride=4)) == (1, 1)
    assert ts.row_mode(dataclasses.replace(TC, solver_p2p_weight=0.0, solver_p2p_hessian_stride=4)) == (None, 1)
    with pytest.raises(ValueError, match="solver_p2p_hessian_stride"):
        ts._check_cfg(dataclasses.replace(TC, solver_p2p_hessian_stride=0))


@pytest.mark.parametrize("stride", [2, 4])
def test_strided_rows_match_jax(terms, stride):
    """The rows of the strided PCG matrix: the plane rows of every point,
    the tangential rows of the points p % s == 0 as bf16(sqrt(s) jac)."""
    s, t, _, tfield, jac, _ = terms
    rows_p = np.asarray(jnp.asarray(jac[:, :1]).astype(jnp.bfloat16))
    rows_t = np.asarray((jnp.asarray(jac[::stride, 1:]) * math.sqrt(stride)).astype(jnp.bfloat16))
    # from JAX's Jacobian: bit-equal
    got = ts.bf16_rows(_t(jac), stride)
    np.testing.assert_array_equal(_bits(got[:, :1].contiguous()), rows_p.view(np.uint16))
    np.testing.assert_array_equal(_bits(got[::stride, 1:].contiguous()), rows_t.view(np.uint16))
    # from the port's own Jacobian (kernel F's plain version): one bf16
    # step of each entry, beside the float32 Jacobians' own difference
    # (TOL_JAC of the largest entry: tiny entries cancel)
    cfg = dataclasses.replace(TC, solver_p2p_hessian_stride=stride)
    rows = ts.data_term(cfg, t, tfield.dq, True, row_stride=stride).rows.float().numpy()
    for got, ref in ((rows[::stride, 1:], rows_t), (rows[:, :1], rows_p)):
        ref = ref.astype(np.float32)
        assert (np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + TOL_JAC * np.abs(jac).max()).all()
    # the scale is taken before the rounding, not after it (the two agree
    # where sqrt(s) is a power of two, s = 4)
    late = (jnp.asarray(jac[::stride, 1:]).astype(jnp.bfloat16).astype(jnp.float32) * math.sqrt(stride))
    assert (np.asarray(late) != rows_t.astype(np.float32)).any() == (stride == 2)


def _jax_matvec(s, jac, mode, p):
    """The data part of the JAX package's factored matvec (solve's mv):
    the row matrix of the mode, D-major columns, two bf16 matmuls with
    float32 sums."""
    oh16 = jax.nn.one_hot(s.knn_idx, N, dtype=jnp.bfloat16)
    jac = jnp.asarray(jac)
    if mode == "lag":
        rows = jnp.einsum("prkd,pkn->prdn", jac[:, :1].astype(jnp.bfloat16), oh16).reshape(-1, 6 * N)
    else:
        st = int(mode[-1])
        rows_p = jnp.einsum("prkd,pkn->prdn", jac[:, :1].astype(jnp.bfloat16), oh16).reshape(-1, 6 * N)
        rows_t = jnp.einsum("prkd,pkn->prdn", (jac[::st, 1:] * math.sqrt(st)).astype(jnp.bfloat16),
                            oh16[::st]).reshape(-1, 6 * N)
        rows = jnp.concatenate([rows_p, rows_t], axis=0)
    pd = jnp.asarray(p).reshape(N, 6).T.reshape(-1)
    tt = jnp.dot(rows, pd.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    apd = jnp.dot(tt.astype(jnp.bfloat16), rows, preferred_element_type=jnp.float32)
    return np.asarray(apd.reshape(6, N).T.reshape(-1))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_matvec_matches_jax(terms, mode):
    """The port's matvec over the rows of the mode (no edge blocks, no
    damping) against the JAX package's row matrix of the same rows."""
    s, t, _, _, jac, _ = terms
    used, stride = ts.row_mode(dataclasses.replace(TC, **MODES[mode]))
    zeros = torch.zeros((t.e_src.shape[0], 6, 6))
    edge = ts.EdgeTerm(torch.zeros(6 * N), torch.zeros(()), zeros, zeros, zeros, torch.zeros((N, 6, 6)))
    sysm = ts.System(ts.bf16_rows(_t(jac), stride), edge, torch.zeros(6 * N), used, stride)
    p = np.random.RandomState(3).randn(6 * N).astype(np.float32)
    ref = _jax_matvec(s, jac, mode, p)
    got = ts.matvec(t, sysm, _t(p)).numpy()
    assert np.abs(got - ref).max() <= TOL_MATVEC * np.abs(ref).max()
    # the mode leaves rows out: the three-row matvec differs
    full = ts.matvec(t, sysm._replace(used=None, stride=1), _t(p)).numpy()
    assert np.abs(full - ref).max() > TOL_MATVEC * np.abs(ref).max()
