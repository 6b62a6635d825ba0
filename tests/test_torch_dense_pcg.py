"""The port's dense-matrix PCG (kernel P's plain version, the linear solve
of ``solver_linear="pcg"`` with ``solver_lagged_jtj=False``) against the
JAX package's ``_pcg_solve``, on the CPU, on the damped dense system of
``tests/torch_nonrigid_cases.py``'s sphere solve (128 nodes, 6N = 768).

Tolerances, each with its reason:
- the block-Jacobi preconditioner (``spd6_inv`` of the diagonal blocks)
  within TOL_PRECOND of JAX's ``_block_diag_inv``, relative to its
  largest entry (two closed forms of the same Schur complements whose
  float32 roundings differ in order), or within twice JAX's own distance
  from the float64 inverse where the blocks are ill conditioned (the
  first lambda: the closed form amplifies the roundings);
- the solution within SPREAD times JAX's own spread when every entry of
  the matrix moves by one ulp, never held tighter than TOL_X: the
  damped system at the solve's first lambda (1e-4) is ill conditioned,
  and a rejected step's lambda (8.0) is not;
- the iteration count where the test rᵀr <= rtol² bᵀb stops the loop is
  the JAX package's.
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
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.solvers import warp_solver as ts

TOL_PRECOND = 1e-4
TOL_X = 1e-4
SPREAD = 4.0

N = 128
P = 2400
# the base config with the PCG over its dense matrix
DENSE_PCG = dict(max_nodes=N, solver_linear="pcg", solver_lagged_jtj=False)
JC = dataclasses.replace(JCfg.small(), **DENSE_PCG)
TC = dataclasses.replace(TCfg.small(), **DENSE_PCG)

j_system = jax.jit(js.gn_system_dense, static_argnums=(0, 3, 4))
j_pcg_solve = jax.jit(js._pcg_solve, static_argnums=(2, 3, 4))
j_block_diag_inv = jax.jit(js._block_diag_inv, static_argnums=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jax_damped(jtj, lm_lambda, active, floor):
    """The JAX package's _damped_system (solve's closure)."""
    active_dof = jnp.repeat(active, 6)
    diag = jnp.diagonal(jtj)
    mean_diag = jnp.sum(jnp.where(active_dof, diag, 0.0)) / jnp.maximum(jnp.sum(active_dof.astype(jnp.float32)), 1.0)
    diag_eff = jnp.maximum(diag, floor * mean_diag)
    return jtj + jnp.diag(lm_lambda * diag_eff) + jnp.diag(jnp.where(active_dof & (diag > 1e-12), 1e-8, 1.0))


@pytest.fixture(scope="module")
def system():
    jfield, _, ji, _ = cases.sphere_problem(0, N, P)
    s = js.prepare(JC, jfield, ji, True)
    jtj, jtr, _ = j_system(JC, s, jfield.dq, N, True)
    return jfield.active, jtj, jtr


def _iterations(a, minv, b, iters, rtol):
    """The iterations the loop runs before rᵀr <= rtol² bᵀb (float64 of
    the float32 plain PCG's residuals)."""
    x = torch.zeros_like(b)
    r, z = b, ts._apply_m(minv, b)
    p, rz = z, torch.dot(b, z)
    stop2 = rtol * rtol * float(torch.dot(b, b))
    for it in range(iters):
        if not float(torch.dot(r, r)) > stop2:
            return it
        ap = a @ p
        alpha = rz / torch.clamp(torch.dot(p, ap), min=1e-30)
        x, r = x + alpha * p, r - alpha * ap
        z = ts._apply_m(minv, r)
        rz_n = torch.dot(r, z)
        p = z + rz_n / torch.clamp(rz, min=1e-30) * p
        rz = rz_n
    return iters


@pytest.mark.parametrize("lm_lambda", [1e-4, 8.0])
def test_dense_pcg_matches_jax(system, lm_lambda):
    active, jtj, jtr = system
    iters, rtol = TC.solver_linear_iters, TC.solver_linear_tol
    damped = _jax_damped(jtj, jnp.float32(lm_lambda), active, JC.solver_damping_floor)
    a, b = _t(damped), _t(jtr)
    minv = ts.spd6_inv(ts.diag_blocks(a))
    jminv = np.asarray(j_block_diag_inv(damped, N))
    exact = np.linalg.inv(ts.diag_blocks(a).double().numpy())
    assert _rel(minv.numpy(), jminv) <= max(TOL_PRECOND, 2.0 * _rel(jminv, exact))
    on = torch.ones((), dtype=torch.bool)
    got = ts.dense_pcg(a, b, iters, rtol, on).numpy()
    ref = np.asarray(j_pcg_solve(damped, jtr, N, iters, rtol))
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    spread = 0.0
    for toward in (np.inf, -np.inf):
        moved = jnp.asarray(np.nextafter(np.asarray(damped), np.float32(toward)))
        spread = max(spread, _rel(j_pcg_solve(moved, jtr, N, iters, rtol), ref))
    err = _rel(got, ref)
    print(f"lambda {lm_lambda}: port vs JAX {err:.3e}, JAX's one-ulp spread {spread:.3e}, "
          f"{_iterations(a, minv, b, iters, rtol)} of {iters} iterations")
    assert err <= max(TOL_X, SPREAD * spread)
    assert not ts.dense_pcg(a, b, iters, rtol, ~on).any()


def test_dense_pcg_stops_as_jax(system):
    """A loose rtol ends the loop after a few iterations, as JAX's
    while_loop does: both packages' solutions of the same system agree."""
    active, jtj, jtr = system
    damped = _jax_damped(jtj, jnp.float32(8.0), active, JC.solver_damping_floor)
    a, b = _t(damped), _t(jtr)
    minv = ts.spd6_inv(ts.diag_blocks(a))
    rtol = 0.3
    ran = _iterations(a, minv, b, 32, rtol)
    assert 0 < ran < 32
    got = ts.dense_pcg(a, b, 32, rtol, torch.ones((), dtype=torch.bool)).numpy()
    ref = np.asarray(j_pcg_solve(damped, jtr, N, 32, rtol))
    assert _rel(got, ref) <= TOL_X
    # the same as stopping the loop after ``ran`` iterations
    np.testing.assert_array_equal(got, ts.dense_pcg(a, b, ran, 0.0, torch.ones((), dtype=torch.bool)).numpy())
