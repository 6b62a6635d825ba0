"""The distributed Gauss-Newton solve against the JAX package's
single-device solve, on the CPU: 8 CPU shards, the direct solve's summed
Schur assembly and the distributed PCG (each shard's rows unsummed, every
matvec a psum), on tests/test_torch_parallel.py's 48-point problem and with
its tolerances (the solved dual quaternions within TOL_DQ, the final cost
within TOL_COST_RTOL, TOL_COST_ATOL). A file of its own, so that ``--dist
loadfile`` spreads the JAX compiles over the workers.
"""

import dataclasses

import numpy as np
import pytest

from dynamicfusion_tpu_torch.parallel import distributed_gn
from test_torch_parallel import (GN, TOL_COST_ATOL, TOL_COST_RTOL, TOL_DQ, _gn_problem, _jax_solve, cpu_mesh,
                                 one_torch_thread, tcfg)  # noqa: F401  (one_torch_thread: autouse)


@pytest.mark.parametrize("linear", ["direct", "pcg"])
def test_solve_distributed_matches_single_device(linear):
    jc = dataclasses.replace(GN, solver_linear=linear)
    tc = tcfg(jc)
    _, tfield, _, ti = _gn_problem(48, (0.03, -0.02, 0.04))
    dq_ref, cost_ref = _jax_solve(linear)
    f, st = distributed_gn.solve_distributed(tc, cpu_mesh(8), tfield, ti)
    np.testing.assert_allclose(f.dq.numpy(), dq_ref, atol=TOL_DQ)
    np.testing.assert_allclose(float(st.final_cost), cost_ref, rtol=TOL_COST_RTOL, atol=TOL_COST_ATOL)


def test_sharded_pcg_solve_matches_single_device():
    """The distributed PCG (each shard's rows unsummed, every matvec a
    psum) against JAX's single-device factored PCG solve."""
    tc = tcfg(dataclasses.replace(GN, solver_linear="pcg"))
    _, tfield, _, ti = _gn_problem(48, (0.03, -0.02, 0.04))
    dq_ref, cost_ref = _jax_solve("pcg")
    f, st = distributed_gn.make_sharded_solve(tc, cpu_mesh(8))(tfield, ti)
    np.testing.assert_allclose(f.dq.numpy(), dq_ref, atol=TOL_DQ)
    np.testing.assert_allclose(float(st.final_cost), cost_ref, rtol=TOL_COST_RTOL, atol=TOL_COST_ATOL)
    assert float(st.final_cost) < float(st.initial_cost)
