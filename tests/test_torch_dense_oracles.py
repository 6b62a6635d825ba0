"""The port's direct (dense/Cholesky) warp solve against the JAX package
on the solver oracle's scenes (tests/test_warp_solver.py's rigid shift,
non-rigid multiple nodes and known rigid offset), on the CPU; the rest of
the dense solve is held in tests/test_torch_dense_solver.py, whose
tolerances these take (TOL_ORACLE_COST0: the Tukey rho cancels at the
oracle's residuals). A file of its own, so that ``--dist loadfile``
spreads the dense solve's JAX compiles over the workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import se3 as jse3
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.models import warpfield as tw
from dynamicfusion_tpu_torch.solvers import warp_solver as ts
from test_torch_dense_solver import TOL_ORACLE_COST0, _t


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
    jfield = jax.jit(lambda p, v: jw.init_from_cloud(jc, p, v))(jnp.asarray(CUBE), jnp.ones(8, bool))
    tfield = tw.WarpField(*(_t(a) for a in jfield))
    nrm = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), can.shape).copy()
    arrs = (can, nrm, live, nrm)
    jf, jst = jax.jit(lambda f, i: js.solve(jc, f, i, point_to_plane=False))(
        jfield, js.WarpSolveInputs(*(jnp.asarray(a) for a in arrs)))
    tf, tst = ts.solve(tc, tfield, ts.WarpSolveInputs(*(_t(a) for a in arrs)))
    jwarped = np.asarray(jax.jit(jw.warp_points)(jf, jnp.asarray(can)))
    twarped = tw.warp_points(tf, _t(can), k=8).numpy()
    np.testing.assert_allclose(twarped, live, atol=tol)
    np.testing.assert_allclose(twarped, jwarped, atol=tol)
    assert abs(float(tst.initial_cost) - float(jst.initial_cost)) <= TOL_ORACLE_COST0 * float(jst.initial_cost)
    assert float(tst.final_cost) < float(tst.initial_cost)
