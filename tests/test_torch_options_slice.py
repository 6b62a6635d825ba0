"""The solver and warp-field options together against the JAX package, on
the CPU: ``small()`` with the slice's settings (tests/torch_nonrigid_cases.py)
and the options of chip_smoke.py's options cell, ``quality_dynamicfusion()``'s
tangential term with the aperture gate (``solver_p2p_adaptive``), the
tangential rows of every 4th point in the PCG matrix
(``solver_p2p_hessian_stride=4``), the adaptive node radius
(``node_radius_adaptive``) and half the net rigid motion removed a frame
(``solver_remove_net_rigid``, ``solver_net_rigid_alpha=0.5``), over
bench.py's hinge scene.

Held as tests/test_torch_adaptive_gate.py holds the gate's slice: the
port's step from JAX's state (pose TOL_POSE, initial cost
TOL_COST0_OPTIONS relative, below; then JAX's fusion, node insertion with
its radii, and maps), and
the free-running pose within max(1e-3, 2 x JAX's own spread) with equal
node counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)
from dynamicfusion_tpu_torch.io import synthetic as tsynthetic
from dynamicfusion_tpu_torch.models import warpfield as tw
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu

OPTIONS = dict(solver_p2p_weight=0.25, solver_p2p_adaptive=True, solver_p2p_hessian_stride=4,
               node_radius_adaptive=True, solver_remove_net_rigid=True, solver_net_rigid_alpha=0.5)
JC, TC = (dataclasses.replace(c, **OPTIONS) for c in cases.configs())
STEPS = 3
# the port's step from JAX's state: the gate keeps the hinge's cost small
# (~5e-3), so the pre-aligned pose's last bits move its initial value by
# ~5e-5 relative for each 1e-7 m (tests/test_torch_adaptive_gate.py, whose
# poses part by ~1e-7 m: its TOL_COST0_HINGE is 1e-4); here the second
# step's pose parts by 3.5e-7 m and its cost by 1.9e-4
TOL_COST0_OPTIONS = 5e-4


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


def test_frame0_adaptive_radii_match_jax(jax_frames, port_frames):
    """Frame 0's nodes take radii from their density: on JAX's nodes the
    port's radii are JAX's bit for bit (its pipeline's fused graph takes
    the expansion's dot as fused multiply-adds, as the port does); the
    port's own nodes sit within the extraction's last bits of JAX's
    (tests/test_torch_tsdf_bricks.py), and a radius, a distance between
    two nodes, moves by at most twice that."""
    jw_, tw_ = jax_frames[0][0].warp, port_frames[0][0]["warp"]
    act = np.asarray(jw_.active)
    np.testing.assert_array_equal(tw_["active"], act)
    jr, jpos = np.asarray(jw_.radius), torch.from_numpy(np.array(jw_.positions))
    on_jax = torch.where(torch.from_numpy(act), tw.adaptive_radius(TC, jpos, jpos, torch.from_numpy(act), True),
                         TC.node_radius)
    np.testing.assert_array_equal(on_jax.numpy(), jr)
    moved = np.abs(tw_["positions"] - jpos.numpy()).max() * np.sqrt(3.0)
    np.testing.assert_allclose(tw_["radius"], jr, rtol=0, atol=2.0 * moved + 1e-7)
    assert len(np.unique(jr[act])) > act.sum() // 4 and (jr[act] != TC.node_radius).any()


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_options_step_from_jax_state_matches(jax_frames, depths, frame):
    cases.check_step_from_jax_state(JC, TC, jax_frames, depths, frame, tol_cost0=TOL_COST0_OPTIONS)


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_options_free_running_matches_jax(jax_frames, port_frames, spread, frame):
    cases.check_free_running(jax_frames, port_frames, frame, spread)


def test_options_run_through_the_step(depths):
    """Each option acts in the port's step: the net rigid removal changes
    the solved field, and with the stride the solve takes other steps
    than with every tangential row in the matrix."""
    st = tkinfu.first_frame(TC, tkinfu.init_state(TC, "cpu"), torch.from_numpy(depths[0]))
    d1 = torch.from_numpy(depths[1])
    with_all, _ = tkinfu.step(TC, st, d1)
    no_removal, _ = tkinfu.step(dataclasses.replace(TC, solver_remove_net_rigid=False), st, d1)
    all_rows, _ = tkinfu.step(dataclasses.replace(TC, solver_p2p_hessian_stride=1), st, d1)
    act = st.warp.active
    assert float((with_all.warp.dq - no_removal.warp.dq)[act].abs().max()) > 0.0
    assert float((with_all.warp.dq - all_rows.warp.dq)[act].abs().max()) > 0.0
