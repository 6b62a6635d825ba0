"""The port's non-rigid step against the JAX package on the branches that
start above 8 192 solve points, on the CPU: ``small(dims=64, rows=240,
cols=320)`` gives 160x120 model maps, so P = 19 200 as in the
640x480 preset. The solve then runs on every ``solver_hessian_stride``-th
point, insertion takes every ``node_insert_stride``-th candidate, and the
tracking maps are warped through the coarse field's trilinear blend
(kernel E's trilinear entry) instead of the exact per-point warp.

Held as in tests/test_torch_nonrigid_slice.py (torch_nonrigid_cases):
the port carrying its own state, and the port's step from JAX's state.
"""

import pytest

import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

JC, TC = cases.configs(dims=64, rows=240, cols=320)
STEPS = 2


@pytest.fixture(scope="module")
def depths():
    return cases.bench_depths(JC, STEPS + 1)


@pytest.fixture(scope="module")
def jax_frames(depths):
    return cases.jax_run(JC, depths)


@pytest.fixture(scope="module")
def port_frames(depths):
    return cases.port_run(TC, depths)


@pytest.fixture(scope="module")
def spread(depths, jax_frames):
    return cases.jax_spread(JC, depths, jax_frames)


def test_the_full_scale_branches_are_taken(port_frames):
    maps = port_frames[0][0]["can_points"]
    stride = max(1, TC.solver_point_stride // TC.raycast_subsample)
    assert (maps.shape[0] // stride) * (maps.shape[1] // stride) > 8192
    assert TC.solver_hessian_stride > 1 and TC.node_insert_stride > 1


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_free_running_matches_jax(jax_frames, port_frames, spread, frame):
    cases.check_free_running(jax_frames, port_frames, frame, spread)


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_step_from_jax_state_matches(jax_frames, depths, frame):
    cases.check_step_from_jax_state(JC, TC, jax_frames, depths, frame)
