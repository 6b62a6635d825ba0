"""The port's non-rigid step against the JAX package at the full-scale
test size (``small(dims=64, rows=240, cols=320)``: 160x120 model maps,
P = 19 200 solve points, the branches above 8 192 points) under the
dynamicfusion preset's own newton8 refine, on the CPU.
tests/test_torch_nonrigid_full_scale.py holds the same branches with the
secant refine; this file holds newton8 against JAX's own spread there.

Under newton8 the initial solve cost of the port's step from JAX's state
lands just past TOL_COST0 on some steps: ICP's pose differs from JAX's in
its last bits (well inside TOL_POSE), and residuals of a few millimetres
carry that into the cost. JAX itself moves that cost when its frame-0
node positions move by 1e-7 relative (``jax_spread``); the step is held
within max(TOL_COST0, SPREAD x that spread), the pose within TOL_POSE, and
the free-running port within the usual bounds.
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
def spread(depths, jax_frames):
    return cases.jax_spread(JC, depths, jax_frames)


def test_newton8_is_the_refine():
    assert TC.raycast_refine == JC.raycast_refine == "newton8"


@pytest.fixture(scope="module")
def port_frames(depths):
    return cases.port_run(TC, depths)


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_free_running_matches_jax(jax_frames, port_frames, spread, frame):
    cases.check_free_running(jax_frames, port_frames, frame, spread)


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_step_from_jax_state_matches(jax_frames, depths, spread, frame):
    tol = max(cases.TOL_COST0, cases.SPREAD * spread[frame][2])
    got = cases.check_step_from_jax_state(JC, TC, jax_frames, depths, frame, tol_cost0=tol)
    print(f"frame {frame}: initial cost relative to JAX's {got:.3e}; JAX's own spread {spread[frame][2]:.3e}, "
          f"tolerance {tol:.3e}")
