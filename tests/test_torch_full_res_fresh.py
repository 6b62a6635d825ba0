"""The fresh canonical raycast of ``reuse_model_raycast=False`` against the
JAX package, on the CPU: two non-rigid steps of the slice's ``small()``
settings from JAX's state (pose, initial solve cost and node count within
tests/torch_nonrigid_cases.py's tolerances). A file of its own, so that
``--dist loadfile`` spreads the JAX compiles over the workers.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu

FRESH_J, FRESH_T = (dataclasses.replace(c, reuse_model_raycast=False) for c in cases.configs())


@pytest.fixture(scope="module")
def fresh_frames():
    depths = cases.bench_depths(FRESH_T, 3)
    return depths, cases.jax_run(FRESH_J, depths)


@pytest.mark.parametrize("frame", [1, 2])
def test_fresh_canonical_raycast_step_from_jax_state(fresh_frames, frame):
    """``reuse_model_raycast=False``: the solve's canonical points come from
    a raycast of the previous volume at the ICP pose in the temporal band;
    the port's step from JAX's state gives JAX's pose, initial solve cost
    and node count."""
    depths, frames = fresh_frames
    (j_prev, _), (_, jo) = frames[frame - 1], frames[frame]
    _, to = tkinfu.step(FRESH_T, interop.state_from_numpy(j_prev, "cpu"), torch.from_numpy(depths[frame]))
    assert bool(to.icp_ok) and bool(jo.icp_ok)
    assert np.abs(jo.pose - to.pose.numpy()).max() <= cases.TOL_POSE
    c0 = float(jo.solver_cost0)
    assert abs(float(to.solver_cost0) - c0) <= cases.TOL_COST0 * c0
    assert float(to.solver_cost1) <= float(to.solver_cost0)
    assert int(to.node_count) == int(jo.node_count)
