"""The dense non-rigid step with the newton16 refine against the JAX
package, on the CPU: tests/test_torch_dense_slice.py's non-rigid half
(its set-up, tolerances and volume check), in a file of its own so that
``--dist loadfile`` spreads the JAX compiles over the workers. Frame 0's
volume, and the step from JAX's state after it (the solve's initial cost
within 1e-5 relative, ROADMAP Queue 3's rule; the fusion, insertion and
maps at JAX's pose and field).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu
from test_torch_dense_slice import NONRIGID, _check_volume


@pytest.fixture(scope="module")
def nonrigid_run():
    jc, tc = (dataclasses.replace(c, **NONRIGID) for c in cases.configs())
    depths = cases.bench_depths(tc, 2)
    return jc, tc, depths, cases.jax_run(jc, depths)


def test_nonrigid_first_frame_matches_jax(nonrigid_run):
    """Frame 0 of the dense non-rigid config: the dense rigid integrate
    (F1), the extraction and node sampling, the newton16 model maps."""
    jc, tc, depths, frames = nonrigid_run
    j = frames[0][0]
    ts = tkinfu.first_frame(tc, tkinfu.init_state(tc, "cpu"), torch.from_numpy(depths[0]))
    _check_volume(j.vol, ts.vol)
    assert int(ts.warp.count) == int(j.warp.count) > 0
    cases.check_maps((j.can_points, *j.prev_points), (ts.can_points, *ts.prev_points))
    cases.check_maps((j.can_normals, *j.prev_normals), (ts.can_normals, *ts.prev_normals), normals=True)


def test_nonrigid_step_from_jax_state(nonrigid_run):
    """The dense non-rigid step from JAX's frame-0 state: pose, the solve's
    initial cost (1e-5 relative), the dense fusion (F2) at JAX's pose and
    field, the node insertion and the newton16 maps."""
    jc, tc, depths, frames = nonrigid_run
    cases.check_step_from_jax_state(jc, tc, frames, depths, 1)
    assert not np.array_equal(np.asarray(frames[1][0].vol.weight), np.asarray(frames[0][0].vol.weight))
