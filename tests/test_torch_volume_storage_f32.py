"""The volume's f32/f32 storage against the JAX package, on the CPU, at
``small()`` with the dynamicfusion preset's settings (torch_nonrigid_cases)
and the existing volume and pose tolerances: frame 0's volume, and the
port's step from JAX's state. tests/test_torch_volume_storage.py's f32
half (its configs), in a file of its own so that ``--dist loadfile``
spreads the JAX compiles over the workers.
"""

import numpy as np
import pytest
import torch
import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu
from test_torch_volume_storage import JC, TC


@pytest.fixture(scope="module")
def depths():
    return cases.bench_depths(JC, 2)


@pytest.fixture(scope="module")
def jax_frames(depths):
    return cases.jax_run(JC, depths)


def test_f32_frame0_matches_jax(jax_frames, depths):
    ts = tkinfu.first_frame(TC, tkinfu.init_state(TC, "cpu"), torch.from_numpy(depths[0]))
    assert ts.vol.tsdf.dtype == ts.vol.weight.dtype == torch.float32
    j = jax_frames[0][0]
    assert np.asarray(j.vol.tsdf).dtype == np.float32
    cases.check_volume(j.vol, ts.vol)
    np.testing.assert_array_equal(ts.warp.active.numpy(), np.asarray(j.warp.active))


def test_f32_step_from_jax_state_matches(jax_frames, depths):
    cases.check_step_from_jax_state(JC, TC, jax_frames, depths, 1)
