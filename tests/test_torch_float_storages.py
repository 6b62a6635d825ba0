"""The volume's float storages through the slice against the JAX package,
on the CPU (``tests/test_torch_volume_storage.py`` holds f32/f32 brick
fusion, the storages' acceptance on CUDA and the bf16 interop): bf16 tsdf
with f32 weight, frame 0 and the port's step from JAX's state, the tsdf
within one bf16 ulp on all but ``TOL_LSB_FRAC`` of voxels
(``cases.check_volume``); and f32/f32 with ``integrate_mode="dense"`` (F1
in frame 0, F2 in the step), the step from JAX's state at the f32
tolerances. ``small()`` with the dynamicfusion preset's settings
(torch_nonrigid_cases); the JAX package calls bf16 known-bad for
quality, so nothing here holds tracking against a threshold of its own.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu

BF16 = dict(tsdf_dtype="bf16", weight_dtype="f32")
DENSE_F32 = dict(tsdf_dtype="f32", weight_dtype="f32", integrate_mode="dense")
JC_BF16, TC_BF16 = (dataclasses.replace(c, **BF16) for c in cases.configs())
JC_DENSE, TC_DENSE = (dataclasses.replace(c, **DENSE_F32) for c in cases.configs())


@pytest.fixture(scope="module")
def depths():
    return cases.bench_depths(JC_BF16, 2)


@pytest.fixture(scope="module")
def bf16_frames(depths):
    return cases.jax_run(JC_BF16, depths)


def test_bf16_frame0_matches_jax(bf16_frames, depths):
    """bf16 tsdf, f32 weight: frame 0's volume within one bf16 ulp on all
    but TOL_LSB_FRAC of voxels (``cases.check_volume``), the same nodes."""
    ts = tkinfu.first_frame(TC_BF16, tkinfu.init_state(TC_BF16, "cpu"), torch.from_numpy(depths[0]))
    assert ts.vol.tsdf.dtype == torch.bfloat16 and ts.vol.weight.dtype == torch.float32
    j = bf16_frames[0][0]
    assert np.asarray(j.vol.tsdf).dtype.itemsize == 2
    cases.check_volume(j.vol, ts.vol)
    np.testing.assert_array_equal(ts.warp.active.numpy(), np.asarray(j.warp.active))


def test_bf16_step_from_jax_state_matches(bf16_frames, depths):
    cases.check_step_from_jax_state(JC_BF16, TC_BF16, bf16_frames, depths, 1)


def test_f32_dense_step_from_jax_state_matches(depths):
    """f32/f32 with dense fusion (F1 in frame 0, F2 in the step): the step
    from JAX's frame-0 state."""
    frames = cases.jax_run(JC_DENSE, depths)
    assert np.asarray(frames[0][0].vol.tsdf).dtype == np.float32
    cases.check_step_from_jax_state(JC_DENSE, TC_DENSE, frames, depths, 1)
