"""The volume's float storages (``tsdf_dtype="f32"``, ``weight_dtype="f32"``)
against the JAX package, on the CPU, and their refusal on CUDA.

Kernels C, D and L read and write the i16 tsdf and u16 weight codes only,
so ``models/volume.create`` refuses the other storages on a CUDA device
up front, naming the option; the plain path runs them. Held at
``small()`` with the dynamicfusion preset's settings (torch_nonrigid_cases)
at the existing volume and pose tolerances: frame 0's volume, and the
port's step from JAX's state.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.models import volume
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu

F32 = dict(tsdf_dtype="f32", weight_dtype="f32")
JC, TC = (dataclasses.replace(c, **F32) for c in cases.configs())


@pytest.mark.parametrize("option,value", [("tsdf_dtype", "f32"), ("tsdf_dtype", "bf16"), ("weight_dtype", "f32")])
def test_float_storages_are_refused_on_cuda(option, value):
    cfg = dataclasses.replace(TCfg.small(), **{option: value})
    with pytest.raises(NotImplementedError, match=f"{option}={value!r}"):
        volume.check_storage(cfg, torch.device("cuda"))
    volume.check_storage(cfg, torch.device("cpu"))
    volume.check_storage(TCfg.small(), torch.device("cuda"))
    v = volume.create(cfg, "cpu")
    assert v.tsdf.dtype == {"f32": torch.float32, "bf16": torch.bfloat16, "i16": torch.int16}[cfg.tsdf_dtype]


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
