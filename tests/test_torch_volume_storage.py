"""The volume's float storages (``tsdf_dtype`` "f32" or "bf16",
``weight_dtype="f32"``) against the JAX package, on the CPU, and their
acceptance on CUDA.

Kernels C, D, F1, F2, L and R take every (tsdf, weight) storage of the
JAX config (``kernels._check_volume``'s storage codes;
``tests/test_torch_cuda.py`` holds each against its plain version on a
card), so ``models/volume.create`` refuses none. Held at ``small()`` with
the dynamicfusion preset's settings (torch_nonrigid_cases) at the existing
volume and pose tolerances: frame 0's volume, and the port's step from
JAX's state, under f32/f32 (``tests/test_torch_volume_storage_f32.py``, a
file of its own so that ``--dist loadfile`` spreads the JAX compiles over
the workers; bf16/f32 and dense f32/f32 fusion:
``tests/test_torch_float_storages.py``); and a JAX bf16 volume carried
across ``interop`` bit for bit. The checkpoint keeps refusing a bf16 volume: the JAX
package's own ``utils/checkpoint`` does not load one back (numpy writes its
bfloat16 leaves as "V2", which its ``load`` cannot convert).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu_torch import interop, kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.models import volume
from dynamicfusion_tpu_torch.utils import checkpoint as tcheckpoint

F32 = dict(tsdf_dtype="f32", weight_dtype="f32")
BF16 = dict(tsdf_dtype="bf16", weight_dtype="f32")
JC, TC = (dataclasses.replace(c, **F32) for c in cases.configs())
JC_BF16, TC_BF16 = (dataclasses.replace(c, **BF16) for c in cases.configs())
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i16": torch.int16, "u16": torch.uint16}


@pytest.mark.parametrize("option,value", [("tsdf_dtype", "f32"), ("tsdf_dtype", "bf16"), ("weight_dtype", "f32")])
def test_float_storages_are_refused_on_cuda(option, value, monkeypatch):
    """(The name is from when CUDA refused these storages.) Each is now
    accepted on CUDA: ``volume.create`` makes it for a CUDA device (here
    on the meta device, which needs no card), and the kernels' volume
    check gives it its storage code (csrc/common.cuh)."""
    cfg = dataclasses.replace(TCfg.small(), **{option: value})
    asked = []
    monkeypatch.setattr(volume.device_mod, "resolve", lambda d: asked.append(d) or torch.device("meta"))
    v = volume.create(cfg, "cuda")
    assert asked == ["cuda"] and v.tsdf.is_meta
    assert v.tsdf.dtype == DTYPES[cfg.tsdf_dtype] and v.weight.dtype == DTYPES[cfg.weight_dtype]
    code = kernels.storage_code(v.tsdf.dtype, v.weight.dtype)
    assert code == {"i16": 0, "f32": 1, "bf16": 2}[cfg.tsdf_dtype] | {"u16": 0, "f32": 1}[cfg.weight_dtype] << 2
    assert code != kernels.storage_code(torch.int16, torch.uint16) == 0
    with pytest.raises(TypeError):
        kernels.storage_code(torch.float16, v.weight.dtype)


@pytest.fixture(scope="module")
def jax_bf16_state():
    """A JAX state under bf16/f32 (``init_state``, no compile) whose volume
    holds seeded tsdf values in [-1, 1] and weights, as numpy."""
    rng = np.random.RandomState(7)
    st = jkinfu.init_state(JC_BF16)
    shape = st.vol.tsdf.shape
    tsdf = jnp.asarray(rng.uniform(-1.0, 1.0, shape).astype(np.float32)).astype(jnp.bfloat16)
    weight = jnp.asarray(rng.randint(0, 64, shape).astype(np.float32))
    return cases.np_tree(st._replace(vol=st.vol._replace(tsdf=tsdf, weight=weight)))


def test_interop_carries_a_jax_bf16_volume(jax_bf16_state):
    """JAX's bf16 volume -> the port (torch.bfloat16) -> numpy: the same
    bits both ways, typed "V2" on the way out."""
    j = jax_bf16_state
    jbits = np.asarray(j.vol.tsdf).view(np.uint16)
    st = interop.state_from_numpy(j, "cpu")
    assert st.vol.tsdf.dtype == torch.bfloat16 and st.vol.weight.dtype == torch.float32
    np.testing.assert_array_equal(st.vol.tsdf.view(torch.int16).numpy().view(np.uint16), jbits)
    back = interop.state_to_numpy(st)
    assert back["vol"]["tsdf"].dtype == np.dtype("V2")
    np.testing.assert_array_equal(back["vol"]["tsdf"].view(np.uint16), jbits)
    again = interop.state_from_numpy(back, "cpu")
    assert torch.equal(again.vol.tsdf.view(torch.int16), st.vol.tsdf.view(torch.int16))


def test_checkpoint_refuses_a_bf16_volume(jax_bf16_state, tmp_path):
    """Neither way: JAX's own checkpoint of a bf16 volume does not load
    back in JAX, so the port's format holds no bf16 volume either."""
    st = interop.state_from_numpy(jax_bf16_state, "cpu")
    with pytest.raises(NotImplementedError, match="bf16"):
        tcheckpoint.save(str(tmp_path / "s.npz"), st)
    # the leaves JAX's np.savez writes for a bf16 volume
    flat = tcheckpoint.leaves(st)
    arrays = {f"a{i}": interop.to_numpy(t) for i, t in enumerate(flat)}
    np.savez(tmp_path / "j.npz", n=len(flat), **arrays)
    with pytest.raises(NotImplementedError, match="bf16"):
        tcheckpoint.load(str(tmp_path / "j.npz"), TC_BF16, device="cpu")
