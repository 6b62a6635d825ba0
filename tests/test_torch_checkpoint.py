"""The port's checkpoints against the JAX package's: one format, so a file
written by either package loads in the other, leaf for leaf. States are
made from a seed with numpy (random codes, poses, maps and fields of the
init state's shapes)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu.utils import checkpoint as jckpt
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.models import volume as tvolume
from dynamicfusion_tpu_torch.parallel import sharded as psharded
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu
from dynamicfusion_tpu_torch.utils import checkpoint as tckpt

KW = dict(max_nodes=64)
JC = dataclasses.replace(JCfg.small(dims=32, rows=60, cols=80), **KW)
TC = dataclasses.replace(TCfg.small(dims=32, rows=60, cols=80), **KW)


def _random_leaf(rng, a):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return rng.rand(*a.shape) < 0.5
    if a.dtype.kind in "iu":
        info = np.iinfo(a.dtype)
        return rng.randint(max(info.min, -30000), min(info.max, 60000), a.shape).astype(a.dtype)
    return rng.randn(*a.shape).astype(a.dtype)


def _jax_state(seed=0):
    """The JAX package's init state with seeded random leaves (numpy)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: _random_leaf(rng, a), jkinfu.init_state(JC))


def _assert_states_equal(a, b):
    la, lb = tckpt.leaves(a), tckpt.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.uint16 else x,
                           y.view(torch.int16) if y.dtype == torch.uint16 else y)


def test_leaf_order_is_jax_tree_flatten():
    """The port's ``leaves`` of its own init state: the count, shapes and
    dtypes of ``jax.tree.flatten`` of JAX's ``init_state``, and its order
    on the same state."""
    jflat, _ = jax.tree.flatten(jkinfu.init_state(JC))
    tflat = tckpt.leaves(tkinfu.init_state(TC, "cpu"))
    assert len(tflat) == len(jflat)
    for j, t in zip(jflat, tflat):
        assert tuple(j.shape) == tuple(t.shape)
        assert np.dtype(j.dtype) == t.numpy().dtype
    js = _jax_state(1)
    for j, t in zip(jax.tree.flatten(js)[0], tckpt.leaves(interop.state_from_numpy(js, "cpu"))):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    js = _jax_state(0)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, js)
    got = tckpt.load(path, TC, device="cpu")
    _assert_states_equal(got, interop.state_from_numpy(js, "cpu"))
    assert got.vol.tsdf.device.type == "cpu"


def test_port_checkpoint_loads_in_jax(tmp_path):
    ts = interop.state_from_numpy(_jax_state(2), "cpu")
    path = str(tmp_path / "port.npz")
    tckpt.save(path, ts)
    got = jckpt.load(path, JC)
    jflat = jax.tree.flatten(got)[0]
    tflat = tckpt.leaves(ts)
    assert len(jflat) == len(tflat)
    for j, t in zip(jflat, tflat):
        j = np.asarray(j)
        assert j.dtype == t.numpy().dtype
        np.testing.assert_array_equal(j, t.numpy())


def test_round_trip_resumes_the_pipeline(tmp_path):
    """A port checkpoint of a running pipeline restores into a fresh
    DynamicFusion (the first-frame flag follows frame_idx)."""
    df = tkinfu.DynamicFusion(TC, device="cpu")
    df.state = interop.state_from_numpy(_jax_state(3)._replace(frame_idx=np.int32(4)), "cpu")
    path = str(tmp_path / "ckpt.npz")
    tckpt.save(path, df.state)
    df2 = tkinfu.DynamicFusion(TC, device="cpu")
    df2.restore(tckpt.load(path, TC, device="cpu"))
    assert df2._started and int(df2.state.frame_idx) == 4
    _assert_states_equal(df2.state, df.state)


def test_load_rejects_a_wrong_config(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    tckpt.save(path, interop.state_from_numpy(_jax_state(4), "cpu"))
    with pytest.raises(ValueError, match="incompatible"):
        tckpt.load(path, dataclasses.replace(TC, volume_dims=64), device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load(path, dataclasses.replace(TC, pyramid_levels=TC.pyramid_levels + 1,
                                             icp_iters=tuple(TC.icp_iters) + (1,)), device="cpu")
    # a restore onto a mesh checks the leaves as well
    mesh = psharded.make_mesh(4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="incompatible"):
        tckpt.load(path, dataclasses.replace(TC, volume_dims=64), mesh=mesh)


def test_f32_migration(tmp_path):
    """A checkpoint of the i16/u16 storage loads under an f32 config
    re-encoded (the CPU runs every storage), as JAX's load migrates it."""
    js = _jax_state(5)
    path = str(tmp_path / "ckpt.npz")
    jckpt.save(path, js)
    cfg32 = dataclasses.replace(TC, tsdf_dtype="f32", weight_dtype="f32")
    got = tckpt.load(path, cfg32, device="cpu")
    assert got.vol.tsdf.dtype == torch.float32 and got.vol.weight.dtype == torch.float32
    ref = jckpt.load(path, dataclasses.replace(JC, tsdf_dtype="f32", weight_dtype="f32"))
    np.testing.assert_array_equal(got.vol.tsdf.numpy(), np.asarray(ref.vol.tsdf))
    np.testing.assert_array_equal(got.vol.weight.numpy(), np.asarray(ref.vol.weight))
    # and back: an f32 checkpoint loads under the i16/u16 config re-encoded
    path32 = str(tmp_path / "ckpt32.npz")
    tckpt.save(path32, got)
    back = tckpt.load(path32, TC, device="cpu")
    orig = interop.state_from_numpy(js, "cpu").vol
    np.testing.assert_array_equal(back.vol.tsdf.numpy(), tvolume.encode_tsdf(
        tvolume.decode_tsdf(orig.tsdf), torch.int16).numpy())
    assert torch.equal(back.vol.weight.view(torch.int16), orig.weight.view(torch.int16))


def test_cuda_is_the_default_device(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    tckpt.save(path, interop.state_from_numpy(_jax_state(6), "cpu"))
    if torch.cuda.is_available():
        assert tckpt.load(path, TC).pose.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            tckpt.load(path, TC)
