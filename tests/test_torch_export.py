"""Parity of the port's extracted normals (kernel R's plain version), mesh
extraction (canonical and live) and PLY/OBJ writers with the JAX
package's, on the CPU.

One volume (a noisy analytic sphere with a ripple, int16/uint16 codes, some
voxels unobserved) and one warp field (random nodes near the surface), made
from a seed with numpy, go to both packages. The point list is
``extract_cloud``'s rows (the demo's input to ``extract_normals``, with
its NaN tail) plus points outside the volume.

Which JAX the port follows: the port's plain ``extract_normals`` is
bit-equal to JAX's op by op (as ``apps/demo.py`` calls it). Jitted, XLA
contracts the trilinear sums into fused multiply-adds and parts from
both by up to an ulp on the surface rows (within ``TOL_NORMAL``); at a
point whose six samples are equal (saturated TSDF, not on the list) it
even gives a zero gradient a direction. The norm is the same in both:
XLA takes ``jnp.linalg.norm`` as fma(z, z, fma(y, y, x x)).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import dualquat as jdq
from dynamicfusion_tpu.io import export as jexport
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.models.volume import TsdfVolume as JVol
from dynamicfusion_tpu.ops import tsdf as jtsdf
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.io import export as texport
from dynamicfusion_tpu_torch.ops import tsdf as ttsdf
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL_NORMAL = 1e-4  # jitted JAX against the port (as test_torch_raycast_variants.py holds normals)
TOL_FIELD = 1e-5   # warped mesh vertices (m) and normals: the packages' KNN distances round alike to ~1e-7

D = 64
N = 128
JC = dataclasses.replace(JCfg.small(dims=D, rows=60, cols=80), max_nodes=N)
TC = dataclasses.replace(TCfg.small(dims=D, rows=60, cols=80), max_nodes=N)
MAX_POINTS = 1 << 14


@functools.lru_cache(maxsize=None)
def _volume():
    """(tsdf int16, weight uint16) codes of a noisy rippled sphere."""
    rng = np.random.RandomState(0)
    g = np.arange(D) * TC.voxel_size
    x, y, z = np.meshgrid(*(g + o for o in TC.volume_origin), indexing="ij")
    sdf = np.sqrt(x ** 2 + y ** 2 + (z - 1.0) ** 2) - 0.25 + 0.02 * np.sin(7 * x) * np.cos(5 * y)
    t = np.clip(sdf / 0.1 + rng.normal(0.0, 0.01, sdf.shape), -1.0, 1.0).astype(np.float32)
    w = rng.randint(1, 200, t.shape).astype(np.uint16)
    w[rng.rand(*w.shape) < 0.02] = 0
    return np.round(t * 32767).astype(np.int16), w


@functools.lru_cache(maxsize=None)
def _state():
    """The JAX package's state as numpy: the volume, and a field of N nodes
    near the sphere with random transforms (a quarter inactive)."""
    rng = np.random.RandomState(1)
    tsdf, weight = _volume()
    d = rng.randn(N, 3)
    pos = (0.25 * d / np.linalg.norm(d, axis=1, keepdims=True) + [0.0, 0.0, 1.0]).astype(np.float32)
    act = rng.rand(N) < 0.75
    dq = np.asarray(jdq.from_twist(jnp.asarray(rng.randn(N, 3).astype(np.float32) * 0.05),
                                   jnp.asarray(rng.randn(N, 3).astype(np.float32) * 0.01)))
    js = jax.tree_util.tree_map(np.asarray, jkinfu.init_state(JC))
    warp = jw.WarpField(pos, dq, np.full(N, 0.05, np.float32), act, np.int32(act.sum()),
                        np.zeros(N, np.int32))
    return js._replace(vol=JVol(tsdf, weight), warp=warp, frame_idx=np.int32(5))


def _jstate():
    return jax.tree_util.tree_map(jnp.asarray, _state())


@functools.lru_cache(maxsize=None)
def _points():
    """extract_cloud's rows (NaN past the count), points outside the volume
    or on its last cell (a sample leaves it: NaN) and NaN points."""
    tv = interop.state_from_numpy(_state(), "cpu").vol
    cloud = ttsdf.extract_cloud(TC, tv, MAX_POINTS).points.numpy()
    assert 0 < np.isfinite(cloud[:, 0]).sum() < MAX_POINTS
    o = np.asarray(TC.volume_origin, np.float32)
    edge = np.array([[-0.01, 0.3, 0.3], [0.999, 0.3, 0.3], [0.3, 1.2, 0.3]], np.float32) + o
    return np.concatenate([cloud, edge, np.full((2, 3), np.nan, np.float32)])


@functools.lru_cache(maxsize=None)
def _port_normals():
    tv = interop.state_from_numpy(_state(), "cpu").vol
    return ttsdf.extract_normals(TC, tv, torch.from_numpy(_points())).numpy()


def test_extract_normals_bit_equal_to_jax_op_by_op():
    got = _port_normals()
    ref = np.asarray(jtsdf.extract_normals(JC, _jstate().vol, jnp.asarray(_points())))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    valid = ~np.isnan(got[:, 0])
    assert valid.sum() > 1000 and np.isnan(got[-5:]).all()
    np.testing.assert_array_equal(got[valid].view(np.int32), ref[valid].view(np.int32))
    np.testing.assert_allclose(np.linalg.norm(got[valid], axis=1), 1.0, atol=1e-6)


def test_extract_normals_within_tolerance_of_jitted_jax():
    got = _port_normals()
    ref = np.asarray(jax.jit(lambda v, p: jtsdf.extract_normals(JC, v, p))(_jstate().vol, jnp.asarray(_points())))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    valid = ~np.isnan(got[:, 0])
    assert np.abs(got[valid] - ref[valid]).max() <= TOL_NORMAL


def test_gradient_matches_jax():
    """The unnormalized six-sample gradient with per-axis deltas."""
    tsdf, _ = _volume()
    rng = np.random.RandomState(2)
    p = rng.uniform(-1.0, D, (4000, 3)).astype(np.float32)
    delta = (0.5, 0.25, 1.0)
    ref = np.asarray(jtsdf.gradient(jnp.asarray(tsdf), jnp.asarray(p), jnp.asarray(delta, jnp.float32)))
    got = ttsdf.gradient(torch.from_numpy(tsdf), torch.from_numpy(p), delta).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.nan_to_num(got).view(np.int32), np.nan_to_num(ref).view(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_mesh():
    return jexport.extract_mesh(JC, _jstate().vol)


def test_extract_mesh_bit_equal_to_jax():
    ref = _jax_mesh()
    got = texport.extract_mesh(TC, interop.state_from_numpy(_state(), "cpu").vol)
    assert len(got.faces) > 1000
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_live_mesh_matches_jax_warp_points():
    """``DynamicFusion.extract_mesh(live=True)``: the canonical mesh's
    vertices and normals warped by the field (kernel E's plain version)
    against JAX's ``warp_points``, as JAX's ``extract_mesh`` calls it."""
    df = tkinfu.DynamicFusion(TC, device="cpu")
    df.state = interop.state_from_numpy(_state(), "cpu")
    got = df.extract_mesh(live=True)
    ref = _jax_mesh()
    v, n = jw.warp_points(_jstate().warp, jnp.asarray(ref.vertices), jnp.asarray(ref.normals),
                          k=JC.knn_k, method=JC.knn_method)
    np.testing.assert_array_equal(got.faces, ref.faces)
    assert got.vertices.dtype == np.float32 and got.normals.dtype == np.float32
    assert np.abs(got.vertices - ref.vertices).max() > 1e-3  # the field moved the surface
    np.testing.assert_allclose(got.vertices, np.asarray(v), atol=TOL_FIELD, rtol=0)
    np.testing.assert_allclose(got.normals, np.asarray(n), atol=TOL_FIELD, rtol=0)


@pytest.mark.parametrize("ext", ["ply", "obj"])
def test_save_mesh_byte_identical(tmp_path, ext):
    """``DynamicFusion.save_mesh`` writes the same file as the JAX
    package's from the same state."""
    jdf = jkinfu.DynamicFusion(JC)
    jdf.state = _jstate()
    tdf = tkinfu.DynamicFusion(TC, device="cpu")
    tdf.state = interop.state_from_numpy(_state(), "cpu")
    jdf.save_mesh(str(tmp_path / f"j.{ext}"))
    tdf.save_mesh(str(tmp_path / f"t.{ext}"))
    assert (tmp_path / f"j.{ext}").read_bytes() == (tmp_path / f"t.{ext}").read_bytes()


def test_save_cloud_writes_the_extracted_cloud(tmp_path):
    """``DynamicFusion.save_cloud``: ``extract_cloud``'s rows at 1 << 20
    (held against JAX in test_torch_tsdf_bricks.py), NaN rows dropped, as
    a binary PLY (the writer is held byte for byte below)."""
    tdf = tkinfu.DynamicFusion(TC, device="cpu")
    tdf.state = interop.state_from_numpy(_state(), "cpu")
    tdf.save_cloud(str(tmp_path / "cloud.ply"))
    cloud = ttsdf.extract_cloud(TC, tdf.state.vol, 1 << 20)
    data = (tmp_path / "cloud.ply").read_bytes()
    head, body = data.split(b"end_header\n")
    assert f"element vertex {int(cloud.count)}".encode() in head
    np.testing.assert_array_equal(np.frombuffer(body, "<f4").reshape(-1, 3), cloud.points[: int(cloud.count)].numpy())


def _mesh_arrays(nan_rows=False):
    rng = np.random.RandomState(3)
    v = rng.uniform(-1.0, 1.0, (50, 3)).astype(np.float32)
    if nan_rows:
        v[[3, 17]] = np.nan
    n = rng.randn(50, 3).astype(np.float32)
    f = rng.randint(0, 50, (80, 3)).astype(np.int32)
    return v, n, f, rng.rand(50, 3)


WRITES = {
    "ply_binary_mesh": lambda m, v, n, f, c, p: m.save_ply(p, v, normals=n, faces=f),
    "ply_binary_colors": lambda m, v, n, f, c, p: m.save_ply(p, v, normals=n, colors=c),
    "ply_ascii_colors_faces": lambda m, v, n, f, c, p: m.save_ply(p, v, colors=(c * 255).astype(np.uint8), faces=f,
                                                                  binary=False),
    "ply_points": lambda m, v, n, f, c, p: m.save_ply(p, v),
    "obj_mesh": lambda m, v, n, f, c, p: m.save_obj(p, v, f, n),
    "obj_faces": lambda m, v, n, f, c, p: m.save_obj(p, v, f),
    "mesh_ply": lambda m, v, n, f, c, p: m.save_mesh(p + ".ply", m.Mesh(v, f, n)),
    "mesh_obj": lambda m, v, n, f, c, p: m.save_mesh(p + ".obj", m.Mesh(v, f, n)),
}


@pytest.mark.parametrize("nan_rows", [False, True], ids=["finite", "nan_rows"])
@pytest.mark.parametrize("kind", sorted(WRITES))
def test_writers_byte_identical(tmp_path, kind, nan_rows):
    v, n, f, c = _mesh_arrays(nan_rows)
    WRITES[kind](jexport, v, n, f, c, str(tmp_path / "j"))
    WRITES[kind](texport, v, n, f, c, str(tmp_path / "t"))
    jfiles = sorted(p.name[1:] for p in tmp_path.iterdir() if p.name.startswith("j"))
    tfiles = sorted(p.name[1:] for p in tmp_path.iterdir() if p.name.startswith("t"))
    assert jfiles == tfiles and len(jfiles) == 1
    assert (tmp_path / ("j" + jfiles[0])).read_bytes() == (tmp_path / ("t" + tfiles[0])).read_bytes()
