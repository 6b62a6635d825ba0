"""The PyTorch port's package rules and its copies of JAX-package code.

The port (``dynamicfusion_tpu_torch``) imports neither JAX nor the JAX
package; it keeps its own copies of the config, the volume codec and the
synthetic scenes, which must stay identical to the originals. Inputs are
made with numpy from a seed and handed to both packages.
"""

import ast
import contextlib
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu import config as jconfig
from dynamicfusion_tpu.io import capture as jcapture
from dynamicfusion_tpu.io import dataset as jdataset
from dynamicfusion_tpu.io import export as jexport
from dynamicfusion_tpu.io import native_loader as jnative
from dynamicfusion_tpu.io import synthetic as jsyn
from dynamicfusion_tpu.models import volume as jvolume
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu_torch import config as tconfig
from dynamicfusion_tpu_torch import device as tdevice
from dynamicfusion_tpu_torch import interop, kernels
from dynamicfusion_tpu_torch.core import compact
from dynamicfusion_tpu_torch.io import capture as tcapture
from dynamicfusion_tpu_torch.io import dataset as tdataset
from dynamicfusion_tpu_torch.io import export as texport
from dynamicfusion_tpu_torch.io import native_loader as tnative
from dynamicfusion_tpu_torch.io import synthetic as tsyn
from dynamicfusion_tpu_torch.models import volume as tvolume
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "dynamicfusion_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                           ROOT / "apps" / "demo_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "dynamicfusion_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_import_check_covers_the_parallel_package():
    """The sharded pipeline's modules are among the files checked above,
    every one of the JAX package's parallel/ modules has its counterpart,
    and the multi-process worker module imports only the port."""
    port = {p.name for p in PORT_FILES if p.parent.name == "parallel"}
    jax_mods = {p.name for p in (ROOT / "dynamicfusion_tpu" / "parallel").glob("*.py")}
    assert jax_mods <= port and "mesh.py" in port
    mods = set(_imported_modules(ROOT / "dynamicfusion_tpu_torch" / "parallel" / "multihost.py"))
    assert all(m.split(".")[0] in ("torch", "dynamicfusion_tpu_torch", "__future__", "argparse", "dataclasses",
                                   "json", "os", "sys", "time", "typing") for m in mods), mods


PRESETS = [
    ("default", lambda c: c()),
    ("default_dynamicfusion", lambda c: c.default_dynamicfusion()),
    ("quality_dynamicfusion", lambda c: c.quality_dynamicfusion()),
    ("reference_parity", lambda c: c.reference_parity()),
    ("default_kinfu", lambda c: c.default_kinfu()),
    ("small", lambda c: c.small()),
    ("small_32_60_80", lambda c: c.small(dims=32, rows=60, cols=80)),
]


@pytest.mark.parametrize("name,make", PRESETS, ids=[p[0] for p in PRESETS])
def test_config_copy_matches_field_by_field(name, make):
    j = make(jconfig.DynamicFusionConfig)
    t = make(tconfig.DynamicFusionConfig)
    jf = [f.name for f in dataclasses.fields(j)]
    assert jf == [f.name for f in dataclasses.fields(t)]
    for f in jf:
        jv, tv = getattr(j, f), getattr(t, f)
        if f == "intr":
            assert dataclasses.astuple(jv) == dataclasses.astuple(tv)
        else:
            assert jv == tv and type(jv) is type(tv), f"{name}.{f}: {jv!r} != {tv!r}"
    for prop in ("voxel_size", "raycast_shift", "track_levels"):
        assert getattr(j, prop) == getattr(t, prop)
    for lvl in range(4):
        assert dataclasses.astuple(j.intr.level(lvl)) == dataclasses.astuple(t.intr.level(lvl))


def test_rigid_slice_preset_is_the_rigid_bench_config():
    j = dataclasses.replace(
        jconfig.DynamicFusionConfig.default_dynamicfusion(), rigid_only=True, raycast_refine="secant"
    )
    t = tconfig.DynamicFusionConfig.rigid_slice()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize(
    "bad", [dict(volume_dims=48), dict(brick_size=24), dict(raycast_subsample=3), dict(tsdf_dtype="f16")]
)
def test_config_copy_rejects_what_the_original_rejects(bad):
    with pytest.raises((AssertionError, ValueError)):
        jconfig.DynamicFusionConfig(**bad)
    with pytest.raises(ValueError):
        tconfig.DynamicFusionConfig(**bad)


def test_volume_codec_bit_exact():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1.2, 1.2, 20000).astype(np.float32)
    # exact half-way codes: round half to even must agree
    ties = ((np.arange(-200, 200) + 0.5) / 32767.0).astype(np.float32)
    x = np.concatenate([x, ties, np.float32([-1.0, 1.0, 0.0])])
    jt = np.asarray(jvolume.encode_tsdf(jnp.asarray(x), jnp.int16))
    tt = tvolume.encode_tsdf(torch.from_numpy(x), torch.int16).numpy()
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(
        np.asarray(jvolume.decode_tsdf(jnp.asarray(jt))).view(np.int32),
        tvolume.decode_tsdf(torch.from_numpy(tt)).numpy().view(np.int32),
    )
    # weights up to past the 64 cap (64 * 512 = 32768 does not fit int16), with ties
    w = np.concatenate([
        rng.uniform(-1.0, 130.0, 20000),
        (np.arange(0, 400) + 0.5) / 512.0,
        [64.0, 64.0 + 1 / 512.0, 127.998046875, 200.0],
    ]).astype(np.float32)
    jw = np.asarray(jvolume.encode_weight(jnp.asarray(w), jnp.uint16))
    tw = tvolume.encode_weight(torch.from_numpy(w), torch.uint16)
    assert tw.dtype == torch.uint16
    np.testing.assert_array_equal(jw, tw.numpy())
    assert tw.numpy().max() == 65535 and (tw.numpy() == 32768).any()
    np.testing.assert_array_equal(
        np.asarray(jvolume.decode_weight(jnp.asarray(jw))).view(np.int32),
        tvolume.decode_weight(tw).numpy().view(np.int32),
    )
    cfg = tconfig.DynamicFusionConfig.small()
    assert tvolume.trunc_dist(cfg) == jvolume.trunc_dist(jconfig.DynamicFusionConfig.small())


def test_synthetic_copy_matches():
    cfg = jconfig.DynamicFusionConfig.small()
    scene = dict(spheres=[dict(center=(0.05, -0.02, 0.9), radius=0.2)], plane_z=1.2)
    for angle in (0.0, 0.03, -0.11):
        jp = jsyn.orbit_pose(angle, target=(0.0, 0.0, 0.9))
        tp = tsyn.orbit_pose(angle, target=(0.0, 0.0, 0.9))
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(
            jsyn.scene_depth(cfg.intr, cfg.rows, cfg.cols, jp, **scene),
            tsyn.scene_depth(tconfig.DynamicFusionConfig.small().intr, cfg.rows, cfg.cols, tp, **scene),
        )


def test_deforming_frames_are_the_bench_scene():
    """bench.py's frames(): two spheres over z = 1.25, the small one
    oscillating, seen from the identity pose."""
    cfg = jconfig.DynamicFusionConfig.small()
    got = tsyn.deforming_frames(tconfig.DynamicFusionConfig.small().intr, cfg.rows, cfg.cols, 3)
    for t, d in enumerate(got):
        sp = [dict(center=(0.0, 0.0, 0.95), radius=0.22),
              dict(center=(0.2 + 0.008 * np.sin(0.4 * t), 0.1, 0.8), radius=0.1)]
        np.testing.assert_array_equal(d, jsyn.scene_depth(cfg.intr, cfg.rows, cfg.cols, spheres=sp, plane_z=1.25))


def test_bulge_frames_are_the_bench_scene():
    """bench.py's bulge scene: ``bulge_depth`` of the JAX package's
    ``io.synthetic`` at frames t = 0, 1, 2."""
    cfg = jconfig.DynamicFusionConfig.small()
    got = tsyn.bulge_frames(tconfig.DynamicFusionConfig.small().intr, cfg.rows, cfg.cols, 3)
    for t, d in enumerate(got):
        np.testing.assert_array_equal(d, jsyn.bulge_depth(cfg.intr, cfg.rows, cfg.cols, t))
    assert (got[0] != got[2]).any()


def _code(module, name: str) -> str:
    """The AST of a top-level function or class of ``module``, without its
    docstrings and with the port's package name read as the JAX package's
    (comments are not in the AST)."""
    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    (node,) = [n for n in tree.body if getattr(n, "name", None) == name]
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if (isinstance(sub, (ast.FunctionDef, ast.ClassDef)) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            sub.body = body[1:] or [ast.Pass()]
        if isinstance(sub, ast.ImportFrom) and sub.module:
            sub.module = sub.module.replace("dynamicfusion_tpu_torch", "dynamicfusion_tpu")
    return ast.dump(node)


# the port's copies of the JAX package's numpy-only modules: the same code
# but for docstrings and ``extract_mesh``, which reads the port's volume
COPIES = [
    (jexport, texport, ("_trilinear_gradient", "marching_tetrahedra", "save_ply", "save_obj", "save_mesh", "Mesh")),
    (jcapture, tcapture, ("FrameSource", "DatasetSource", "SyntheticSource", "OpenNISource", "open_source")),
    (jdataset, tdataset, ("_sorted_pngs", "DepthSequence")),
    (jnative, tnative, ("_load", "native_available", "_image_from_handle", "read_png", "PrefetchingSequence")),
]


@pytest.mark.parametrize("jmod,tmod,names", COPIES, ids=[c[0].__name__.rsplit(".", 1)[1] for c in COPIES])
def test_io_copies_match(jmod, tmod, names):
    for name in names:
        assert _code(jmod, name) == _code(tmod, name), f"{tmod.__name__}.{name} differs from its original"


def test_export_tables_and_mesh_match():
    for table in ("_CUBE", "_TETS", "_TET_EDGES", "_TRI_TABLE"):
        a, b = getattr(jexport, table), getattr(texport, table)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(4)
    g = np.linspace(-1.0, 1.0, 24)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    tsdf = (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6 + rng.normal(0.0, 0.02, x.shape)).astype(np.float32)
    weight = (rng.rand(*x.shape) > 0.05).astype(np.float32)
    ref = jexport.marching_tetrahedra(tsdf, weight, 0.01, (0.1, -0.2, 0.3))
    got = texport.marching_tetrahedra(tsdf, weight, 0.01, (0.1, -0.2, 0.3))
    assert len(got.faces) > 100
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_first_true_is_static_nonzero():
    rng = np.random.RandomState(3)
    for n, size, p in ((1000, 64, 0.02), (1000, 64, 0.5), (37, 50, 0.3), (10, 4, 0.0)):
        m = rng.rand(n) < p
        (ref,) = np.asarray(jnp.nonzero(jnp.asarray(m), size=size, fill_value=-1))
        got = compact.first_true(torch.from_numpy(m), size).numpy()
        np.testing.assert_array_equal(ref, got)


def test_interop_round_trip_keeps_dtypes():
    jcfg = jconfig.DynamicFusionConfig.small(dims=32, rows=60, cols=80)
    js = jax.tree_util.tree_map(np.asarray, jkinfu.init_state(jcfg))
    rng = np.random.RandomState(1)
    vol = js.vol._replace(
        tsdf=rng.randint(-32767, 32768, js.vol.tsdf.shape).astype(np.int16),
        weight=rng.randint(0, 65536, js.vol.weight.shape).astype(np.uint16),
    )
    js = js._replace(vol=vol, pose=rng.randn(4, 4).astype(np.float32), frame_idx=np.int32(7))
    ts = interop.state_from_numpy(js, "cpu")
    assert ts.vol.tsdf.dtype == torch.int16 and ts.vol.weight.dtype == torch.uint16
    back = interop.state_to_numpy(ts)
    flat_j = jax.tree_util.tree_leaves(js)
    flat_b = jax.tree_util.tree_leaves(
        (back["vol"]["tsdf"], back["vol"]["weight"], *back["warp"].values(), back["pose"],
         back["prev_points"], back["prev_normals"], back["can_points"], back["can_normals"],
         back["frame_idx"])
    )
    assert len(flat_j) == len(flat_b)
    for a, b in zip(flat_j, flat_b):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        assert tdevice.resolve().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        tdevice.resolve()
    with pytest.raises(RuntimeError, match="is_available"):
        tkinfu.DynamicFusion(tconfig.DynamicFusionConfig.small(dims=32, rows=60, cols=80))
    assert tdevice.resolve("cpu").type == "cpu"


@pytest.mark.parametrize("refine", ["newton16", "hybrid16"])
def test_non_rigid_frame0_runs_the_variants(refine):
    """Frame 0 of a non-rigid config with dense fusion, the newton16 or
    hybrid16 refine and the six-sample normals runs on the CPU: the volume
    is fused, nodes are sampled, the model maps hold unit normals."""
    cfg = dataclasses.replace(
        tconfig.DynamicFusionConfig.small(dims=32, rows=60, cols=80), raycast_refine=refine,
        integrate_mode="dense", raycast_smooth_normals=True,
    )
    assert not cfg.rigid_only
    depth = tsyn.scene_depth(cfg.intr, cfg.rows, cfg.cols, np.eye(4), spheres=[dict(center=(0.0, 0.0, 0.9),
                                                                                     radius=0.2)], plane_z=1.2)
    state = tkinfu.first_frame(cfg, tkinfu.init_state(cfg, "cpu"), torch.from_numpy(depth))
    assert int((state.vol.weight.to(torch.int32) > 0).sum()) > 0 and int(state.warp.count) > 0
    n = state.prev_normals[0]
    hit = ~torch.isnan(n[..., 0])
    assert float(hit.float().mean()) > 0.3
    assert torch.allclose(torch.linalg.vector_norm(n[hit], dim=-1), torch.ones(()), atol=1e-5)


WRAPPER_CALLS = {
    "bilateral": lambda: kernels.bilateral_filter(torch.zeros((8, 8), dtype=torch.uint16), 7, 4.5, 0.04),
    "icp_reduce": lambda: kernels.icp_build_system(
        tconfig.DynamicFusionConfig.small().intr, torch.eye(4), *(torch.zeros((4, 4, 3)),) * 4, 0.01, 0.8
    ),
    "raycast": lambda: kernels.march_and_refine(
        torch.zeros((32, 32, 32), dtype=torch.int16), torch.zeros(3), torch.zeros((4, 3)),
        torch.zeros(4), torch.ones(4), 0.03, 0.03, 10, True, delta=0.5,
    ),
    "fuse_bricks": lambda: kernels.fuse_bricks(
        torch.zeros((32, 32, 32), dtype=torch.int16), torch.zeros((32, 32, 32), dtype=torch.uint16),
        torch.zeros((8, 8)), torch.zeros((3, 3, 3, 3)), *(torch.zeros(8, dtype=torch.int32),) * 2,
        torch.zeros(1, dtype=torch.int32), torch.ones((), dtype=torch.bool),
        *(torch.zeros(8, dtype=torch.int32),) * 2,
        brick=16, stride=16, intr=tconfig.DynamicFusionConfig.small().intr, rect=8, trunc=0.04,
        max_weight=64.0,
    ),
    "knn_blend": lambda: kernels.knn_blend(
        torch.zeros((8, 3)), torch.ones(8, dtype=torch.bool), torch.ones(8), torch.zeros((8, 8)),
        torch.zeros((4, 3)), 8,
    ),
    "data_term": lambda: kernels.data_term(
        *(torch.zeros((4, 3)),) * 3, torch.ones(4, dtype=torch.bool), torch.zeros((4, 8), dtype=torch.int64),
        torch.zeros((4, 8)), torch.zeros((8, 8)), torch.zeros(32, dtype=torch.int32),
        torch.zeros(9, dtype=torch.int32), 0.05, True,
    ),
    "mutual_nearest": lambda: kernels.mutual_nearest(
        torch.zeros((8, 3)), torch.ones(8, dtype=torch.bool), torch.zeros((4, 3)), torch.ones(4, dtype=torch.bool),
    ),
    "warp_trilinear": lambda: kernels.warp_trilinear(
        torch.zeros((3, 3, 3, 8)), torch.zeros((4, 3)), torch.zeros((4, 3)), (0.0, 0.0, 0.0), 0.1,
    ),
    "edge_term": lambda: kernels.edge_term(
        torch.zeros((8, 8)), *(torch.zeros(32, dtype=torch.int64),) * 2, torch.ones(32, dtype=torch.bool),
        torch.zeros((32, 3)), torch.ones(32), torch.zeros(32, dtype=torch.int32), torch.zeros(9, dtype=torch.int32),
        1.0, 1e-3,
    ),
    "spd6_inv": lambda: kernels.spd6_inv(torch.zeros((8, 6, 6))),
    "matvec": lambda: kernels.matvec(_factored_system(), torch.zeros(48)),
    "pcg": lambda: kernels.pcg(
        _factored_system(), torch.zeros((8, 6, 6)), torch.zeros(48), 12, 1e-3, torch.ones((), dtype=torch.bool),
    ),
    "data_matvec": lambda: kernels.data_matvec(
        torch.zeros((4, 1, 8, 6), dtype=torch.bfloat16), torch.zeros((4, 8), dtype=torch.int32),
        torch.zeros(32, dtype=torch.int32), torch.zeros(9, dtype=torch.int32), torch.arange(8), torch.zeros(48),
    ),
    "pcg_init": lambda: kernels.pcg_sharded_init(
        torch.zeros((8, 6, 6)), torch.zeros(48), 12, 1e-3, torch.ones((), dtype=torch.bool),
    ),
    "pcg_step": lambda: kernels.pcg_sharded_step(
        _factored_system(), torch.zeros((8, 6, 6)), torch.zeros(48), torch.zeros(48), torch.zeros(4 * 48 + 3),
    ),
    "insert_select": lambda: kernels.insert_select(
        torch.zeros((4, 3)), torch.zeros(4), torch.ones(4, dtype=torch.bool), torch.zeros(8, dtype=torch.bool),
        torch.zeros((), dtype=torch.int32), torch.ones((), dtype=torch.bool), 0.025,
    ),
    "insert_apply": lambda: kernels.insert_apply(
        torch.zeros((8, 3)), torch.zeros((8, 8)), torch.ones(8), torch.zeros(8, dtype=torch.bool),
        torch.zeros((), dtype=torch.int32), torch.zeros(8, dtype=torch.int32), torch.full((8,), 8),
        torch.zeros((8, 3)), torch.zeros((8, 8)), torch.zeros((), dtype=torch.int32), torch.full((8,), 0.05),
    ),
    "node_radius": lambda: kernels.node_radius(
        torch.zeros((8, 3)), torch.ones(8, dtype=torch.bool), torch.zeros((4, 3)), 4, 1.0, 0.03, 0.1,
    ),
    "dense_pcg": lambda: kernels.dense_pcg(
        torch.eye(48), torch.zeros((8, 6, 6)), torch.zeros(48), 32, 1e-3, torch.ones((), dtype=torch.bool),
    ),
    "net_rigid": lambda: kernels.net_rigid(
        torch.zeros((8, 3)), torch.zeros((8, 8)), torch.ones(8, dtype=torch.bool), torch.zeros((8, 8)),
        torch.ones(8, dtype=torch.bool), 0.5,
    ),
    "depth_dists": lambda: kernels.depth_dists(
        torch.zeros((8, 8), dtype=torch.uint16), tconfig.DynamicFusionConfig.small().intr,
    ),
    "pyramid_down": lambda: kernels.pyramid_down(torch.zeros((8, 8), dtype=torch.uint16), 0.04),
    "points_normals": lambda: kernels.points_normals(
        torch.zeros((8, 8), dtype=torch.uint16), tconfig.DynamicFusionConfig.small().intr, conf=True,
    ),
    "resize_maps": lambda: kernels.resize_maps(torch.zeros((8, 8, 3)), torch.zeros((8, 8, 3))),
    "march_bands": lambda: kernels.march_bands(torch.zeros((16, 16)), 2, torch.zeros((8, 8, 3)), 0.06, True),
    "coarse_band": lambda: kernels.coarse_band(torch.zeros((8, 8, 3)), 4, 0.06),
    "p2p_gate": lambda: kernels.p2p_gate(
        *(torch.zeros((8, 8, 3)),) * 3, torch.zeros((8, 8)), 41, 0.01, 0.35, 2.0, 0.3, 0.1, 16, 11, 1e-3, 252.15,
    ),
    "brick_plan": lambda: kernels.brick_plan(
        torch.zeros((8, 8)), torch.zeros((5, 5, 5, 3)), 16, 8, tconfig.DynamicFusionConfig.small().intr,
        8, 0.04, 1e-3, 4, torch.arange(8), 8, 2,
    ),
    "extract_cloud": lambda: kernels.extract_cloud(
        torch.zeros((8, 8, 8), dtype=torch.int16), torch.zeros((8, 8, 8), dtype=torch.uint16), 1.0, 64, 0.01,
        (0.0, 0.0, 0.0),
    ),
    "sample_nodes": lambda: kernels.sample_nodes(
        torch.zeros((64, 3)), torch.ones(64, dtype=torch.bool), 8, torch.arange(8), 4,
    ),
    "gram_scales": lambda: kernels.gram_scales(
        torch.zeros((4, 3, 8, 6), dtype=torch.bfloat16), torch.zeros(32, dtype=torch.int32),
        torch.zeros(9, dtype=torch.int32),
    ),
    "dense_gram": lambda: kernels.dense_gram(
        torch.zeros((4, 1, 8, 6), dtype=torch.bfloat16), torch.zeros((4, 8), dtype=torch.int32),
        torch.zeros(32, dtype=torch.int32), torch.zeros(9, dtype=torch.int32), torch.zeros((32, 6, 6)),
        torch.zeros((8, 6, 6)), torch.zeros(32, dtype=torch.int32), torch.zeros(32, dtype=torch.int32),
        torch.zeros(9, dtype=torch.int32), True,
    ),
    "dense_damp": lambda: kernels.dense_damp(
        torch.zeros((48, 48)), torch.ones(()), torch.ones(8, dtype=torch.bool), 0.05,
    ),
    "cholesky": lambda: kernels.cholesky(torch.eye(48)),
    "integrate_dense": lambda: kernels.integrate_dense(
        torch.zeros((32, 32, 32), dtype=torch.int16), torch.zeros((32, 32, 32), dtype=torch.uint16),
        torch.zeros((8, 8)), torch.zeros(12), torch.ones((), dtype=torch.bool),
        tconfig.DynamicFusionConfig.small().intr, 0.04, 64.0,
    ),
    "extract_normals": lambda: kernels.extract_normals(
        torch.zeros((8, 8, 8), dtype=torch.int16), torch.zeros((4, 3)), 0.01, (0.0, 0.0, 0.0), 0.5,
    ),
    "integrate_dense_nonrigid": lambda: kernels.integrate_dense_nonrigid(
        torch.zeros((32, 32, 32), dtype=torch.int16), torch.zeros((32, 32, 32), dtype=torch.uint16),
        torch.zeros((8, 8)), torch.zeros((17, 17, 17, 3)), torch.ones((17, 17, 17)), torch.zeros(12),
        torch.ones((), dtype=torch.bool), torch.zeros((), dtype=torch.int32), 2, 16, 2,
        tconfig.DynamicFusionConfig.small().intr, 0.04, 64.0,
    ),
}


def _factored_system(device="cpu", n=8, npt=4, nrows=1, **changes):
    """A (P = npt, N = n, 4 edges a node) factored system on ``device``."""
    kw = dict(device=device)
    fields = dict(
        rows=torch.zeros((npt, nrows, 8, 6), dtype=torch.bfloat16, **kw),
        knn_idx=torch.zeros((npt, 8), dtype=torch.int32, **kw),
        pt_order=torch.zeros(8 * npt, dtype=torch.int32, **kw), pt_off=torch.zeros(n + 1, dtype=torch.int32, **kw),
        heavy=torch.zeros(n, dtype=torch.int64, **kw),
        h_ii=torch.zeros((4 * n, 6, 6), **kw), h_jj=torch.zeros((4 * n, 6, 6), **kw),
        h_ij=torch.zeros((4 * n, 6, 6), **kw), e_dst=torch.zeros(4 * n, dtype=torch.int32, **kw),
        e_order=torch.zeros(4 * n, dtype=torch.int32, **kw), e_off=torch.zeros(n + 1, dtype=torch.int32, **kw),
        damp=torch.zeros(6 * n, **kw),
    )
    fields.update(changes)
    return kernels.FactoredSystem(**fields)


def test_every_kernel_has_a_wrapper_check():
    assert sorted(WRAPPER_CALLS) == sorted(kernels.KERNELS)


@pytest.mark.parametrize("name", sorted(WRAPPER_CALLS))
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A wrapper launches its kernel or raises: CPU tensors never fall back."""
    assert name in kernels.KERNELS
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        WRAPPER_CALLS[name]()
    assert kernels.launches == before


# ---------------------------------------------------------------- kernel N's launch, on the meta device

class _FakeLib:
    """Records the kernel library's calls; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


def _check_on_meta(t, name, dtype, shape=None):
    """``kernels._check`` with the meta device standing in for the card."""
    assert t.device.type == "meta", name
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


@pytest.fixture
def meta_lib(monkeypatch):
    """The wrappers on meta tensors: no card, no library, no launch counted."""
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "_check", _check_on_meta)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 0)
    monkeypatch.setattr(kernels, "launches", dict(kernels.launches))
    return lib


def _gram_args(n, npt=64, nrows=1, ce=4):
    meta = dict(device="meta")
    return dict(
        rows=torch.empty((npt, nrows, 8, 6), dtype=torch.bfloat16, **meta),
        knn_idx=torch.empty((npt, 8), dtype=torch.int32, **meta),
        order=torch.empty((npt * 8,), dtype=torch.int32, **meta), off=torch.empty((n + 1,), dtype=torch.int32, **meta),
        h_ij=torch.empty((ce * n, 6, 6), **meta), diag=torch.empty((n, 6, 6), **meta),
        e_dst=torch.empty((ce * n,), dtype=torch.int32, **meta),
        e_order=torch.empty((ce * n,), dtype=torch.int32, **meta),
        e_off=torch.empty((n + 1,), dtype=torch.int32, **meta),
    )


@pytest.mark.parametrize("mode", ["int8", "bf16", "shard", "edges_only"])
def test_dense_gram_wrapper_takes_2048_nodes(meta_lib, mode):
    """The wrapper hands 2048 nodes (12 288 dofs) to kernel N in each mode:
    the int8 Gram (column scales first), the bf16 one, the shard mode
    (given scales, no edges) and the edge-only call (no rows)."""
    n = 2048
    args = _gram_args(n, npt=0 if mode == "edges_only" else 64)
    kw = {}
    if mode == "shard":
        kw = dict(scale=torch.empty((6 * n,), device="meta"), edges=False)
        args.update(h_ij=None, diag=None, e_dst=None, e_order=None, e_off=None)
    out = kernels.dense_gram(**args, int8=mode in ("int8", "shard"), **kw)
    assert out.shape == (6 * n, 6 * n) and out.dtype == torch.float32
    names = [c[0] for c in meta_lib.calls]
    assert names == (["df_gram_scales"] if mode == "int8" else []) + ["df_gram_launch", "df_dense_gram"]
    assert meta_lib.calls[-2][1][0] == n
    call = meta_lib.calls[-1][1]
    # (.., ce, n, int8, with_edges, codes, perm, out, stream)
    assert call[-8:-4] == (1 if mode == "shard" else 4, n, int(mode in ("int8", "shard")), int(mode != "shard"))
    assert kernels.launches["dense_gram"] == 1


@pytest.mark.parametrize("bad,match", [
    (dict(int8=False, scale=torch.empty((48,), device="meta")), "column scales are for the int8 Gram"),
    (dict(rows=torch.empty((64, 2, 8, 6), dtype=torch.bfloat16, device="meta")), "rows: expected"),
    (dict(off=torch.empty((1,), dtype=torch.int32, device="meta"), diag=torch.empty((0, 6, 6), device="meta"),
          e_off=torch.empty((1,), dtype=torch.int32, device="meta")), "at least one node"),
    (dict(e_dst=torch.empty((30,), dtype=torch.int64, device="meta")), "not a multiple"),
], ids=["scales_for_bf16", "two_rows", "no_nodes", "edges_per_node"])
def test_dense_gram_wrapper_refuses(meta_lib, bad, match):
    """What kernel N does not take is refused before anything launches."""
    args = dict(_gram_args(8), int8=True)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        kernels.dense_gram(**args)
    assert meta_lib.calls == []


def test_dense_gram_wrapper_states_the_grid_limit(meta_lib, monkeypatch):
    """Where the library refuses kernel N's grid, the wrapper's error names
    the limit (n x ceil(n / tile) blocks below 2^31) and nothing launches."""
    def refuse(n, geom):
        meta_lib.calls.append(("df_gram_launch", (n,)))
        geom[2] = 128
        return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(meta_lib, "df_gram_launch", refuse, raising=False)
    with pytest.raises(ValueError, match=r"ceil\(n / 128\) blocks below 2\^31"):
        kernels.dense_gram(**_gram_args(8), int8=False)
    assert [c[0] for c in meta_lib.calls] == ["df_gram_launch"]
    assert kernels.launches["dense_gram"] == 0


# ---------------------------------------------------------------- kernel G's cluster launch, on the meta device


def _plan_lib(meta_lib, monkeypatch, clusters=1, shared=1):
    """The library's ``df_pcg_plan`` answering (cluster, smem, shared_p,
    clusters the card holds); the wrappers' plan cache emptied."""
    def plan(pcg, n, nrows, used, stride, shared_p, out):
        meta_lib.calls.append(("df_pcg_plan", (pcg, n, nrows, used, stride, shared_p)))
        out[0], out[1], out[2], out[3] = 16, 24 * n * shared, shared, clusters
        return 0

    monkeypatch.setattr(meta_lib, "df_pcg_plan", plan, raising=False)
    monkeypatch.setattr(kernels, "_PLANS", {})


@pytest.mark.parametrize("shared_p", [None, True, False])
def test_pcg_wrapper_launches_one_cluster(meta_lib, monkeypatch, shared_p):
    """Kernel G's PCG is one cluster launch: the wrapper hands the library
    the planned cluster size and p's place, and counts one launch."""
    _plan_lib(meta_lib, monkeypatch, shared=0 if shared_p is False else 1)
    n = 2048
    s = _factored_system("meta", n=n, npt=64, nrows=3)
    x = kernels.pcg(s, torch.empty((n, 6, 6), device="meta"), torch.empty(6 * n, device="meta"), 12, 1e-3,
                    torch.empty((), dtype=torch.bool, device="meta"), used=3, stride=4, shared_p=shared_p)
    assert x.shape == (6 * n,)
    assert [c[0] for c in meta_lib.calls] == ["df_pcg_plan", "df_pcg"]
    assert meta_lib.calls[0][1] == (1, n, 3, 3, 4, -1 if shared_p is None else int(shared_p))
    call = meta_lib.calls[1][1]
    # (.., np, n, kc, nrows, used, stride, shared_p, minv, b, iters, ...): the cluster's size is the library's
    assert call[12:19] == (64, n, 4, 3, 3, 4, 0 if shared_p is False else 1)
    assert kernels.launches["pcg"] == 1
    # the plan is asked once a shape
    kernels.pcg(s, torch.empty((n, 6, 6), device="meta"), torch.empty(6 * n, device="meta"), 12, 1e-3,
                torch.empty((), dtype=torch.bool, device="meta"), used=3, stride=4, shared_p=shared_p)
    assert [c[0] for c in meta_lib.calls] == ["df_pcg_plan", "df_pcg", "df_pcg"]


def test_pcg_wrapper_refuses_an_unschedulable_cluster(meta_lib, monkeypatch):
    """Where the card holds no such cluster the wrapper raises: there is no
    one-block or plain route behind it."""
    _plan_lib(meta_lib, monkeypatch, clusters=0)
    s = _factored_system("meta")
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        kernels.matvec(s, torch.empty(48, device="meta"))
    assert [c[0] for c in meta_lib.calls] == ["df_pcg_plan"]
    assert kernels.launches["matvec"] == 0


@pytest.mark.parametrize("field,dtype", [("knn_idx", torch.int64), ("e_dst", torch.int64), ("heavy", torch.int32)])
def test_factored_wrappers_take_the_prepared_types(meta_lib, monkeypatch, field, dtype):
    """The int32 ids and the int64 heavy-first order are built once a solve
    structure: a wrapper refuses the other type instead of converting."""
    _plan_lib(meta_lib, monkeypatch)
    good = _factored_system("meta")
    s = good._replace(**{field: getattr(good, field).to(dtype)})
    with pytest.raises(TypeError, match=field):
        kernels.matvec(s, torch.empty(48, device="meta"))
    assert meta_lib.calls == []


@pytest.mark.parametrize("field", ["knn_idx", "e_dst"])
def test_dense_gram_wrapper_takes_the_prepared_types(meta_lib, field):
    """Kernel N reads the int32 ids a solve structure carries: the wrapper
    refuses int64 ids instead of converting them on every call."""
    args = _gram_args(8)
    args[field] = args[field].to(torch.int64)
    with pytest.raises(TypeError, match=field):
        kernels.dense_gram(**args, int8=False)
    assert meta_lib.calls == []
    assert kernels.launches["dense_gram"] == 0


def test_cluster_plan_is_asked_once_a_device(meta_lib, monkeypatch):
    """Kernel G's cluster attributes and occupancy belong to a device: the
    plan is asked with that device current, once a (device, shape)."""
    _plan_lib(meta_lib, monkeypatch)
    current = []

    @contextlib.contextmanager
    def on(dev):
        current.append(dev)
        yield

    monkeypatch.setattr(kernels, "_on", on)
    devs = [torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cuda", 0)]
    plans = [kernels.cluster_plan(True, 64, 1, device=d) for d in devs]
    assert plans[0] == plans[2] and plans[0].cluster == 16
    assert [c[0] for c in meta_lib.calls] == ["df_pcg_plan", "df_pcg_plan"]
    assert current == devs[:2]
