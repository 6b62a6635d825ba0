"""Kernel G's damped block inverse and kernel I's multi-map entry on the
CPU: their plain versions against the JAX package, and numpy
transcriptions of what the CUDA kernels index and add.

- The damped inverse (``warp_solver.spd6_inv_damped_plain``, one launch of
  ``csrc/pcg.cu``'s ``spd6_inv_nodes_kernel`` on the card): against JAX's
  ``spd6_inv`` of the same damped blocks within TOL_SPD6 (as
  ``tests/test_torch_warp_solver.py``), and bit for bit against the
  composition it replaces (``spd6_inv_plain(blocks + diag_embed(damp))``
  kept by ``where(rebuild, ., minv)``), with ``rebuild`` true and false;
  the kernel's flat-index damping (``a[e] = row[e] + (e % 7 == 0 ?
  damp : 0.0f)``) and its blocks of nodes transcribed.
- The multi-map entry (``preprocess.frame_maps``, one launch of
  ``csrc/preprocess.cu``'s ``frame_maps_kernel``): ``build_frame_pyramid``'s
  task sets (the preset's: level 0's confidence alone, levels 2 and 3, the
  raw stride-4 points; the rigid step's; ``reference_parity()``'s shift 0)
  bit-equal to per-level ``compute_points_normals``; level 0's confidence
  without its maps against JAX's within 1e-5; the kernel's grid (a
  block's task from prefix counts, a pixel a thread) and its reads of the
  strided depth transcribed, with the constants read from the sources.

Small shapes, numpy-made inputs; about 15 s on one process.
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.io import synthetic
from dynamicfusion_tpu.ops import preprocess as jpre
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch import kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.ops import preprocess as tpre
from dynamicfusion_tpu_torch.solvers import warp_solver as ts
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL_SPD6 = 1e-4   # spd6_inv on well-conditioned blocks, relative (tests/test_torch_warp_solver.py)
TOL_CONF = 1e-5   # the incidence confidence (test_frame_pyramid_with_confidence_matches)
CSRC = Path(kernels.CSRC)
N = 100           # nodes: the kernel's blocks of 16, the last one short

_spd6_jax = jax.jit(js.spd6_inv)


def _const(src: str, name: str) -> int:
    m = re.findall(rf"constexpr int {name} = (\d+);", (CSRC / src).read_text())
    assert len(m) == 1, name
    return int(m[0])


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------- the damped inverse


def _damped_inputs(n=N, seed=0):
    """Well-conditioned SPD blocks (with signed zeros off the diagonal, which
    the +0.0 of the damping turns positive), the damping terms as
    ``_damping_from_diag`` makes them, and a lambda."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n, 6, 6).astype(np.float32)
    m = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)).astype(np.float32)
    m[:, 0, 3] = m[:, 3, 0] = -0.0
    active = torch.from_numpy(rng.rand(n) > 0.1)
    blocks = torch.from_numpy(m)
    diag_eff, unit = ts._damping_from_diag(0.05, active, torch.diagonal(blocks, dim1=-2, dim2=-1).reshape(-1))
    return blocks, diag_eff, unit


@pytest.mark.parametrize("lam", [1e-4, 1.0, 8.0])
def test_damped_inverse_matches_jax(lam):
    blocks, diag_eff, unit = _damped_inputs()
    lm = torch.tensor(lam, dtype=torch.float32)
    minv = torch.empty((N, 6, 6))
    damp = ts.spd6_inv_damped(blocks, diag_eff, unit, lm, torch.tensor(True), minv)
    damped = blocks.numpy() + np.einsum("ni,ij->nij", damp.reshape(N, 6).numpy(), np.eye(6, dtype=np.float32))
    ref = np.asarray(_spd6_jax(jnp.asarray(damped)))
    assert np.abs(minv.numpy() - ref).max() / np.abs(ref).max() <= TOL_SPD6
    exact = np.linalg.inv(damped.astype(np.float64))
    assert np.abs(minv.numpy() - exact).max() / np.abs(exact).max() <= TOL_SPD6


@pytest.mark.parametrize("rebuild", [True, False])
def test_damped_inverse_is_the_composition(rebuild):
    """Bit for bit the glue it replaces: damp = lambda * diag_eff + unit, the
    inverse of blocks + diag_embed(damp), kept by the rebuild flag."""
    blocks, diag_eff, unit = _damped_inputs(seed=1)
    lm = torch.tensor(0.37, dtype=torch.float32)
    last = torch.from_numpy(np.random.RandomState(2).randn(N, 6, 6).astype(np.float32))
    flag = torch.tensor(rebuild)
    minv = last.clone()
    damp = ts.spd6_inv_damped(blocks, diag_eff, unit, lm, flag, minv)
    ref_damp = lm * diag_eff + unit
    fresh = ts.spd6_inv_plain(blocks + torch.diag_embed(ref_damp.reshape(N, 6)))
    assert _same(damp, ref_damp)
    assert _same(minv, torch.where(flag, fresh, last))
    assert _same(minv, fresh if rebuild else last)


def test_damped_inverse_keeps_its_result_across_iterations():
    """Three LM iterations as the solve runs them, one minv allocated
    before the loop: rebuilt at iteration 0 and after a rejected step, kept
    after an accepted one, each time equal to the composition's."""
    blocks, diag_eff, unit = _damped_inputs(seed=3)
    minv, ref = torch.empty((N, 6, 6)), None
    lam = torch.tensor(1e-4, dtype=torch.float32)
    for rebuild in (True, False, True):
        flag = torch.tensor(rebuild)
        damp = ts.spd6_inv_damped(blocks, diag_eff, unit, lam, flag, minv)
        fresh = ts.spd6_inv_plain(blocks + torch.diag_embed((lam * diag_eff + unit).reshape(N, 6)))
        ref = fresh if ref is None else torch.where(flag, fresh, ref)
        assert _same(minv, ref) and _same(damp, lam * diag_eff + unit)
        lam = lam * 8.0 if rebuild else lam * 0.5


def test_damped_kernel_transcription():
    """The damped kernel's blocks (kSpdNodes nodes, a thread each, the last
    block short) cover every node once, and its flat-index damping (a[e] =
    m[e] + (e % 7 == 0 ? d[e / 7] : 0.0f)) adds damp on the diagonal and
    +0.0 off it: bit-equal to blocks + diag_embed(damp), the signed zeros
    turned as torch turns them."""
    nodes = _const("pcg.cu", "kSpdNodes")
    blocks, diag_eff, unit = _damped_inputs()
    damp = (torch.tensor(0.5) * diag_eff + unit).reshape(N, 6).numpy()
    m = blocks.numpy().reshape(N, 36)
    seen = np.zeros(N, np.int64)
    a = np.full((N, 36), np.nan, np.float32)
    e = np.arange(36)
    for b in range((N + nodes - 1) // nodes):
        for t in range(nodes):
            i = b * nodes + t
            if i >= N:
                continue
            seen[i] += 1
            a[i] = m[i] + np.where(e % 7 == 0, damp[i, np.minimum(e // 7, 5)], np.float32(0.0)).astype(np.float32)
    assert (seen == 1).all()
    a = a.reshape(N, 6, 6)
    ref = (blocks + torch.diag_embed(torch.from_numpy(damp))).numpy()
    assert np.array_equal(a.view(np.int32), ref.view(np.int32))
    assert (np.signbit(blocks.numpy()[:, 0, 3]).all() and not np.signbit(a[:, 0, 3]).any())


# ---------------------------------------------------------------- the frame's maps

KW = dict(max_nodes=64, node_sample_step=17)
JC = dataclasses.replace(JCfg.small(dims=64, rows=120, cols=160), **KW)
TC = dataclasses.replace(TCfg.small(dims=64, rows=120, cols=160), **KW)
SCENE = dict(spheres=[dict(center=(0.0, 0.0, 0.9), radius=0.2), dict(center=(0.25, 0.15, 1.0), radius=0.12)],
             plane_z=1.2)


@functools.lru_cache(maxsize=None)
def _depth(seed=0):
    """A noisy 160x120 frame with holes, rendered once (both packages read
    the same array)."""
    d = synthetic.scene_depth(JC.intr, JC.rows, JC.cols, synthetic.orbit_pose(0.02, target=(0.0, 0.0, 0.9)), **SCENE)
    rng = np.random.RandomState(seed)
    d = np.where(d > 0, d.astype(np.int32) + rng.randint(-6, 7, d.shape), 0)
    return np.where(rng.rand(*d.shape) < 0.02, 0, d).astype(np.uint16)


def _random_depth(rows, cols, seed):
    rng = np.random.RandomState(seed)
    return np.where(rng.rand(rows, cols) < 0.1, 0, rng.randint(400, 3000, (rows, cols))).astype(np.uint16)


def _same_map(a, b) -> bool:
    return a is not None and b is not None and _same(a, b)


# (first_point_level, with_conf, level0_maps, raw stride): the preset's
# non-rigid frame, its rigid step, reference_parity()'s shift 0
TASK_SETS = {"preset": (2, True, False, 4), "rigid": (2, False, True, None), "shift0": (0, False, True, None)}


@pytest.mark.parametrize("name", sorted(TASK_SETS))
def test_frame_pyramid_maps_are_the_per_level_maps(name):
    fpl, conf, level0, raw_stride = TASK_SETS[name]
    depth = torch.from_numpy(_depth())
    raw = None if raw_stride is None else (TC.intr.level(fpl), raw_stride)
    out = tpre.build_frame_pyramid(TC, depth, first_point_level=fpl, with_conf=conf, level0_maps=level0, raw=raw)
    dpyr, pts, nrm = out[:3]
    for lvl, d in enumerate(dpyr):
        if lvl < fpl or (lvl == 0 and not level0):
            assert pts[lvl] is None and nrm[lvl] is None
            continue
        p, n = tpre.compute_points_normals(TC.intr.level(lvl), d)
        assert _same_map(pts[lvl], p) and _same_map(nrm[lvl], n), lvl
    if conf:
        p, n = tpre.compute_points_normals(TC.intr, dpyr[0])
        assert _same_map(out[4], tpre.incidence_confidence(p, n))
    if raw is not None:
        p, _ = tpre.compute_points_normals(raw[0], depth, stride=raw_stride)
        assert _same_map(out[-1], p)
        assert len(out) == 4 + conf + 1


def test_frame_maps_plain_returns_what_a_task_asks():
    depth = torch.from_numpy(_depth(1))
    tasks = [tpre.MapTask(depth, TC.intr, 1, points=False, normals=False, conf=True),
             tpre.MapTask(depth, TC.intr.level(2), 4, points=True, normals=False),
             tpre.MapTask(depth, TC.intr, 1, points=False, normals=True)]
    outs = tpre.frame_maps(tasks)
    p, n = tpre.compute_points_normals(TC.intr, depth)
    assert outs[0][0] is None and outs[0][1] is None and _same_map(outs[0][2], tpre.incidence_confidence(p, n))
    assert _same_map(outs[1][0], tpre.compute_points_normals(TC.intr.level(2), depth, 4)[0])
    assert outs[1][1] is None and outs[1][2] is None
    assert outs[2][0] is None and _same_map(outs[2][1], n) and outs[2][2] is None


_jax_maps = jax.jit(lambda d: jpre.compute_points_normals(JC.intr, d))


@pytest.mark.parametrize("truncate", [0.0, 1.05])
def test_level0_confidence_without_its_maps_matches_jax(truncate):
    """What ``track`` asks for where tracking starts at level 2: level 0's
    confidence alone (its maps None), against JAX's confidence
    (kinfu.py:633-635) of JAX's maps of the same filtered level-0 depth
    (the filter is held against JAX's in test_torch_preprocess_icp.py)."""
    d = _depth(2)
    tc = dataclasses.replace(TC, icp_truncate_depth_dist=truncate)
    td, tp, tn, _, tconf = tpre.build_frame_pyramid(tc, torch.from_numpy(d), first_point_level=2, with_conf=True,
                                                    level0_maps=False)
    assert tp[0] is None and tn[0] is None and tp[1] is None
    assert tp[2] is not None and tp[3] is not None
    if truncate:
        assert (td[0].numpy() == 0).mean() > (d == 0).mean()
    jp, jn = _jax_maps(jnp.asarray(td[0].numpy()))
    pn = jp / jnp.maximum(jnp.linalg.norm(jp, axis=-1, keepdims=True), 1e-9)
    jconf = np.asarray(jnp.nan_to_num(jnp.abs(jnp.sum(jn * pn, axis=-1))))
    assert (jconf > 0.5).mean() > 0.1
    np.testing.assert_allclose(jconf, tconf.numpy(), atol=TOL_CONF, rtol=0)


def _grid(shapes, threads):
    """(task, pixel) of every thread of the launch, as the kernel finds
    them: a block's task from the tasks' prefix counts of blocks, a pixel a
    thread."""
    per = [(h * w + threads - 1) // threads for h, w in shapes]
    first = np.concatenate([[0], np.cumsum(per)[:-1]]).astype(np.int64)
    task = np.searchsorted(first, np.arange(int(sum(per))), side="right") - 1
    blocks = np.arange(int(sum(per)))
    # the kernel's linear search: the last task whose first block is <= b
    for b in (0, int(sum(per)) - 1):
        ti = 0
        while ti + 1 < len(shapes) and b >= first[ti + 1]:
            ti += 1
        assert ti == task[b]
    pix = ((blocks - first[task])[:, None] * threads + np.arange(threads)[None, :]).reshape(-1)
    return np.repeat(task, threads), pix


@pytest.mark.parametrize("name", ["preset", "quality_raw1", "depth_icp", "odd_widths"])
def test_frame_maps_grid_and_loads_transcription(name):
    """Every pixel of every task is one thread's, exactly once; and each
    thread's depths, read as the kernel reads them (``depth_m``: row y *
    stride of a src_cols-wide image, column x * stride, 0 past the strided
    image's edge), are depth[::stride, ::stride][y, x], [y, x + 1] and
    [y + 1, x]; the constants read from the sources."""
    threads, cap = _const("preprocess.cu", "kMapThreads"), _const("preprocess.cu", "kMapTasks")
    assert cap == kernels.MAP_TASKS
    full = _depth(3)
    pyr = [full]
    for _ in range(3):
        pyr.append(tpre.depth_pyramid_down(torch.from_numpy(pyr[-1])).numpy())
    sets = {
        "preset": [(pyr[0], 1), (pyr[2], 1), (pyr[3], 1), (full, 4)],
        "quality_raw1": [(pyr[0], 1), (full, 1), (full, 2)],
        "depth_icp": [(p, 1) for p in pyr] * 2,
        "odd_widths": [(_random_depth(37, 53, 4), 1), (_random_depth(37, 53, 4), 3), (_random_depth(8, 6, 5), 1),
                       (_random_depth(8, 6, 5), 5), (_random_depth(9, 12, 6), 1)],
    }
    tasks = sets[name]
    assert len(tasks) <= cap
    shapes = [((img.shape[0] + s - 1) // s, (img.shape[1] + s - 1) // s) for img, s in tasks]
    task, pix = _grid(shapes, threads)
    for ti, ((img, s), (h, w)) in enumerate(zip(tasks, shapes)):
        mine = pix[(task == ti) & (pix < h * w)]
        assert np.array_equal(np.sort(mine), np.arange(h * w))
        y, x = np.divmod(mine, w)
        flat, cols = img.reshape(-1), img.shape[1]

        def depth_m(yy, xx):
            ok = (yy < h) & (xx < w)
            at = np.where(ok, yy * s * cols + xx * s, 0)
            return np.where(ok, flat[at].astype(np.float32) * np.float32(0.001), np.float32(0.0))

        ref = np.zeros((h + 1, w + 1), np.float32)
        ref[:h, :w] = img[::s, ::s].astype(np.float32) * np.float32(0.001)
        for got, want in ((depth_m(y, x), ref[y, x]), (depth_m(y, x + 1), ref[y, x + 1]),
                          (depth_m(y + 1, x), ref[y + 1, x])):
            assert np.array_equal(got, want)


def test_map_task_struct_is_the_kernels():
    """The wrapper's ctypes layout of a task is csrc/preprocess.cu's
    MapTaskArgs: four pointers, four floats, four ints."""
    src = (CSRC / "preprocess.cu").read_text()
    body = src[src.index("struct MapTaskArgs {"):]
    body = body[:body.index("};")]
    names = re.findall(r"(\w+)[,;]", body)
    assert names == [f[0] for f in kernels._MapTaskArgs._fields_]
    assert kernels.ctypes.sizeof(kernels._MapTaskArgs) == 64


class _FakeLib:
    """Records the library's frame-map calls; every launch succeeds and
    reports one device kernel."""

    def __init__(self):
        self.calls = []

    def df_frame_maps(self, tasks, n, ran, stream):
        self.calls.append([(t.h, t.w, t.stride, t.src_cols) for t in tasks[:n]])
        ran._obj.value = 1
        return 0


def test_frame_maps_wrapper_packs_tasks(monkeypatch):
    """On the meta device: one launch for up to MAP_TASKS tasks (the depth
    ICP's eight), another for more; the outputs a task asks for only."""
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "_check", lambda t, name, dtype, shape=None: None)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 0)
    monkeypatch.setattr(kernels, "launches", dict(kernels.launches))
    monkeypatch.setattr(kernels, "device_kernels", dict(kernels.device_kernels))
    meta = torch.empty((120, 160), dtype=torch.uint16, device="meta")
    tasks = [kernels.MapTask(meta, TC.intr, 1, points=True, normals=False),
             kernels.MapTask(meta, TC.intr, 4, points=False, normals=False, conf=True)] * 5
    outs = kernels.frame_maps(tasks)
    assert [len(c) for c in lib.calls] == [8, 2]
    assert lib.calls[0][:2] == [(120, 160, 1, 160), (30, 40, 4, 160)] and lib.calls[1] == lib.calls[0][:2]
    assert tuple(outs[0][0].shape) == (120, 160, 3) and outs[0][1] is None and outs[0][2] is None
    assert outs[1][0] is None and tuple(outs[1][2].shape) == (30, 40)
    assert kernels.launches["frame_maps"] == 2 and kernels.device_kernels["frame_maps"] == 2
    with pytest.raises(ValueError, match="asks for no map"):
        kernels.frame_maps([kernels.MapTask(meta, TC.intr, 1, points=False, normals=False)])
