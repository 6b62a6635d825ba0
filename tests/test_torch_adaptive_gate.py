"""The port's adaptive aperture gate (``solver_p2p_adaptive=True``) against
the JAX package, on the CPU.

The gate itself (``kinfu._p2p_gate`` / the port's ``_p2p_gate_plain``) on
the three synthetic motion fields of tests/test_pipeline.py's
``test_p2p_gate_discrimination`` (a translating sphere, a travelling wave
on a sheet, a noisy static sheet), on a random seeded field, and on gate
inputs that both packages build from one rendered frame of the hinge and
the bulge scenes (bench.py's articulated and travelling-wave hold-outs) at
the full model-map resolution (160x120): the depth bins equal JAX's on
every pixel, the gate within TOL_GATE of JAX's on all but TOL_GATE_FRAC of
the pixels whose window energy bb is above its floor (the explained
fraction divides by bb, so on a window of rounding-noise motion a last bit
can move the gate anywhere in [0, 1]; those pixels are counted and only
held to [0, 1]), and the discrimination the JAX test asserts.

Then ``small()`` with the slice's settings, ``solver_p2p_weight=0.25`` and
``solver_p2p_adaptive=True`` over the hinge scene, held as
tests/test_torch_quality_slice.py holds the gate-off term: the gate of the
port's own tracking against JAX's gate of the same inputs, one LM solve
with that gate, the port's step from JAX's state and its free-running pose.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)
from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import se3 as jse3
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu.ops import preprocess as jpre
from dynamicfusion_tpu.pipeline import kinfu as jkinfu
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch import interop
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.io import synthetic as tsynthetic
from dynamicfusion_tpu_torch.ops import preprocess as tpre
from dynamicfusion_tpu_torch.pipeline import kinfu as tkinfu
from dynamicfusion_tpu_torch.solvers import warp_solver as ts

ADAPTIVE = dict(solver_p2p_weight=0.25, solver_p2p_adaptive=True)
JC, TC = (dataclasses.replace(c, **ADAPTIVE) for c in cases.configs())
STEPS = 3

# the gate against JAX's: the sums are float32 sums of up to 3 x 41 x 41
# terms in another order (relative differences ~1e-6); the ratios and
# clips keep that near 1e-6 where the window's motion energy is real
TOL_GATE = 1e-4
TOL_GATE_FRAC = 1e-3  # of the pixels with bb above BB_FLOOR
BB_FLOOR = 1e-9       # m^2: below it the window's b is rounding noise
SPREAD = 4.0          # final cost: within this many times JAX's own spread
# the port's step from JAX's state: the gate keeps the tangential rows near
# zero on this scene at small(), so the solve's initial cost is its point-
# to-plane part (~5e-3, a quarter of the gate-off term's), and the
# pre-aligned pose's last bits (1e-7 m) move it by up to ~5e-5 relative
# (~2e-7 absolute, as with the gate off; the preset's own point-to-plane
# cost on this scene moves by 2e-5). The gate-off tests hold 1e-5 on
# larger costs; this is chip_smoke.py's TOL_STEP_COST0_REL.
TOL_COST0_HINGE = 1e-4


def _jax_bins(cam_z):
    """The depth bins of JAX's _p2p_gate."""
    z = jnp.nan_to_num(jnp.asarray(cam_z), nan=-1.0)
    return np.asarray(jnp.clip(jnp.floor((z - 0.3) / ((1.9 - 0.3) / 16)).astype(jnp.int32), 0, 15))


def _gates(jcfg, tcfg, live, nrm, prev, cam_z):
    """(JAX gate, port gate, JAX bins, port bins, bb) of the same inputs."""
    arrs = [np.ascontiguousarray(a, np.float32) for a in (live, nrm, prev, cam_z)]
    jg = np.asarray(jkinfu._p2p_gate(jcfg, *map(jnp.asarray, arrs)))
    tg = tkinfu._p2p_gate_plain(tcfg, *map(torch.from_numpy, arrs)).numpy()
    jb = _jax_bins(arrs[3])
    tb = tkinfu.gate_bins(torch.from_numpy(arrs[3])).numpy()
    # each pixel's window energy bb (the plain version's own sums)
    d = np.nan_to_num(arrs[0] - arrs[2])
    n = np.nan_to_num(arrs[1])
    valid = np.isfinite(arrs[0] - arrs[2]).all(-1) & np.isfinite(arrs[1]).all(-1)
    b = np.where(valid, (n * d).sum(-1), 0.0).astype(np.float32)
    oh = (tb[..., None] == np.arange(16)) * valid[..., None]
    sb = tkinfu._box_sum(torch.from_numpy((b * b)[..., None] * oh.astype(np.float32)),
                         tcfg.solver_p2p_gate_window).numpy()
    idx = np.arange(16)
    near = np.abs(tb[..., None] - idx) <= 1
    bb = (sb * near).sum(-1)
    return jg, tg, jb, tb, bb


def _check_gate(jg, tg, jb, tb, bb):
    assert jg.shape == tg.shape and tg.dtype == np.float32
    np.testing.assert_array_equal(jb, tb)  # the depth bins, bit for bit
    assert ((tg >= 0) & (tg <= 1)).all()
    real = bb > BB_FLOOR
    far = np.abs(jg - tg) > TOL_GATE
    assert (far & real).sum() <= TOL_GATE_FRAC * max(real.sum(), 1), (int((far & real).sum()), int(real.sum()))
    return int((far & ~real).sum())


def _fields():
    """tests/test_pipeline.py's three fields at 120x160 and a random one:
    name -> (live, normals, previous, depth)."""
    cfg = JCfg.default_dynamicfusion()
    h, w = 120, 160
    f = cfg.intr.fx / 4
    u, v = np.meshgrid(np.arange(w) - 80.0, np.arange(h) - 60.0)
    out = {}
    r, z0 = 0.12, 0.9
    x, y = u * z0 / f, v * z0 / f
    rr2 = x * x + y * y
    on = rr2 < (r * 0.95) ** 2
    zs = z0 - np.sqrt(np.maximum(r * r - rr2, 1e-9))
    pts = np.stack([x, y, np.where(on, zs, 1.3)], -1)
    n = np.where(on[..., None], np.stack([x / r, y / r, (zs - z0) / r], -1), np.array([0.0, 0.0, -1.0]))
    out["sphere"] = (pts + np.where(on[..., None], np.array([0.005, 0.0, 0.0]), 0.0), n, pts, pts[..., 2])
    lam, a = 0.3, 0.015
    x, y = u / f, v / f
    zs = 1.0 + a * np.sin(2 * np.pi * y / lam)
    gy = a * 2 * np.pi / lam * np.cos(2 * np.pi * y / lam)
    nrm = np.stack([np.zeros_like(gy), -gy, -np.ones_like(gy)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pts = np.stack([x, y, zs], -1)
    out["wave"] = (pts + np.array([0.0, 0.012, 0.0]), nrm, pts, pts[..., 2])
    rng = np.random.RandomState(0)
    delta = np.stack([np.zeros((h, w)), np.zeros((h, w)), rng.normal(0, 0.002, (h, w))], -1)
    pz = np.stack([x, y, np.full((h, w), 1.1)], -1)
    out["noise"] = (pz + delta, np.broadcast_to(np.array([0.0, 0.0, -1.0]), pz.shape), pz, pz[..., 2])
    # random: depths over every bin (and past both ends), random unit
    # normals and motions, holes in the depth, the normals and the model
    rng = np.random.RandomState(7)
    z = rng.uniform(0.1, 2.2, (h, w))
    z[rng.rand(h, w) < 0.05] = np.nan
    prev = np.stack([x * z, y * z, z], -1)
    nrm = rng.randn(h, w, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[rng.rand(h, w) < 0.03] = np.nan
    live = prev + rng.normal(0, 0.004, (h, w, 3))
    prev = prev.copy()
    prev[rng.rand(h, w) < 0.03] = np.nan
    out["random"] = (live, nrm, prev, live[..., 2])
    return out


FIELDS = _fields()


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_gate_on_synthetic_fields_matches_jax(name):
    cfg_j, cfg_t = JCfg.default_dynamicfusion(), TCfg.default_dynamicfusion()
    jg, tg, jb, tb, bb = _gates(cfg_j, cfg_t, *FIELDS[name])
    _check_gate(jg, tg, jb, tb, bb)
    # the discrimination tests/test_pipeline.py asserts of JAX's gate
    if name == "sphere":
        ridx = int(0.12 * 0.8 * (cfg_t.intr.fx / 4) / 0.9)
        assert tg[60 - ridx:60 + ridx, 80 - ridx:80 + ridx].mean() > 0.6
    elif name == "wave":
        assert tg[40:80, 50:110].mean() < 0.1
    elif name == "noise":
        assert tg[40:80, 50:110].mean() < 0.05
    else:
        assert (jb == 0).any() and (jb == 15).any() and len(np.unique(jb)) == 16


@functools.lru_cache(maxsize=1)
def _jax_pyramid():
    jc = JCfg.quality_dynamicfusion()
    return jax.jit(lambda d: jpre.build_frame_pyramid(jc, d))


def _jax_live(depth):
    """JAX's filtered points and normals at the model-map level."""
    _, p, n, _ = _jax_pyramid()(jnp.asarray(depth))
    s = JCfg.quality_dynamicfusion().raycast_shift
    return np.asarray(p[s]), np.asarray(n[s])


@pytest.mark.parametrize("scene", ["hinge", "bulge"])
def test_gate_on_scene_frames_matches_jax(scene):
    """Frame 3's filtered live surface against frame 0's as the previous
    model, at the preset's model-map resolution, each package building its
    own inputs from the same rendered depth; a camera 2 cm off the origin
    makes the world frame differ from the camera frame."""
    tc = TCfg.quality_dynamicfusion()
    jc = JCfg.quality_dynamicfusion()
    frames = (tsynthetic.hinge_frames if scene == "hinge" else tsynthetic.bulge_frames)(tc.intr, tc.rows, tc.cols, 4)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.02, -0.01, 0.0)
    s = tc.raycast_shift
    t_live = [tpre.build_frame_pyramid(tc, torch.from_numpy(frames[i]), first_point_level=s) for i in (0, 3)]
    (tp0, tn3), tp3 = (t_live[0][1][s], t_live[1][2][s]), t_live[1][1][s]
    j0, j3 = _jax_live(frames[0]), _jax_live(frames[3])
    # the port's and JAX's preprocessing agree (tests/test_torch_preprocess_icp.py);
    # the gate of each package runs on its own maps
    jp = jnp.asarray(pose)
    j_in = (jse3.transform_points(jp, jnp.asarray(j3[0])), jse3.rotate_dirs(jp, jnp.asarray(j3[1])),
            jse3.transform_points(jp, jnp.asarray(j0[0])), jnp.asarray(j3[0][..., 2]))
    tpose = torch.from_numpy(pose)
    t_in = (tkinfu.se3.transform_points(tpose, tp3), tkinfu.se3.rotate_dirs(tpose, tn3),
            tkinfu.se3.transform_points(tpose, tp0), tp3[..., 2])
    jg = np.asarray(jkinfu._p2p_gate(jc, *j_in))
    tg = tkinfu._p2p_gate_plain(tc, *t_in).numpy()
    assert tg.shape == (tc.rows >> s, tc.cols >> s)
    # the same gate from JAX's maps run through the port
    _, tg_j, jb, tb, bb = _gates(jc, tc, *(np.asarray(a) for a in j_in))
    _check_gate(jg, tg_j, jb, tb, bb)
    # and from the port's own maps: the bins of the filtered depth, and the gate
    np.testing.assert_array_equal(tkinfu.gate_bins(t_in[3]).numpy(), jb)
    real = bb > BB_FLOOR
    assert (np.abs(jg - tg) > TOL_GATE)[real].mean() <= 10 * TOL_GATE_FRAC
    assert tg.max() > 0.5  # the scene's moving part opens the gate


def test_gate_bins_on_bin_edges():
    """Depths on the bin edges (the planes z = 1.3 and 1.1 of the hinge and
    bulge scenes among them) fall in JAX's bin."""
    z = np.float32(np.arange(0, 2000) / 1000.0)
    z = np.concatenate([z, np.nextafter(z, np.float32(3)), np.nextafter(z, np.float32(-1)), [np.nan, np.inf]])
    z = z.astype(np.float32).reshape(1, -1)
    np.testing.assert_array_equal(tkinfu.gate_bins(torch.from_numpy(z)).numpy(), _jax_bins(z))


# --------------------------------------------------------------------------
# the adaptive-gate configuration at small() over the hinge scene
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def depths():
    return tsynthetic.hinge_frames(TC.intr, TC.rows, TC.cols, STEPS + 1)


@pytest.fixture(scope="module")
def jax_frames(depths):
    return cases.jax_run(JC, depths)


@pytest.fixture(scope="module")
def port_frames(depths):
    return cases.port_run(TC, depths)


@pytest.fixture(scope="module")
def spread(depths, jax_frames):
    return cases.jax_spread(JC, depths, jax_frames)


@pytest.fixture(scope="module")
def solve_case(jax_frames, depths):
    """Frame 2 tracked by the port from JAX's state after frame 1: JAX's
    field, the port's field, the solve's point sets with the gate."""
    st = interop.state_from_numpy(jax_frames[1][0], "cpu")
    tr = tkinfu.track(TC, st, torch.from_numpy(depths[2]))
    assert bool(tr.icp_res.ok)
    assert tr.inputs.p2p_gate is not None and tuple(tr.inputs.p2p_gate.shape) == (tr.inputs.p_can.shape[0], 1)
    arrs = [a.numpy().copy() for a in tr.inputs]
    jfield = jw.WarpField(*(jnp.asarray(a) for a in jax_frames[1][0].warp))
    return jfield, st.warp, arrs, st, tr


def test_tracked_gate_matches_jax(solve_case, depths):
    """The gate ``track`` computes equals JAX's ``_p2p_gate`` of the same
    maps (the previous warped model map at the old pose, the filtered live
    surface at the ICP pose), subsampled at the solve's stride."""
    _, _, arrs, st, tr = solve_case
    s = TC.raycast_shift
    _, pts, nrm, _ = tpre.build_frame_pyramid(TC, torch.from_numpy(depths[2]), first_point_level=s)
    pose = torch.where(tr.icp_res.ok, tkinfu.se3.compose(st.pose, tr.icp_res.transform), st.pose)
    inp = (tkinfu.se3.transform_points(pose, pts[s]), tkinfu.se3.rotate_dirs(pose, nrm[s]),
           tkinfu.se3.transform_points(st.pose, st.prev_points[0]), pts[s][..., 2])
    jg, tg, jb, tb, bb = _gates(JC, TC, *(a.numpy() for a in inp))
    _check_gate(jg, tg, jb, tb, bb)
    stride = max(1, TC.solver_point_stride // TC.raycast_subsample)
    np.testing.assert_array_equal(arrs[4][:, 0], tg[::stride, ::stride].reshape(-1))
    assert 0.0 < float(tg.mean()) < 1.0


def test_adaptive_solve_matches_jax(solve_case):
    jfield, tfield, arrs, _, _ = solve_case
    ji = js.WarpSolveInputs(*(jnp.asarray(a) for a in arrs))
    ti = ts.WarpSolveInputs(*(torch.from_numpy(a) for a in arrs))
    solve = jax.jit(lambda f, i: js.solve(JC, f, i))
    _, jst = solve(jfield, ji)
    rng = np.random.RandomState(5)
    costs = []
    for _ in range(3):
        pert = ji._replace(p_live=ji.p_live * (1.0 + jnp.asarray(rng.randn(*arrs[2].shape).astype(np.float32)) * 1e-7))
        costs.append(float(solve(jfield, pert)[1].final_cost))
    _, tst = ts.solve(TC, tfield, ti)
    c0, c1 = float(jst.initial_cost), float(jst.final_cost)
    assert abs(float(tst.initial_cost) - c0) <= 1e-5 * c0
    assert float(tst.final_cost) <= float(tst.initial_cost)
    spread_c = max(abs(c - c1) for c in costs)
    assert abs(float(tst.final_cost) - c1) <= SPREAD * spread_c + 1e-3 * c1


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_adaptive_step_from_jax_state_matches(jax_frames, depths, frame):
    cases.check_step_from_jax_state(JC, TC, jax_frames, depths, frame, tol_cost0=TOL_COST0_HINGE)


@pytest.mark.parametrize("frame", range(1, STEPS + 1))
def test_adaptive_free_running_matches_jax(jax_frames, port_frames, spread, frame):
    cases.check_free_running(jax_frames, port_frames, frame, spread)


def test_adaptive_is_the_quality_preset_option():
    """The option is ported: the solver takes it, and with the term off it
    changes nothing, as in the JAX package."""
    ts._check_cfg(dataclasses.replace(TCfg.quality_dynamicfusion(), solver_p2p_adaptive=True))
    ts._check_cfg(dataclasses.replace(TCfg.default_dynamicfusion(), solver_p2p_adaptive=True))
