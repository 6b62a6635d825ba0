"""Parity of the port's depth-variant ICP (``estimate_transform_depth``,
the reference's frame-to-frame ``USE_DEPTH`` path; plain PyTorch on the
CPU) with the JAX package's, on ``tests/test_icp.py``'s scene: a camera
moved by (4, -3, 5) mm. Both packages get the same depth and normal
pyramids (as numpy)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.io import synthetic
from dynamicfusion_tpu.solvers import icp as jicp
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.ops import preprocess as tpre
from dynamicfusion_tpu_torch.solvers import icp as ticp

JC = JCfg.small(dims=64, rows=120, cols=160)
TC = TCfg.small(dims=64, rows=120, cols=160)
SCENE = dict(
    spheres=[dict(center=(0.0, 0.0, 0.9), radius=0.2), dict(center=(0.25, 0.1, 1.0), radius=0.08)],
    plane_z=1.25,
)
DELTA = np.array([0.004, -0.003, 0.005])

TOL_T_M = 1e-4     # translation (m): ICP turns last-bit differences into ~1e-5 m
TOL_R = 1e-5       # rotation entries
TOL_TRUTH_M = 2e-3  # against the camera's motion, as tests/test_icp.py holds JAX
TOL_TRUTH_R = 5e-3


@functools.lru_cache(maxsize=None)
def _pyramids():
    """(curr, prev) of (depth pyramid, normal pyramid) as numpy, built by
    the port's plain path (held against JAX's in
    tests/test_torch_preprocess_icp.py), and the two depth frames."""
    pose1 = np.eye(4)
    pose1[:3, 3] = DELTA
    d_prev = synthetic.scene_depth(JC.intr, JC.rows, JC.cols, np.eye(4), **SCENE)
    d_curr = synthetic.scene_depth(JC.intr, JC.rows, JC.cols, pose1, **SCENE)
    out = []
    for d in (d_curr, d_prev):
        dp, _, nrm, _ = tpre.build_frame_pyramid(TC, torch.from_numpy(d))
        out.append(([a.numpy() for a in dp], [a.numpy() for a in nrm]))
    return out, (d_curr, d_prev)


def _torch(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_depth_icp():
    """JAX's estimate_transform_depth, jitted as tests/test_icp.py runs it."""
    return jax.jit(lambda a, b, c, d: jicp.estimate_transform_depth(JC, list(a), list(b), list(c), list(d)))


def _jax(cur, prev):
    return _jax_depth_icp()(*(tuple(jnp.asarray(x) for x in arrs) for arrs in (cur[0], cur[1], prev[0], prev[1])))


def test_depth_variant_matches_jax():
    (cur, prev), _ = _pyramids()
    jr = _jax(cur, prev)
    tr = ticp.estimate_transform_depth(TC, _torch(cur[0]), _torch(cur[1]), _torch(prev[0]), _torch(prev[1]))
    assert bool(jr.ok) and bool(tr.ok)
    jt, tt = np.asarray(jr.transform), tr.transform.numpy()
    assert np.abs(jt[:3, 3] - tt[:3, 3]).max() <= TOL_T_M
    assert np.abs(jt[:3, :3] - tt[:3, :3]).max() <= TOL_R
    # it tracked: the transform (current camera -> previous) is the motion
    np.testing.assert_allclose(tt[:3, 3], DELTA, atol=TOL_TRUTH_M)
    np.testing.assert_allclose(tt[:3, :3], np.eye(3), atol=TOL_TRUTH_R)


def test_empty_depth_flags_failure():
    """Frames without depth leave the 6x6 systems singular: both packages
    report failure and keep the identity."""
    zeros = [np.zeros((JC.rows >> l, JC.cols >> l), np.uint16) for l in range(JC.pyramid_levels)]
    nans = [np.full((JC.rows >> l, JC.cols >> l, 3), np.nan, np.float32) for l in range(JC.pyramid_levels)]
    jr = _jax((zeros, nans), (zeros, nans))
    tr = ticp.estimate_transform_depth(TC, _torch(zeros), _torch(nans), _torch(zeros), _torch(nans))
    assert not bool(jr.ok) and not bool(tr.ok)
    np.testing.assert_array_equal(tr.transform.numpy(), np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(np.asarray(jr.transform), np.eye(4), atol=1e-6)
