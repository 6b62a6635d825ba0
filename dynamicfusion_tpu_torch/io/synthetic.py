"""Synthetic depth scenes with analytic ground truth (numpy copy of
``scene_depth`` and ``orbit_pose`` from ``dynamicfusion_tpu.io.synthetic``,
of ``bulge_depth``, and of ``bench.py``'s deforming, hinge and bulge
scenes). Depth maps are uint16
millimeters."""

from __future__ import annotations

import numpy as np

from dynamicfusion_tpu_torch.config import Intrinsics


def scene_depth(
    intr: Intrinsics,
    rows: int,
    cols: int,
    pose_c2w: np.ndarray | None = None,
    spheres=(),
    plane_z: float | None = None,
) -> np.ndarray:
    """Union of spheres plus an optional world plane z = plane_z, rendered
    analytically (exact z-depth) from a camera-to-world pose."""
    if pose_c2w is None:
        pose_c2w = np.eye(4)
    pose_c2w = np.asarray(pose_c2w, np.float64)
    r, pos = pose_c2w[:3, :3], pose_c2w[:3, 3]

    u, v = np.meshgrid(np.arange(cols, dtype=np.float64), np.arange(rows, dtype=np.float64))
    d_cam = np.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, np.ones_like(u)], -1)
    d_w = d_cam @ r.T  # unnormalized; depth = t for p = pos + t * d_w

    z = np.full((rows, cols), np.inf)
    for sp in spheres:
        c = np.asarray(sp["center"], np.float64) - pos
        a = np.sum(d_w * d_w, axis=-1)
        b = -2.0 * (d_w @ c)
        cc = float(c @ c) - sp["radius"] ** 2
        disc = b * b - 4 * a * cc
        t = np.where(disc >= 0, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a), np.inf)
        z = np.minimum(z, np.where(t > 0, t, np.inf))
    if plane_z is not None:
        t = (plane_z - pos[2]) / np.where(np.abs(d_w[..., 2]) > 1e-12, d_w[..., 2], 1e-12)
        z = np.minimum(z, np.where(t > 0, t, np.inf))
    z = np.where(np.isfinite(z), z, 0.0)
    return np.clip(z * 1000.0, 0, 65535).astype(np.uint16)


def orbit_pose(angle: float, target=(0.0, 0.0, 1.0), dist: float | None = None) -> np.ndarray:
    """Camera-to-world pose on a circle about the world y axis through
    ``target``, looking at it; angle 0 with dist = |target| is the identity."""
    tgt = np.asarray(target, np.float64)
    if dist is None:
        dist = float(np.linalg.norm(tgt))
    pos = tgt + dist * np.array([np.sin(angle), 0.0, -np.cos(angle)])
    fwd = tgt - pos
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])  # camera y points down (image v grows down)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up2, fwd, pos
    return m.astype(np.float32)


def deforming_frames(intr: Intrinsics, rows: int, cols: int, n: int) -> list:
    """``bench.py``'s deforming scene seen by a static camera: a large
    sphere and a small one over the plane z = 1.25, the small one
    oscillating by 8 mm (x = 0.2 + 0.008 sin(0.4 t))."""
    return [
        scene_depth(
            intr, rows, cols, plane_z=1.25,
            spheres=[dict(center=(0.0, 0.0, 0.95), radius=0.22),
                     dict(center=(0.2 + 0.008 * np.sin(0.4 * t), 0.1, 0.8), radius=0.1)],
        )
        for t in range(n)
    ]


HINGE = dict(h=(0.0, 0.0, 0.95), d=0.16, r=0.12)  # bench.py's HINGE


def hinge_centers(t: float):
    """``bench.py``'s scissor articulation: two spheres about the hinge h at
    angles theta and pi - theta from +x in the x/y plane, theta = 0.2
    sin(0.25 t); at t = 0 the spheres sit at h +- d along x."""
    th = 0.2 * np.sin(0.25 * t)
    h, d = np.asarray(HINGE["h"], np.float64), HINGE["d"]
    return h + d * np.array([np.cos(th), np.sin(th), 0.0]), h + d * np.array([-np.cos(th), np.sin(th), 0.0])


def hinge_frames(intr: Intrinsics, rows: int, cols: int, n: int) -> list:
    """``bench.py``'s articulated hold-out scene (the hinge) seen by a static
    camera: the two spheres of ``hinge_centers`` (radius 0.12) over the
    plane z = 1.3, frames t = 0 .. n - 1."""
    out = []
    for t in range(n):
        ca, cb = hinge_centers(t)
        out.append(scene_depth(
            intr, rows, cols, plane_z=1.3,
            spheres=[dict(center=tuple(ca), radius=HINGE["r"]), dict(center=tuple(cb), radius=HINGE["r"])],
        ))
    return out


def bulge_depth(
    intr: Intrinsics,
    rows: int,
    cols: int,
    t: float,
    plane_z: float = 1.1,
    amp: float = 0.08,
    sigma: float = 0.06,
    x0: float = -0.1,
    speed: float = 0.01,
) -> np.ndarray:
    """A plane at ``plane_z`` with a Gaussian bulge (height ``amp``, width
    ``sigma``) whose centre travels along x at ``speed`` m a frame; the
    heightfield is rendered by fixed-point iteration along each ray."""
    u, v = np.meshgrid(np.arange(cols, dtype=np.float64), np.arange(rows, dtype=np.float64))
    dx = (u - intr.cx) / intr.fx
    dy = (v - intr.cy) / intr.fy
    xc = x0 + speed * t

    def z_surf(x, y):
        return plane_z - amp * np.exp(-((x - xc) ** 2 + y * y) / (2.0 * sigma * sigma))

    z = np.full(dx.shape, plane_z)
    for _ in range(16):
        z = z_surf(z * dx, z * dy)
    return np.clip(z * 1000.0, 0, 65535).astype(np.uint16)


def bulge_frames(intr: Intrinsics, rows: int, cols: int, n: int) -> list:
    """``bench.py``'s travelling-wave hold-out scene (the bulge) seen by a
    static camera: ``bulge_depth`` at frames t = 0 .. n - 1."""
    return [bulge_depth(intr, rows, cols, t) for t in range(n)]
