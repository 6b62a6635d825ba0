"""The frame pipeline (port of ``dynamicfusion_tpu.pipeline.kinfu``).

A non-rigid frame is preprocess -> coarse-to-fine ICP -> rigid
pre-alignment -> warp-field solve -> the shared coarse KNN+DQB field ->
non-rigid brick fusion (gated on ICP health and the fusion interval) ->
node insertion with its lifecycle -> model raycast in a temporal march
band, the tracking maps warped into the live frame. ``cfg.rigid_only`` is
plain KinectFusion: track, rigid fusion, raycast. Every stage stays on the
device: the ICP health flag gates fusion, insertion and the warp update as
device tensors, and no step of the frame reads a value back to the host.
The volume is updated in place.

``plain=True`` runs the plain PyTorch version of every kernel on the same
device (the reference the kernels are held against); by default CUDA
tensors go through the kernels and CPU tensors through the plain path.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dynamicfusion_tpu_torch import device as device_mod, kernels
from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.core import se3
from dynamicfusion_tpu_torch.models import volume as volume_model
from dynamicfusion_tpu_torch.models import warpfield
from dynamicfusion_tpu_torch.models.volume import TsdfVolume
from dynamicfusion_tpu_torch.models.warpfield import WarpField
from dynamicfusion_tpu_torch.ops import fusion, preprocess, tsdf as tsdf_ops
from dynamicfusion_tpu_torch.solvers import icp, warp_solver

INF = float("inf")


class PipelineState(NamedTuple):
    vol: TsdfVolume
    warp: WarpField
    pose: torch.Tensor                     # (4, 4) camera-to-world
    prev_points: Tuple[torch.Tensor, ...]  # tracking pyramid, camera frame
    prev_normals: Tuple[torch.Tensor, ...]
    can_points: torch.Tensor               # model map at the raycast resolution
    can_normals: torch.Tensor
    frame_idx: torch.Tensor                # () int32


class StepOutputs(NamedTuple):
    icp_ok: torch.Tensor
    pose: torch.Tensor
    solver_cost0: torch.Tensor  # () the warp solve's robust cost before ...
    solver_cost1: torch.Tensor  # ... and after its LM iterations (0 in rigid mode)
    node_count: torch.Tensor
    brick_counts: torch.Tensor  # (3,) int32 (band, wide, dropped)
    model_points: torch.Tensor
    model_normals: torch.Tensor


def _vol_pose(cfg: DynamicFusionConfig, device) -> torch.Tensor:
    m = se3.identity(device)
    m[:3, 3] = volume_model.origin(cfg, device)
    return m


def _pyramid_from_maps(cfg: DynamicFusionConfig, pts0, nrm0, plain: bool = False):
    pts, nrm = [pts0], [nrm0]
    for _ in range(1, cfg.track_levels):
        p, n = preprocess.resize_points_normals(pts[-1], nrm[-1], plain=plain)
        pts.append(p)
        nrm.append(n)
    return tuple(pts), tuple(nrm)


def _use_coarse_band(cfg: DynamicFusionConfig, rows_t: int, cols_t: int) -> bool:
    """The coarse-to-fine raycast prepass only runs on a coarse grid of at
    least 2048 rays: off at the presets' 160x120 model maps, on at
    ``reference_parity()``'s 640x480."""
    f = cfg.raycast_coarse_factor
    return f > 1 and (rows_t // f) * (cols_t // f) >= 2048


def _min_pool5(x: torch.Tensor) -> torch.Tensor:
    """5x5 window minimum, SAME size, +inf outside the image."""
    return -F.max_pool2d(-x[None, None], 5, 1, padding=2)[0, 0]


def _max_pool5(x: torch.Tensor) -> torch.Tensor:
    """5x5 window maximum, SAME size, -inf outside the image."""
    return F.max_pool2d(x[None, None], 5, 1, padding=2)[0, 0]


def _raycast_seed(cfg: DynamicFusionConfig, dists: torch.Tensor) -> Optional[torch.Tensor]:
    """Expected surface distance per tracking ray from the live dists map
    (holes filled with the 5x5 positive minimum); None when seeding is off."""
    if cfg.raycast_seed_margin <= 0.0:
        return None
    s = cfg.raycast_subsample
    d = dists[::s, ::s]
    near = _min_pool5(torch.where(d > 0, d, INF))
    return torch.where(d > 0, d, torch.where(torch.isfinite(near), near, 0.0))


def _temporal_band(cfg: DynamicFusionConfig, prev_can_points: torch.Tensor, dists: torch.Tensor):
    """Per-pixel march band [min - m, max + m] over a 5x5 window of the
    previous model map's ray distances united with the live dists."""
    s = cfg.raycast_subsample
    p = prev_can_points
    # |p| summed in kernel J's order
    t_prev = torch.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2])
    live = dists[::s, ::s]
    miss = torch.isnan(t_prev)
    lo_src = torch.minimum(torch.where(miss, INF, t_prev), torch.where(live > 0, live, INF))
    hi_src = torch.maximum(torch.where(miss, -INF, t_prev), torch.where(live > 0, live, -INF))
    lo = _min_pool5(lo_src)
    hi = _max_pool5(hi_src)
    m = cfg.raycast_band_margin
    any_hit = torch.isfinite(lo)
    lo = torch.where(any_hit, torch.clamp(lo - m, min=0.0), 0.0)
    hi = torch.where(any_hit, hi + m, 0.0)
    return lo, hi


def _march_bands(cfg: DynamicFusionConfig, prev_can_points: Optional[torch.Tensor], dists: torch.Tensor,
                 plain: bool = False):
    """(raycast seed | None, temporal band (lo, hi) | None) of a frame: the
    band needs ``prev_can_points`` and ``raycast_temporal_band``, the seed
    ``raycast_seed_margin`` > 0. Kernel J computes both in one launch on
    CUDA tensors; CPU tensors (or ``plain``) take ``_raycast_seed`` and
    ``_temporal_band``."""
    want_band = cfg.raycast_temporal_band and prev_can_points is not None
    want_seed = cfg.raycast_seed_margin > 0.0
    if not (want_band or want_seed):
        return None, None
    if plain or dists.device.type == "cpu":
        band = _temporal_band(cfg, prev_can_points, dists) if want_band else None
        return _raycast_seed(cfg, dists), band
    return kernels.march_bands(
        dists, cfg.raycast_subsample, prev_can_points.contiguous() if want_band else None,
        cfg.raycast_band_margin, want_seed,
    )


def _raycast_model(
    cfg: DynamicFusionConfig,
    vol: TsdfVolume,
    pose: torch.Tensor,
    t_seed: Optional[torch.Tensor],
    t_band: Optional[Tuple[torch.Tensor, torch.Tensor]],
    plain: bool,
    raycast_fn=None,
) -> tsdf_ops.RaycastResult:
    """The canonical model raycast at ``pose`` at 1/raycast_subsample
    resolution, in ``t_band`` where given, else in the coarse band where
    ``_use_coarse_band``, else seeded by ``t_seed`` (or the full ray);
    through ``raycast_fn`` (``tsdf.raycast``'s signature) where given."""
    cam2vol = se3.compose(se3.inverse(_vol_pose(cfg, pose.device)), pose)
    rows_t = cfg.rows // cfg.raycast_subsample
    cols_t = cfg.cols // cfg.raycast_subsample
    intr_t = cfg.intr.level(cfg.raycast_shift)
    if t_band is None and _use_coarse_band(cfg, rows_t, cols_t):
        t_band = tsdf_ops.raycast_coarse_band(cfg, vol, cam2vol, intr_t, rows_t, cols_t, plain=plain)
    return (raycast_fn or tsdf_ops.raycast)(
        cfg, vol, cam2vol, intr_t, rows_t, cols_t, t_seed=t_seed, t_band=t_band, plain=plain
    )


def _model_maps(
    cfg: DynamicFusionConfig,
    vol: TsdfVolume,
    pose: torch.Tensor,
    warp: Optional[WarpField] = None,
    t_seed: Optional[torch.Tensor] = None,
    t_band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    dq_grid: Optional[torch.Tensor] = None,
    plain: bool = False,
    raycast_fn=None,
):
    """Raycast the model at ``pose`` at 1/raycast_subsample resolution;
    return (tracking pyramid, canonical base-level maps). In non-rigid
    mode (``track_against_warped``) the tracking maps are the canonical
    maps DQB-warped into the live frame: through the coarse field's
    ``dq_grid`` (trilinear, kernel E) where given, else by the exact
    per-point warp."""
    res = _raycast_model(cfg, vol, pose, t_seed, t_band, plain, raycast_fn)
    if cfg.track_against_warped and not cfg.rigid_only:
        shape = res.points.shape
        pts_w = se3.transform_points(pose, res.points).reshape(-1, 3)
        nrm_w = se3.rotate_dirs(pose, res.normals).reshape(-1, 3)
        if dq_grid is not None:
            wp, wn = fusion.warp_points_trilinear(cfg, dq_grid, pts_w, nrm_w, plain=plain)
        else:
            wp, wn = warpfield.warp_points(warp, pts_w, nrm_w, k=cfg.knn_k, plain=plain)
        w2c = se3.inverse(pose)
        track_pts = se3.transform_points(w2c, wp).reshape(shape)
        track_nrm = se3.rotate_dirs(w2c, wn).reshape(shape)
    else:
        track_pts, track_nrm = res.points, res.normals
    return _pyramid_from_maps(cfg, track_pts, track_nrm, plain), res.points, res.normals


# the aperture gate's constants (kernel M takes them from here)
GATE_BINS = 16            # depth bins of the gate's window over [0.3, 1.9) m
GATE_Z_LO, GATE_Z_HI = 0.3, 1.9
GATE_BIN_W = (GATE_Z_HI - GATE_Z_LO) / GATE_BINS
GATE_CHANNELS = 11        # [S, xx, yy, zz, xy, xz, yz, bx, by, bz, bb]
GATE_REG = 1e-3           # ridge of the 3x3 second moment, per sample
GATE_MIN_FILL = 0.15      # share of the window's pixels a gate needs


def gate_bins(cam_z: torch.Tensor) -> torch.Tensor:
    """(H, W) int64 depth bin of each pixel of the aperture gate:
    floor((z - 0.3) / 0.1) clipped to [0, 15], NaN depth in bin 0. The
    width divides as a tensor (CUDA PyTorch would multiply by the
    reciprocal of a Python scalar, and one ulp moves a plane on a bin
    edge into the next bin)."""
    bw = torch.tensor(GATE_BIN_W, dtype=torch.float32, device=cam_z.device)
    z = torch.nan_to_num(cam_z, nan=-1.0)
    return torch.clamp(torch.floor((z - GATE_Z_LO) / bw), 0, GATE_BINS - 1).to(torch.int64)


def _box_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """Separable (w x w) box SUM over the leading two axes of (H, W, C),
    SAME size with zeros outside: along W first, then along H, each window
    summed tap by tap from zero in image order (kernel M's order, so the
    two sum alike bit for bit)."""
    lo = (w - 1) // 2
    hi = w - 1 - lo
    rows, cols = x.shape[:2]
    xp = F.pad(x, (0, 0, lo, hi))
    acc = torch.zeros_like(x)
    for k in range(w):
        acc = acc + xp[:, k:k + cols]
    xp = F.pad(acc, (0, 0, 0, 0, lo, hi))
    acc = torch.zeros_like(x)
    for k in range(w):
        acc = acc + xp[k:k + rows]
    return acc


def _p2p_gate_plain(
    cfg: DynamicFusionConfig,
    live_pts_w: torch.Tensor,
    live_nrm_w: torch.Tensor,
    prev_model_w: torch.Tensor,
    cam_z: torch.Tensor,
) -> torch.Tensor:
    """The plain version of kernel M: the adaptive aperture gate (see
    ``p2p_gate``). The features are scattered one-hot over the depth bins
    and box-summed per (bin, channel) with ``_box_sum``; each pixel then
    sums its own bin and the two beside it."""
    w = cfg.solver_p2p_gate_window
    dev = cam_z.device
    rows, cols = cam_z.shape
    delta = live_pts_w - prev_model_w
    n = live_nrm_w
    valid = torch.isfinite(delta).all(-1) & torch.isfinite(n).all(-1)
    nz = torch.where(valid[..., None], torch.nan_to_num(n), 0.0)
    b = torch.where(valid, tsdf_ops._dot3(nz, torch.nan_to_num(delta)), 0.0)
    nx, ny, nzz = nz[..., 0], nz[..., 1], nz[..., 2]
    feats = torch.stack(
        [valid.to(torch.float32), nx * nx, ny * ny, nzz * nzz, nx * ny, nx * nzz, ny * nzz,
         nx * b, ny * b, nzz * b, b * b], dim=-1,
    )
    zb = gate_bins(cam_z)
    oh = F.one_hot(zb, GATE_BINS).to(torch.float32) * valid[..., None]
    fb = (feats[..., None, :] * oh[..., :, None]).reshape(rows, cols, GATE_BINS * GATE_CHANNELS)
    sb = _box_sum(fb, w).reshape(rows, cols, GATE_BINS, GATE_CHANNELS)

    def gather(i):
        ok = (i >= 0) & (i < GATE_BINS)
        idx = i.clamp(0, GATE_BINS - 1)[..., None, None].expand(rows, cols, 1, GATE_CHANNELS)
        return torch.gather(sb, 2, idx)[..., 0, :] * ok[..., None]

    s = gather(zb - 1) + gather(zb) + gather(zb + 1)
    cnt = s[..., 0]
    g1, g2, g3 = s[..., 7], s[..., 8], s[..., 9]
    bb = s[..., 10]
    cnt1 = torch.clamp(cnt, min=1.0)

    # the regularised 3x3 second moment: closed-form det and adjugate solve
    reg = GATE_REG * cnt1
    a11, a22, a33 = s[..., 1] + reg, s[..., 2] + reg, s[..., 3] + reg
    a12, a13, a23 = s[..., 4], s[..., 5], s[..., 6]
    c11 = a22 * a33 - a23 * a23
    c12 = a13 * a23 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    c22 = a11 * a33 - a13 * a13
    c23 = a12 * a13 - a11 * a23
    c33 = a11 * a22 - a12 * a12
    det_r = a11 * c11 + a12 * c12 + a13 * c13
    inv_det = 1.0 / torch.clamp(det_r, min=1e-30)
    t1 = (c11 * g1 + c12 * g2 + c13 * g3) * inv_det
    t2 = (c12 * g1 + c22 * g2 + c23 * g3) * inv_det
    t3 = (c13 * g1 + c23 * g2 + c33 * g3) * inv_det
    expl = (t1 * g1 + t2 * g2 + t3 * g3) / torch.clamp(bb, min=1e-12)

    # conditioning: the det of the unregularised second moment per sample
    b11, b22, b33 = s[..., 1], s[..., 2], s[..., 3]
    cond = (
        b11 * (b22 * b33 - a23 * a23)
        + a12 * (a13 * a23 - a12 * b33)
        + a13 * (a12 * a23 - a13 * b22)
    ) / (cnt1 * cnt1 * cnt1)

    def const(v):  # a divisor as a tensor: CUDA PyTorch multiplies by a Python scalar's reciprocal
        return torch.tensor(v, dtype=torch.float32, device=dev)

    gate_cond = torch.clamp(cond / const(cfg.solver_p2p_gate_cond), 0.0, 1.0)
    f0 = cfg.solver_p2p_gate_fit
    gate_fit = torch.clamp((expl - f0) / const(max(1.0 - f0, 1e-6)), 0.0, 1.0)
    enough = cnt > GATE_MIN_FILL * (w * w)
    gate = torch.clamp(cfg.solver_p2p_gate_gain * gate_cond * gate_fit, 0.0, 1.0)
    return torch.where(enough, gate, 0.0)


def p2p_gate(
    cfg: DynamicFusionConfig,
    live_pts_w: torch.Tensor,    # (Ht, Wt, 3) live surface, world frame
    live_nrm_w: torch.Tensor,    # (Ht, Wt, 3) live normals, world frame
    prev_model_w: torch.Tensor,  # (Ht, Wt, 3) previous warped model map, world frame
    cam_z: torch.Tensor,         # (Ht, Wt) live camera-frame depth (NaN where none)
    plain: bool = False,
) -> torch.Tensor:
    """The adaptive aperture gate of the tangential data term: a per-pixel
    weight in [0, 1] from a windowed translation fit of the apparent motion
    b = n . (live - previous model). Over a (w x w) window restricted to
    the pixel's depth bin and the two beside it, the normal second moment
    N = sum n nᵀ says whether the window's geometry observes a 3-dof
    translation (its normalised det, high on curved patches, ~0 on flat
    ones) and the best-fit translation's share of the b-energy says whether
    the motion is coherent; gate = clip(gain clip(det / cond0)
    clip((explained - fit0) / (1 - fit0))), 0 where the window holds fewer
    than 0.15 w² samples. Kernel M (``csrc/p2p_gate.cu``) on CUDA tensors,
    ``_p2p_gate_plain`` on CPU tensors or where the caller asks."""
    if plain or cam_z.device.type == "cpu":
        return _p2p_gate_plain(cfg, live_pts_w, live_nrm_w, prev_model_w, cam_z)
    return p2p_gate_kernel(cfg, live_pts_w, live_nrm_w, prev_model_w, cam_z)[0]


def p2p_gate_kernel(cfg: DynamicFusionConfig, live_pts_w, live_nrm_w, prev_model_w, cam_z):
    """Kernel M on CUDA tensors with the gate's constants: (gate, depth
    bins as int32)."""
    w = cfg.solver_p2p_gate_window
    return kernels.p2p_gate(
        live_pts_w.contiguous(), live_nrm_w.contiguous(), prev_model_w.contiguous(), cam_z.contiguous(),
        w, cfg.solver_p2p_gate_cond, cfg.solver_p2p_gate_fit, cfg.solver_p2p_gate_gain,
        GATE_Z_LO, GATE_BIN_W, GATE_BINS, GATE_CHANNELS, GATE_REG, GATE_MIN_FILL * (w * w),
    )


def init_state(cfg: DynamicFusionConfig, device="cuda") -> PipelineState:
    dev = device_mod.resolve(device)
    shift = cfg.raycast_shift

    def zero_maps():
        return tuple(
            torch.full((cfg.rows >> (lvl + shift), cfg.cols >> (lvl + shift), 3), float("nan"), device=dev)
            for lvl in range(cfg.track_levels)
        )

    return PipelineState(
        vol=volume_model.create(cfg, dev),
        warp=warpfield.create(cfg, dev),
        pose=se3.identity(dev),
        prev_points=zero_maps(),
        prev_normals=zero_maps(),
        can_points=zero_maps()[0],
        can_normals=zero_maps()[0],
        frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
    )


def first_frame(
    cfg: DynamicFusionConfig, state: PipelineState, depth_mm: torch.Tensor, plain: bool = False
) -> PipelineState:
    """Frame 0: integrate, sample warp nodes from the extracted surface,
    raycast the model."""
    dists = preprocess.compute_dists(cfg.intr, depth_mm, plain=plain)
    vol2cam = se3.compose(se3.inverse(state.pose), _vol_pose(cfg, dists.device))
    tsdf_ops.integrate(cfg, state.vol, dists, vol2cam, cfg.intr, plain=plain)
    # min_weight=1: after one integrate every observed voxel weighs exactly 1
    cloud = tsdf_ops.extract_cloud(
        cfg, state.vol, max_points=max(cfg.max_nodes * cfg.node_sample_step, 1 << 20), min_weight=1.0, plain=plain
    )
    warp = warpfield.init_from_cloud(cfg, cloud.points, cloud.valid, plain=plain)
    seed, _ = _march_bands(cfg, None, dists, plain)
    (prev_pts, prev_nrm), can_pts, can_nrm = _model_maps(cfg, state.vol, state.pose, warp, t_seed=seed, plain=plain)
    return PipelineState(
        vol=state.vol, warp=warp, pose=state.pose,
        prev_points=prev_pts, prev_normals=prev_nrm,
        can_points=can_pts, can_normals=can_nrm,
        frame_idx=state.frame_idx + 1,
    )


def step(
    cfg: DynamicFusionConfig, state: PipelineState, depth_mm: torch.Tensor, plain: bool = False,
    warp_system_fn=None, warp_eval_fn=None, integrate_fn=None, warp_solve_fn=None, raycast_fn=None,
) -> Tuple[PipelineState, StepOutputs]:
    """One frame: the rigid KinectFusion step under ``cfg.rigid_only``,
    else the full DynamicFusion step (``_nonrigid_step``).

    The sharded step's hooks (``parallel.sharded.make_sharded_step``; JAX
    ``kinfu.py:395-420``): ``warp_system_fn`` and ``warp_eval_fn`` the warp
    solve's assembly and candidate evaluation (``warp_solver.solve``'s
    ``system_fn``, ``eval_fn``); ``integrate_fn(cfg, vol, cf, dists,
    world2cam, intr, enabled, conf, phase, plain) -> (vol, counts)`` the
    non-rigid fusion, gated by ``enabled`` inside; ``warp_solve_fn(field,
    inputs) -> (field, stats)`` the whole solve (before the other two);
    ``raycast_fn`` the model raycasts (``tsdf.raycast``'s signature). With
    none given the step is the single-device one."""
    if not cfg.rigid_only:
        return _nonrigid_step(cfg, state, depth_mm, plain, warp_system_fn, warp_eval_fn, integrate_fn,
                              warp_solve_fn, raycast_fn)
    shift = cfg.raycast_shift
    _, pts_pyr, nrm_pyr, dists = preprocess.build_frame_pyramid(
        cfg, depth_mm, first_point_level=shift, plain=plain
    )
    icp_res = icp.estimate_transform(
        cfg, list(pts_pyr[shift:]), list(nrm_pyr[shift:]),
        list(state.prev_points), list(state.prev_normals),
        level_offset=shift, plain=plain,
    )
    pose = torch.where(icp_res.ok, se3.compose(state.pose, icp_res.transform), state.pose)

    vol2cam = se3.compose(se3.inverse(pose), _vol_pose(cfg, pose.device))
    bcounts = tsdf_ops.integrate(cfg, state.vol, dists, vol2cam, cfg.intr, ok=icp_res.ok, plain=plain)
    seed, band = _march_bands(cfg, state.can_points, dists, plain)
    (prev_pts, prev_nrm), can_pts, can_nrm = _model_maps(
        cfg, state.vol, pose, t_seed=seed, t_band=band, plain=plain, raycast_fn=raycast_fn
    )
    new_state = PipelineState(
        vol=state.vol, warp=state.warp, pose=pose,
        prev_points=prev_pts, prev_normals=prev_nrm,
        can_points=can_pts, can_normals=can_nrm,
        frame_idx=state.frame_idx + 1,
    )
    zero = torch.zeros((), device=pose.device)
    outputs = StepOutputs(
        icp_ok=icp_res.ok, pose=pose, solver_cost0=zero, solver_cost1=zero,
        node_count=state.warp.count, brick_counts=bcounts,
        model_points=prev_pts[0], model_normals=prev_nrm[0],
    )
    return new_state, outputs


class Tracked(NamedTuple):
    icp_res: icp.IcpResult
    pose: torch.Tensor                    # (4, 4) after ICP and the rigid pre-alignment
    inputs: warp_solver.WarpSolveInputs   # the warp solve's point sets, pre-aligned
    points: Tuple[torch.Tensor, ...]      # the live pyramid
    normals: Tuple[torch.Tensor, ...]
    dists: torch.Tensor
    conf: Optional[torch.Tensor]          # level-0 incidence confidence (with fusion_incidence_weight)
    bands: Tuple                          # (raycast seed | None, temporal band | None) of the frame


def track(
    cfg: DynamicFusionConfig, state: PipelineState, depth_mm: torch.Tensor, plain: bool = False, raycast_fn=None
) -> Tracked:
    """The non-rigid step up to the warp solve: preprocess, coarse-to-fine
    ICP against the warped model maps, the solve's point sets and the
    rigid pre-alignment folded into the pose (where ICP succeeded);
    ``raycast_fn`` the fresh canonical raycast's hook."""
    shift = cfg.raycast_shift
    # level 0 only for the incidence confidence of the fusion
    pyr = preprocess.build_frame_pyramid(
        cfg, depth_mm, first_point_level=shift, plain=plain, with_conf=cfg.fusion_incidence_weight
    )
    _, pts_pyr, nrm_pyr, dists = pyr[:4]
    conf = pyr[4] if cfg.fusion_incidence_weight else None

    icp_res = icp.estimate_transform(
        cfg, list(pts_pyr[shift:]), list(nrm_pyr[shift:]),
        list(state.prev_points), list(state.prev_normals),
        level_offset=shift, plain=plain,
    )
    pose = torch.where(icp_res.ok, se3.compose(state.pose, icp_res.transform), state.pose)

    # the solve's point sets, world frame, every stride-th pixel of the
    # model maps: the previous frame's canonical raycast (at the old pose;
    # with reuse_model_raycast=False a fresh one at the new pose) and the
    # live surface, its points from the RAW depth (what fusion
    # integrates), its normals filtered
    stride = max(1, cfg.solver_point_stride // cfg.raycast_subsample)
    seed, band = _march_bands(cfg, state.can_points, dists, plain)
    if cfg.reuse_model_raycast:
        can_pts_w = se3.transform_points(state.pose, state.can_points)
        can_nrm_w = se3.rotate_dirs(state.pose, state.can_normals)
    else:
        # a fresh canonical raycast from the ICP pose, in the temporal band
        # where it is on, else in the coarse band where that runs
        model = _raycast_model(cfg, state.vol, pose, seed, band, plain, raycast_fn)
        can_pts_w = se3.transform_points(pose, model.points)
        can_nrm_w = se3.rotate_dirs(pose, model.normals)
    if cfg.solver_live_raw:
        raw_pts, _ = preprocess.compute_points_normals(
            cfg.intr.level(shift), depth_mm, stride=cfg.raycast_subsample, plain=plain
        )
    else:
        raw_pts = pts_pyr[shift]
    live_pts_w = se3.transform_points(pose, raw_pts)
    live_nrm_w = se3.rotate_dirs(pose, nrm_pyr[shift])

    def flat(a):
        return a[::stride, ::stride].reshape(-1, 3)

    # the tangential term's per-point gate: ones (None) unless
    # solver_p2p_adaptive, then the aperture gate against the previous
    # warped model map (the field's live-surface prediction, pixel-
    # associated like ICP) from the FILTERED live surface at the ICP pose
    gate = None
    if cfg.solver_p2p_weight > 0.0 and cfg.solver_p2p_adaptive:
        prev_model_w = se3.transform_points(state.pose, state.prev_points[0])
        gmap = p2p_gate(
            cfg, se3.transform_points(pose, pts_pyr[shift]), live_nrm_w, prev_model_w, pts_pyr[shift][..., 2],
            plain=plain,
        )
        gate = gmap[::stride, ::stride].reshape(-1, 1)
    inputs = warp_solver.WarpSolveInputs(
        p_can=flat(can_pts_w), n_can=flat(can_nrm_w), p_live=flat(live_pts_w), n_live=flat(live_nrm_w),
        p2p_gate=gate,
    )
    if cfg.solver_rigid_prealign:
        t_pre = warp_solver.rigid_prealign(cfg, state.warp, inputs, plain=plain)
        pose = torch.where(icp_res.ok, se3.compose(t_pre, pose), pose)
        inputs = inputs._replace(
            p_live=se3.transform_points(t_pre, inputs.p_live), n_live=se3.rotate_dirs(t_pre, inputs.n_live)
        )
    return Tracked(icp_res, pose, inputs, tuple(pts_pyr), tuple(nrm_pyr), dists, conf, (seed, band))


def _nonrigid_step(
    cfg: DynamicFusionConfig, state: PipelineState, depth_mm: torch.Tensor, plain: bool = False,
    warp_system_fn=None, warp_eval_fn=None, integrate_fn=None, warp_solve_fn=None, raycast_fn=None,
) -> Tuple[PipelineState, StepOutputs]:
    """One DynamicFusion frame (the JAX package's non-rigid ``step``)."""
    icp_res, pose, inputs, _, _, dists, conf, (seed, band) = track(cfg, state, depth_mm, plain, raycast_fn)
    if warp_solve_fn is not None:
        warp, stats = warp_solve_fn(state.warp, inputs)
    else:
        warp, stats = warp_solver.solve(
            cfg, state.warp, inputs, plain=plain, system_fn=warp_system_fn, eval_fn=warp_eval_fn
        )
    if cfg.solver_remove_net_rigid:
        # the optional gauge anchor: the net rigid part of the solve's
        # increment is left to ICP
        warp = warpfield.remove_net_rigid(state.warp, warp, alpha=cfg.solver_net_rigid_alpha, plain=plain)
    # a frame whose tracking failed leaves the warp field (and, below, the
    # volume and the node set) untouched
    warp = WarpField(*(torch.where(icp_res.ok, a, b) for a, b in zip(warp, state.warp)))

    full_scale = inputs.p_can.shape[0] > 8192
    cf = fusion.coarse_field(cfg, warp, plain=plain)

    sub_interval = max(cfg.fusion_interval // cfg.fusion_phase_split, 1)
    fuse_now = icp_res.ok & (state.frame_idx % sub_interval == 0)
    phase = (state.frame_idx // sub_interval) % cfg.fusion_phase_split
    if integrate_fn is not None:
        vol, bcounts = integrate_fn(
            cfg, state.vol, cf, dists, se3.inverse(pose), cfg.intr, fuse_now, conf=conf, phase=phase, plain=plain
        )
    else:
        vol = state.vol
        bcounts = fusion.integrate_nonrigid(
            cfg, vol, cf, dists, se3.inverse(pose), cfg.intr, fuse_now, conf=conf, phase=phase, plain=plain
        )

    ins = cfg.node_insert_stride if full_scale else 1
    cand = inputs.p_can[::ins]
    warp = warpfield.insert_nodes(
        cfg, warp, cand, icp_res.ok & ~torch.isnan(cand[:, 0]), state.frame_idx, plain=plain
    )

    (prev_pts, prev_nrm), can_pts, can_nrm = _model_maps(
        cfg, vol, pose, warp, t_seed=seed, t_band=band, dq_grid=cf.dq if full_scale else None, plain=plain,
        raycast_fn=raycast_fn,
    )
    new_state = PipelineState(
        vol=vol, warp=warp, pose=pose,
        prev_points=prev_pts, prev_normals=prev_nrm,
        can_points=can_pts, can_normals=can_nrm,
        frame_idx=state.frame_idx + 1,
    )
    outputs = StepOutputs(
        icp_ok=icp_res.ok, pose=pose, solver_cost0=stats.initial_cost, solver_cost1=stats.final_cost,
        node_count=warp.count, brick_counts=bcounts,
        model_points=prev_pts[0], model_normals=prev_nrm[0],
    )
    return new_state, outputs


class DynamicFusion:
    """Host-side driver: owns the state and runs one frame per call.

    Rigid mode pins the secant refine, as the JAX driver does (the Newton
    refines carry a grazing-incidence bias that breaks rigid tracking)."""

    def __init__(self, cfg: DynamicFusionConfig, device="cuda", plain: bool = False):
        if cfg.rigid_only and cfg.raycast_refine in ("newton8", "newton16"):
            cfg = dataclasses.replace(cfg, raycast_refine="secant")
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.plain = plain
        self._state = init_state(cfg, self.device)
        self.last_outputs: StepOutputs | None = None
        self._started = False
        self.poses = [torch.eye(4, device=self.device)]

    @property
    def state(self) -> PipelineState:
        return self._state

    @state.setter
    def state(self, s: PipelineState):
        """Adopt a state; the first-frame flag follows its frame_idx (one
        host read, outside the frame loop)."""
        self._state = s
        self._started = int(s.frame_idx) > 0
        self.last_outputs = None

    def __call__(self, depth_mm, block: bool = True) -> bool:
        """Process one uint16 mm depth frame. With ``block=False`` the call
        only enqueues the work and returns True; read ``last_ok`` to sync."""
        depth = torch.as_tensor(depth_mm)
        if depth.device.type == "cpu" and self.device.type == "cuda":
            # from pinned memory the upload does not wait for the device
            depth = depth.pin_memory().to(self.device, non_blocking=True)
        else:
            depth = depth.to(self.device)
        if depth.dtype != torch.uint16:
            raise TypeError(f"depth must be uint16 mm, got {depth.dtype}")
        if not self._started:
            self._state = first_frame(self.cfg, self._state, depth, plain=self.plain)
            self._started = True
            return False
        self._state, self.last_outputs = step(self.cfg, self._state, depth, plain=self.plain)
        self.poses.append(self.last_outputs.pose)
        return self.last_ok if block else True

    def restore(self, state: PipelineState):
        self.state = state

    @property
    def last_ok(self) -> bool:
        return bool(self.last_outputs.icp_ok) if self.last_outputs is not None else False

    def reset(self):
        self._state = init_state(self.cfg, self.device)
        self._started = False
        self.last_outputs = None
        self.poses = [torch.eye(4, device=self.device)]

    def get_pose(self, time: int = -1) -> torch.Tensor:
        """Camera pose at frame ``time`` (out of range -> latest)."""
        if not (-len(self.poses) <= time < len(self.poses)):
            time = -1
        return self.poses[time]

    def extract_mesh(self, live: bool = False):
        """Triangle mesh (``io.export.Mesh``, numpy) of the canonical surface
        by marching tetrahedra over the TSDF zero crossing, on the host.
        With ``live=True`` the vertices and normals are warped by the
        current field into the live frame (kernel E at the vertex count)."""
        from dynamicfusion_tpu_torch.io import export as export_mod

        mesh = export_mod.extract_mesh(self.cfg, self.state.vol)
        if live and len(mesh.vertices):
            v, n = warpfield.warp_points(
                self.state.warp,
                torch.from_numpy(mesh.vertices).to(self.device),
                torch.from_numpy(mesh.normals).to(self.device),
                k=self.cfg.knn_k,
                plain=self.plain,
            )
            mesh = mesh._replace(vertices=v.cpu().numpy(), normals=n.cpu().numpy())
        return mesh

    def save_mesh(self, path: str, live: bool = False):
        """Extract and write the surface mesh (.ply binary or .obj)."""
        from dynamicfusion_tpu_torch.io import export as export_mod

        export_mod.save_mesh(path, self.extract_mesh(live=live))

    def save_cloud(self, path: str):
        """Write the canonical surface's zero-crossing cloud (kernel L at
        1 << 20 rows) as a PLY."""
        from dynamicfusion_tpu_torch.io import export as export_mod

        cloud = tsdf_ops.extract_cloud(self.cfg, self.state.vol, max_points=1 << 20, plain=self.plain)
        export_mod.save_ply(path, cloud.points.cpu().numpy())

    def render(self, mode: int = 0, pose=None) -> torch.Tensor:
        """An (H, W, 3) uint8 image on ``self.device`` (mode 0 Phong, 2
        normal colours, 3 both side by side, (H, 2W, 3)): from the last
        model maps, pixel-replicated to the frame size, or with ``pose``
        (camera-to-world (4, 4)) from a fresh full-resolution raycast of the
        volume from that viewpoint, which marches every ray with no band
        (kernel C)."""
        from dynamicfusion_tpu_torch.pipeline import render as render_mod

        if pose is None:
            return render_mod.render_state(self.cfg, self.state, mode)
        cfg = self.cfg
        pose = torch.as_tensor(pose, dtype=torch.float32).to(self.device)
        cam2vol = se3.compose(se3.inverse(_vol_pose(cfg, self.device)), pose)
        res = tsdf_ops.raycast(cfg, self.state.vol, cam2vol, cfg.intr, cfg.rows, cfg.cols, plain=self.plain)
        return render_mod.render_maps(cfg, res.points, res.normals, mode)
