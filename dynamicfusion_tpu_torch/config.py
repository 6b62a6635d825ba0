"""Pipeline configuration (a copy of ``dynamicfusion_tpu.config``).

The port keeps its own copy so that it imports nothing of the JAX
package. Field names, types and defaults are identical to the JAX
package's (``tests/test_torch_config.py`` holds the two field by field for
every preset); the JAX file carries the measured rationale behind each
default. All distances are meters, angles radians, image sizes pixels;
depth input is uint16 millimeters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """Pinhole intrinsics; ``level(l)`` divides all four by ``2**l``."""

    fx: float
    fy: float
    cx: float
    cy: float

    def level(self, level_index: int) -> "Intrinsics":
        div = float(1 << level_index)
        return Intrinsics(self.fx / div, self.fy / div, self.cx / div, self.cy / div)


@dataclasses.dataclass(frozen=True)
class DynamicFusionConfig:
    """All pipeline knobs, defaulting to the dynamicfusion preset."""

    # frame geometry
    rows: int = 480
    cols: int = 640
    intr: Intrinsics = Intrinsics(570.342, 570.342, 320.0, 240.0)

    # TSDF volume: volume_dims^3 voxels over volume_size meters, voxel
    # (0,0,0) at volume_origin in world coordinates
    volume_dims: int = 256
    volume_size: float = 1.0
    volume_origin: Tuple[float, float, float] = (-0.5, -0.5, 0.5)

    # depth preprocessing
    bilateral_sigma_depth: float = 0.04      # meters
    bilateral_sigma_spatial: float = 4.5     # pixels
    bilateral_kernel_size: int = 7           # pixels
    icp_truncate_depth_dist: float = 0.0     # meters; 0 = disabled
    pyramid_levels: int = 4

    # rigid ICP; icp_iters is the per-level cap (fine -> coarse), a level
    # stops once the Gauss-Newton step norm falls below icp_step_tol
    icp_dist_thres: float = 0.1
    icp_angle_thres: float = math.radians(30.0)
    icp_iters: Tuple[int, ...] = (10, 5, 4, 0)
    icp_step_tol: float = 1e-5
    icp_finest_stride: int = 1

    # TSDF integration ("brick" = brick-sparse, "dense" = per voxel)
    tsdf_trunc_dist: float = 0.04
    tsdf_max_weight: int = 64
    tsdf_min_camera_movement: float = 0.0
    integrate_mode: str = "brick"
    brick_size: int = 16
    integrate_band_cap: int = 2048
    integrate_wide_cap: int = 128
    integrate_rect: int = 128

    # raycasting
    raycast_step_factor: float = 0.75     # in truncation distances
    gradient_delta_factor: float = 0.5    # in voxel sizes
    raycast_subsample: int = 4
    raycast_seed_margin: float = 0.0
    raycast_coarse_factor: int = 4
    raycast_band_margin: float = 0.06
    raycast_band_cap: float = 0.25
    raycast_temporal_band: bool = False
    raycast_refine: str = "secant"
    raycast_adaptive_step: bool = True
    raycast_smooth_normals: bool = False

    # warp field
    knn_k: int = 8
    knn_method: str = "approx"
    max_nodes: int = 1024
    node_sample_step: int = 50
    node_radius: float = 0.05
    node_coverage: float = 0.025
    node_radius_adaptive: bool = False
    node_radius_knn: int = 4
    node_radius_scale: float = 1.0
    node_radius_min: float = 0.03
    node_radius_max: float = 0.1
    node_retire_after: int = 60
    node_support_radius: float = 0.06
    node_insert_stride: int = 4

    # non-rigid Gauss-Newton / LM solver
    solver_nonlinear_iters: int = 3
    solver_linear_iters: int = 32
    solver_lm_lambda_init: float = 1e-4
    solver_function_tolerance: float = 1e-6
    solver_point_stride: int = 2
    solver_hessian_stride: int = 6
    solver_linear: str = "direct"
    solver_linear_tol: float = 1e-3
    solver_live_raw: bool = True
    solver_rigid_prealign: bool = True
    solver_remove_net_rigid: bool = False
    solver_net_rigid_alpha: float = 1.0
    solver_tukey_c: float = 0.05
    solver_huber_delta: float = 1e-4
    solver_arap_weight: float = 10.0
    solver_max_step: float = 0.5
    solver_damping_floor: float = 0.05
    point_to_plane: bool = True
    solver_p2p_weight: float = 0.0
    solver_p2p_adaptive: bool = False
    solver_p2p_hessian_stride: int = 1
    solver_p2p_lag_hessian: bool = False
    solver_p2p_gate_window: int = 41
    solver_p2p_gate_cond: float = 0.01
    solver_p2p_gate_fit: float = 0.35
    solver_p2p_gate_gain: float = 2.0
    solver_jtj_int8: bool = True
    solver_chol_reuse: bool = True
    solver_lagged_jtj: bool = True
    reuse_model_raycast: bool = True
    # plain rigid KinectFusion mode (identity warp, rigid integrate)
    rigid_only: bool = False
    track_against_warped: bool = True

    knn_field_stride: int = 8

    # fusion weighting
    fusion_quality_weight: bool = True
    fusion_quality_min: float = 0.01
    fusion_incidence_weight: bool = False
    fusion_incidence_floor: float = 0.0
    fusion_sdf_incidence_scale: bool = False
    fusion_phase_split: int = 1
    fusion_interval: int = 2

    extract_min_weight: float = 2.0

    light_pose: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # volume storage: tsdf i16 (x 32767) | f32 | bf16; weight u16 (x 512) | f32
    tsdf_dtype: str = "i16"
    weight_dtype: str = "u16"

    def __post_init__(self):
        checks = (
            (self.volume_dims % 32 == 0, "volume_dims must be divisible by 32"),
            (self.volume_dims % self.brick_size == 0, "brick_size must divide volume_dims"),
            (self.brick_size % self.knn_field_stride == 0,
             "bricks must align with the coarse warp grid"),
            (len(self.icp_iters) == self.pyramid_levels, "one icp_iters entry per level"),
            (self.fusion_interval % self.fusion_phase_split == 0,
             "fusion_phase_split must divide fusion_interval"),
            (self.raycast_subsample in (1, 2, 4), "raycast_subsample must be 1, 2 or 4"),
            (self.tsdf_dtype in ("f32", "bf16", "i16"), "unknown tsdf_dtype"),
            (self.weight_dtype in ("f32", "u16"), "unknown weight_dtype"),
            (not self.fusion_sdf_incidence_scale or self.fusion_incidence_weight,
             "fusion_sdf_incidence_scale needs fusion_incidence_weight"),
            (2 ** (self.pyramid_levels - 1) > self.raycast_subsample,
             "need at least one pyramid level below the raycast resolution"),
        )
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)

    @property
    def voxel_size(self) -> float:
        return self.volume_size / self.volume_dims

    @property
    def raycast_shift(self) -> int:
        """Pyramid level of the model/tracking raycast (log2 of raycast_subsample)."""
        return self.raycast_subsample.bit_length() - 1

    @property
    def track_levels(self) -> int:
        """Number of pyramid levels the model maps (and ICP) run at."""
        return self.pyramid_levels - self.raycast_shift

    @classmethod
    def default_dynamicfusion(cls) -> "DynamicFusionConfig":
        """The dynamicfusion preset: newton8 refine, fusion every 6th frame,
        incidence-weighted fusion, temporal march band, factored PCG."""
        return cls(
            raycast_refine="newton8",
            fusion_interval=6,
            fusion_incidence_weight=True,
            raycast_temporal_band=True,
            fusion_incidence_floor=0.35,
            extract_min_weight=0.25,
            fusion_sdf_incidence_scale=True,
            solver_linear="pcg",
            solver_linear_iters=12,
        )

    @classmethod
    def quality_dynamicfusion(cls) -> "DynamicFusionConfig":
        """default_dynamicfusion plus the point-to-point data-term blend."""
        return dataclasses.replace(cls.default_dynamicfusion(), solver_p2p_weight=0.25)

    @classmethod
    def reference_parity(cls) -> "DynamicFusionConfig":
        """The reference implementation's literal parameter values."""
        return cls(
            node_radius=3.0,
            solver_tukey_c=0.01,
            solver_huber_delta=1e-4,
            solver_arap_weight=200.0,
            fusion_interval=1,
            extract_min_weight=1e-6,
            raycast_band_cap=0.0,
            raycast_subsample=1,
        )

    @classmethod
    def default_kinfu(cls) -> "DynamicFusionConfig":
        """The plain-KinectFusion preset (3 m volume, 512^3)."""
        return cls(
            intr=Intrinsics(525.0, 525.0, 640 / 2 - 0.5, 480 / 2 - 0.5),
            volume_dims=512,
            volume_size=3.0,
            volume_origin=(-1.5, -1.5, 0.5),
            raycast_band_cap=0.0,
        )

    @classmethod
    def small(cls, dims: int = 64, rows: int = 120, cols: int = 160) -> "DynamicFusionConfig":
        """A scaled-down preset for tests: same structure, tiny shapes."""
        scale = cols / 640.0
        return cls(
            rows=rows,
            cols=cols,
            intr=Intrinsics(570.342 * scale, 570.342 * scale, cols / 2.0, rows / 2.0),
            volume_dims=dims,
            max_nodes=128,
            node_sample_step=11,
            solver_linear_iters=32,
            knn_field_stride=2,
            raycast_subsample=2,
            raycast_band_cap=0.0,
            fusion_interval=1,
            extract_min_weight=1e-6,
        )

    @classmethod
    def rigid_slice(cls) -> "DynamicFusionConfig":
        """The rigid KinectFusion slice at 640x480 / 256^3: the dynamicfusion
        preset with ``rigid_only`` and the secant refine that rigid mode
        pins (``pipeline.kinfu.DynamicFusion``)."""
        return dataclasses.replace(
            cls.default_dynamicfusion(), rigid_only=True, raycast_refine="secant"
        )

    @classmethod
    def nonrigid_slice(cls) -> "DynamicFusionConfig":
        """The non-rigid DynamicFusion slice at 640x480 / 256^3 / 1024 nodes:
        the dynamicfusion preset with the secant refine (the base default)
        in place of newton8, which the port does not have yet."""
        return dataclasses.replace(cls.default_dynamicfusion(), raycast_refine="secant")
