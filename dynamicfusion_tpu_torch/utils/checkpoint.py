"""Checkpoint and resume of the full pipeline state, in the JAX package's
format: one compressed ``.npz`` holding ``n`` and ``a0`` ... ``a{n-1}``, the
state's leaves in the order ``jax.tree.flatten`` gives the JAX package's
``PipelineState`` (its fields in order, the volume's and the warp field's
fields in order, the map pyramids level by level). A checkpoint written by
either package loads in the other. ``load`` checks the leaves' shapes
against the config and re-encodes a volume written under other storage
dtypes (``models.volume.convert``). A sharded state (``parallel``) is
gathered to write and split to restore: the file is the same whatever the
shard count.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from dynamicfusion_tpu_torch import device as device_mod, interop
from dynamicfusion_tpu_torch.config import DynamicFusionConfig
from dynamicfusion_tpu_torch.models import volume as volume_model
from dynamicfusion_tpu_torch.models.volume import TsdfVolume
from dynamicfusion_tpu_torch.models.warpfield import WarpField
from dynamicfusion_tpu_torch.pipeline import kinfu


def leaves(state: kinfu.PipelineState) -> List:
    """The state's leaves in the JAX package's flattening order."""
    return [
        *state.vol, *state.warp, state.pose, *state.prev_points, *state.prev_normals,
        state.can_points, state.can_normals, state.frame_idx,
    ]


def unflatten(flat: List, levels: int) -> kinfu.PipelineState:
    """The inverse of ``leaves`` for map pyramids of ``levels`` levels."""
    it = iter(flat)

    def take(n: int) -> list:
        return [next(it) for _ in range(n)]

    vol = TsdfVolume(*take(len(TsdfVolume._fields)))
    warp = WarpField(*take(len(WarpField._fields)))
    (pose,) = take(1)
    prev_points, prev_normals = tuple(take(levels)), tuple(take(levels))
    can_points, can_normals, frame_idx = take(3)
    return kinfu.PipelineState(vol, warp, pose, prev_points, prev_normals, can_points, can_normals, frame_idx)


def save(path: str, state: kinfu.PipelineState, mesh=None) -> None:
    """Write the state as one compressed .npz (copied to the host); a
    sharded state's volume gathered over its ``mesh`` (every rank of a
    multi-process mesh takes part; write from one)."""
    if not isinstance(state.vol, TsdfVolume):
        if mesh is None:
            raise ValueError("save: a sharded state needs its mesh")
        state = state._replace(vol=mesh.whole(state.vol))
    flat = leaves(state)
    if any(t.dtype == torch.bfloat16 for t in flat):
        raise NotImplementedError("bf16 volume storage: the JAX package's checkpoint cannot load one back "
                                  "(numpy writes its bfloat16 leaves as 'V2'), so the format holds none")
    arrays = {f"a{i}": t.detach().cpu().numpy() for i, t in enumerate(flat)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, n=len(flat), **arrays)


def load(path: str, cfg: DynamicFusionConfig, mesh=None, device="cuda") -> kinfu.PipelineState:
    """Restore a state onto ``device`` (CUDA unless the CPU is asked for),
    or with ``mesh`` onto the mesh (the volume split into its slabs, the
    rest on ``mesh.device``). Raises ValueError when the checkpoint's
    leaves do not fit the config's state; a volume stored under other
    dtypes is re-encoded to the config's."""
    if mesh is not None:
        from dynamicfusion_tpu_torch.parallel import sharded

        return sharded.shard_state(cfg, mesh, load(path, cfg, device=mesh.device))
    dev = device_mod.resolve(device)
    with np.load(path) as data:
        n = int(data["n"])
        flat = [data[f"a{i}"] for i in range(n)]
    template = leaves(kinfu.init_state(cfg, "cpu"))
    if len(flat) != len(template):
        raise ValueError(f"checkpoint has {len(flat)} leaves, the config's state {len(template)}")
    for a, b in zip(flat, template):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"checkpoint shape {a.shape} incompatible with config shape {tuple(b.shape)}")
        if a.dtype.kind == "V":
            raise NotImplementedError("bf16 volume storage ('V2' leaves): the JAX package's checkpoint cannot "
                                      "load one back, so the format holds none")
    state = interop.state_from_numpy(unflatten(flat, cfg.track_levels), dev)
    if state.vol.tsdf.dtype != template[0].dtype or state.vol.weight.dtype != template[1].dtype:
        state = state._replace(vol=volume_model.convert(state.vol, cfg))
    return state
