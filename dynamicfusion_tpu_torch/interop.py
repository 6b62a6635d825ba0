"""State conversion between numpy and the port: the JAX package's
``PipelineState`` (converted to numpy arrays, as a nested NamedTuple, tuple
or dict in its field order) becomes the port's state and back, with
identical dtypes. Tests start both packages from the same state with it. A
sharded state (``parallel``) is gathered on the way out and split on the
way in, given its mesh."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from dynamicfusion_tpu_torch import device as device_mod
from dynamicfusion_tpu_torch.models.volume import TsdfVolume
from dynamicfusion_tpu_torch.models.warpfield import WarpField
from dynamicfusion_tpu_torch.pipeline.kinfu import PipelineState


def _fields(obj: Any, names) -> Dict[str, Any]:
    """Named fields of a mapping, or of a sequence in field order."""
    if isinstance(obj, Mapping):
        return {n: obj[n] for n in names}
    return dict(zip(names, obj))


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def state_from_numpy(d: Any, device="cuda", mesh=None, cfg=None) -> PipelineState:
    """JAX ``PipelineState`` as numpy -> the port's state on ``device``, or
    with ``mesh`` (and the ``cfg``) laid out over it (``parallel.sharded.
    shard_state``)."""
    if mesh is not None:
        from dynamicfusion_tpu_torch.parallel import sharded

        return sharded.shard_state(cfg, mesh, state_from_numpy(d, mesh.device))
    dev = device_mod.resolve(device)
    s = _fields(d, PipelineState._fields)
    vol = _fields(s["vol"], TsdfVolume._fields)
    warp = _fields(s["warp"], WarpField._fields)
    return PipelineState(
        vol=TsdfVolume(*(_t(vol[n], dev) for n in TsdfVolume._fields)),
        warp=WarpField(*(_t(warp[n], dev) for n in WarpField._fields)),
        pose=_t(s["pose"], dev),
        prev_points=tuple(_t(a, dev) for a in s["prev_points"]),
        prev_normals=tuple(_t(a, dev) for a in s["prev_normals"]),
        can_points=_t(s["can_points"], dev),
        can_normals=_t(s["can_normals"], dev),
        frame_idx=_t(s["frame_idx"], dev),
    )


def state_to_numpy(state: PipelineState, mesh=None) -> Dict[str, Any]:
    """The port's state -> nested dict of numpy arrays in the JAX field
    layout (vol and warp as dicts, map pyramids as tuples). The arrays are
    copies: the port updates its volume in place. A sharded state's volume
    is gathered over its ``mesh``."""

    def n(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().copy()

    if not isinstance(state.vol, TsdfVolume):
        if mesh is None:
            raise ValueError("state_to_numpy: a sharded state needs its mesh")
        state = state._replace(vol=mesh.whole(state.vol))

    return {
        "vol": {k: n(v) for k, v in state.vol._asdict().items()},
        "warp": {k: n(v) for k, v in state.warp._asdict().items()},
        "pose": n(state.pose),
        "prev_points": tuple(n(a) for a in state.prev_points),
        "prev_normals": tuple(n(a) for a in state.prev_normals),
        "can_points": n(state.can_points),
        "can_normals": n(state.can_normals),
        "frame_idx": n(state.frame_idx),
    }
