"""State conversion between numpy and the port: the JAX package's
``PipelineState`` (converted to numpy arrays, as a nested NamedTuple, tuple
or dict in its field order) becomes the port's state and back, with
identical dtypes. Tests start both packages from the same state with it. A
sharded state (``parallel``) is gathered on the way out and split on the
way in, given its mesh.

numpy has no bfloat16 of its own: a bf16 volume (``tsdf_dtype="bf16"``)
comes in as any numpy dtype of kind ``"V"`` and itemsize 2 (JAX's
``bfloat16``, or the ``"V2"`` leaves ``np.savez`` writes for it), taken as
its 16 bits, and goes out as those bits typed ``"V2"``. The port imports no
``ml_dtypes``."""

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


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.kind == "V" and a.dtype.itemsize == 2


def _t(a, dev) -> torch.Tensor:
    a = np.array(a, copy=True)
    if _is_bf16(a):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` on the host as numpy; bfloat16 as its bits, typed
    ``"V2"`` (what ``_t`` takes back)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view("V2").copy()
    return t.numpy().copy()


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
    if not isinstance(state.vol, TsdfVolume):
        if mesh is None:
            raise ValueError("state_to_numpy: a sharded state needs its mesh")
        state = state._replace(vol=mesh.whole(state.vol))

    return {
        "vol": {k: to_numpy(v) for k, v in state.vol._asdict().items()},
        "warp": {k: to_numpy(v) for k, v in state.warp._asdict().items()},
        "pose": to_numpy(state.pose),
        "prev_points": tuple(to_numpy(a) for a in state.prev_points),
        "prev_normals": tuple(to_numpy(a) for a in state.prev_normals),
        "can_points": to_numpy(state.can_points),
        "can_normals": to_numpy(state.can_normals),
        "frame_idx": to_numpy(state.frame_idx),
    }
