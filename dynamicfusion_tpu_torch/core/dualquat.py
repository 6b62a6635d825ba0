"""Dual quaternions (..., 8) = (real wxyz, dual wxyz) and dual-quaternion
blending (port of ``dynamicfusion_tpu.core.dualquat``). A rigid transform
(R(q), t) is stored as real = q, dual = 0.5 (0, t) ⊗ q; the product is the
true dual-quaternion product and blending normalizes the blended sum."""

from __future__ import annotations

import torch

from dynamicfusion_tpu_torch.core import quat

_EPS = 1e-12


def identity(device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)


def real(dq: torch.Tensor) -> torch.Tensor:
    return dq[..., :4]


def dual(dq: torch.Tensor) -> torch.Tensor:
    return dq[..., 4:]


def make(real_q: torch.Tensor, dual_q: torch.Tensor) -> torch.Tensor:
    return torch.cat([real_q, dual_q], dim=-1)


def from_rot_trans(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Unit rotation q and translation t -> (q, 0.5 (0, t) ⊗ q)."""
    t_quat = torch.cat([torch.zeros_like(t[..., :1]), t], dim=-1)
    return make(q, 0.5 * quat.mul(t_quat, q))


def from_twist(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Twist (r, t) -> dual quaternion with rotation exp_pure(r) (angle
    2|r|) and the literal translation t: the warp solver's 6-dof chart."""
    return from_rot_trans(quat.exp_pure(r), t)


def rotation(dq: torch.Tensor) -> torch.Tensor:
    return real(dq)


def translation(dq: torch.Tensor) -> torch.Tensor:
    """t = 2 · dual ⊗ conj(normalize(real))."""
    r = quat.normalize(real(dq))
    return (2.0 * quat.mul(dual(dq), quat.conj(r)))[..., 1:]


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(ar + ε ad)(br + ε bd)."""
    r = quat.mul(real(a), real(b))
    d = quat.mul(real(a), dual(b)) + quat.mul(dual(a), real(b))
    return make(r, d)


def conj(dq: torch.Tensor) -> torch.Tensor:
    return make(quat.conj(real(dq)), quat.conj(dual(dq)))


def normalize(dq: torch.Tensor) -> torch.Tensor:
    """Unit dual quaternion: divide by |real| and remove the real·dual
    component. Gradient-safe at |real| = 0 (passes through unchanged)."""
    re, du = real(dq), dual(dq)
    n2 = quat.sum4(re * re)
    n = torch.sqrt(torch.where(n2 < _EPS, 1.0, n2))
    r = re / n
    d = du / n
    d = d - quat.sum4(r * d) * r
    return make(r, d)


def transform(dq: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """p' = R(real) p + t(dq) for points p (..., 3)."""
    return quat.rotate(quat.normalize(real(dq)), p) + translation(dq)


def rotate(dq: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The rotation part only (normals)."""
    return quat.rotate(quat.normalize(real(dq)), v)


def blend_signs(dqs: torch.Tensor) -> torch.Tensor:
    """(..., K, 1) antipodal signs against the FIRST neighbour's real part
    (0 counts as +1): the KNN order is part of the blend."""
    pivot = dqs[..., :1, :4]
    sign = torch.sign(quat.sum4(dqs[..., :4] * pivot))
    return torch.where(sign == 0, 1.0, sign)


def blend(weights: torch.Tensor, dqs: torch.Tensor) -> torch.Tensor:
    """normalize(Σ_k w_k s_k dq_k) over weights (..., K) and dqs (..., K, 8),
    summed over k in order."""
    terms = weights[..., None] * dqs * blend_signs(dqs)
    acc = terms[..., 0, :]
    for k in range(1, dqs.shape[-2]):
        acc = acc + terms[..., k, :]
    return normalize(acc)


def to_matrix(dq: torch.Tensor) -> torch.Tensor:
    """Unit dual quaternion -> (..., 4, 4) homogeneous rigid transform."""
    r = quat.normalize(real(dq))
    top = torch.cat([quat.to_matrix(r), translation(dq)[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dq.dtype, device=dq.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rigid transform -> unit dual quaternion."""
    return from_rot_trans(quat.from_matrix(m[..., :3, :3]), m[..., :3, 3])
