"""The port's warp solver (factored-PCG path) against the JAX package, on
the CPU: data and edge terms, the closed-form Jacobians the CUDA kernels
use, spd6_inv, the factored matvec and PCG; one LM solve and the rigid
pre-alignment are in tests/test_torch_warp_solves.py (a file of its own,
so that ``--dist loadfile`` spreads the JAX compiles over the workers),
with this file's problem and tolerances.

The problem is a sphere surface seen by the solver: canonical points on a
sphere of radius 0.2 m at z = 1 m with radial normals, nodes sampled from
the surface with small random transforms, and live points displaced along
the normal by a smooth bump, all made from a seed with numpy.

The LM solve is held two ways. Its initial cost is a deterministic
function of the inputs (1e-5). Its final cost and node transforms are
not, in either package: the factored system stores the Jacobian rows in
bf16, so a last-bit difference in a Jacobian entry flips its bf16
rounding and moves the step. The JAX package itself moves its final cost
by ~1% and its node transforms by ~2e-3 when p_live is perturbed by 1e-7
relative. So the port's final cost and the warped surface are held within
four times the spread of JAX's own under three such perturbations, made
in the test (the port's last bits differ in more places than p_live).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_nonrigid_cases as cases
from torch_nonrigid_cases import one_torch_thread  # noqa: F401  (autouse)

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.core import dualquat as jdq
from dynamicfusion_tpu.solvers import warp_solver as js
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.core import dualquat as tdq
from dynamicfusion_tpu_torch.models import warpfield as tw
from dynamicfusion_tpu_torch.solvers import warp_solver as ts

TOL_DATA = 1e-4   # data term: residuals, Jacobians, Jᵀr, blocks, cost (relative to the largest entry)
TOL_EDGE = 1e-5   # edge term, relative
TOL_CLOSED = 1e-5  # closed-form Jacobian vs jacrev, relative
TOL_SPD6 = 1e-4   # spd6_inv on well-conditioned blocks, relative
TOL_MV = 1e-4     # factored matvec from the same bf16 rows, relative
TOL_COST0 = 1e-5  # the solve's initial cost, relative
SPREAD = 4.0      # final cost, warped surface, PCG iterate: within this many times JAX's own spread (3 samples)
TOL_PREALIGN = 1e-5

N = 128
P = 2400
JC = dataclasses.replace(JCfg.default_dynamicfusion(), max_nodes=N, raycast_refine="secant")
TC = dataclasses.replace(TCfg.nonrigid_slice(), max_nodes=N)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref):
    ref = np.asarray(ref)
    got = np.asarray(got)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _problem(seed=0):
    """(JAX field, port field, JAX inputs, port inputs) on a sphere."""
    return cases.sphere_problem(seed, N, P)


@pytest.fixture(scope="module")
def prob():
    """(JAX field, port field, JAX inputs, port inputs, JAX structure, port
    structure with JAX's neighbour lists and weights). The terms are held
    on the same neighbour lists: KNN's near ties are held in
    test_prepare_matches_jax."""
    jfield, tfield, ji, ti = _problem()
    s = js.prepare(JC, jfield, ji, True)
    t = ts.prepare(TC, tfield, ti)
    idx = _t(s.knn_idx).long()
    t = t._replace(knn_idx=idx, w_knn=_t(s.w_knn), valid=_t(s.valid), pts_by_node=ts.node_lists(idx, N))
    return jfield, tfield, ji, ti, s, t


TOL_TIE_FRAC = 1e-3  # solve points whose neighbour lists differ at a near tie (see test_torch_warpfield.py)


def test_prepare_matches_jax(prob):
    jfield, tfield, ji, ti, s, _ = prob
    t = ts.prepare(TC, tfield, ti)
    same = (np.asarray(s.knn_idx) == t.knn_idx.numpy()).all(1)
    assert (~same).mean() <= TOL_TIE_FRAC
    np.testing.assert_array_equal(np.asarray(s.valid), t.valid.numpy())
    for name in ("e_src", "e_dst", "e_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(s, name)), getattr(t, name).numpy())
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(s.alpha), rtol=1e-7)
    np.testing.assert_allclose(t.w_knn.numpy()[same], np.asarray(s.w_knn)[same], rtol=1e-4, atol=1e-30)
    # the node lists cover every (point, neighbour) entry once, grouped by node
    order, off = t.pts_by_node.order.long(), t.pts_by_node.off.long()
    assert torch.equal(torch.sort(order)[0], torch.arange(order.numel()))
    keys = t.knn_idx.reshape(-1)[order]
    assert torch.equal(keys, torch.repeat_interleave(torch.arange(N), off[1:] - off[:-1]))


def test_data_term_matches_jax(prob):
    jfield, tfield, _, _, s, t = prob
    r, jac, cost = js.data_residual_and_jac(JC, s, jfield.dq, True)
    tr, tjac, tcost = ts.data_residual_and_jac(TC, t, tfield.dq)
    assert tr.shape == r.shape and tjac.shape == jac.shape  # (P, 1) and (P, 1, K, 6): one residual row
    assert _rel(tr.numpy(), r) <= TOL_DATA
    assert _rel(tjac.numpy(), jac) <= TOL_DATA
    assert _rel(tcost.numpy(), cost) <= TOL_DATA
    dt = ts.data_term(TC, t, tfield.dq, system=True)
    assert _rel(dt.jtr.numpy(), js.data_jtr(s, jac, r, N)) <= TOL_DATA
    hi = jax.lax.Precision.HIGHEST
    h_p = jnp.einsum("prkd,prke->pkde", jac, jac, precision=hi)
    blocks = jnp.einsum("pkn,pkde->nde", jax.nn.one_hot(s.knn_idx, N, dtype=jnp.float32), h_p, precision=hi)
    assert _rel(dt.blocks.numpy(), blocks) <= TOL_DATA
    assert dt.rows.dtype == torch.bfloat16 and dt.rows.shape == (t.knn_idx.shape[0], 1, 8, 6)
    # the lagged-JᵀJ evaluation: gradient and cost in one vjp pass (JAX)
    jg, jcost = js.data_grad_cost(JC, s, jfield.dq, N, True)
    ev = ts.data_term(TC, t, tfield.dq, system=False)
    assert ev.rows is None and ev.blocks is None
    assert _rel(ev.jtr.numpy(), jg) <= TOL_DATA and _rel(ev.cost.numpy(), jcost) <= TOL_DATA


def test_edge_term_matches_jax(prob):
    jfield, tfield, _, _, s, t = prob
    re, je_i, je_j, cost = js.edge_residual_and_jac(JC, s, jfield.dq)
    tre, tje_i, tje_j, tcost = ts.edge_residual_and_jac(TC, t, tfield.dq)
    for got, ref in ((tre, re), (tje_i, je_i), (tje_j, je_j), (tcost, cost)):
        assert _rel(got.numpy(), ref) <= TOL_EDGE
    et = ts.edge_term(TC, t, tfield.dq)
    eb = js.edge_blocks(s, je_i, je_j, N)
    for name in ("h_ii", "h_jj", "h_ij"):
        assert _rel(getattr(et, name).numpy(), eb[name]) <= TOL_EDGE
    assert _rel(et.diag.numpy(), eb["diag_blocks"]) <= TOL_EDGE
    assert _rel(et.jtr.numpy(), js.edge_jtr(s, je_i, je_j, re, N)) <= TOL_EDGE


# ---------------------------------------------------------------- closed-form Jacobians (kernels F and G)


def _dot4(a, b):
    return (a * b).sum(-1, keepdim=True)


def _grad_transform(rin, d, v, n):
    """n · d/d(r, d) of dualquat.transform at (r, d), taken literally
    (through the guarded normalize of r): csrc/dq.cuh grad_transform."""
    n2 = _dot4(rin, rin)
    small = n2 < 1e-12
    s = torch.sqrt(torch.where(small, 1.0, n2))
    r = rin / s
    w, u, dw, dv = r[..., :1], r[..., 1:], d[..., :1], d[..., 1:]
    cross = torch.linalg.cross
    uv, nu, nv = _dot4(u, v), _dot4(n, u), _dot4(n, v)
    gw = 2 * _dot4(n, cross(u, v)) + 2 * _dot4(n, dv)
    gu = 2 * (uv * n + nu * v - 2 * nv * u) - 2 * w * cross(n, v) - 2 * dw * n - 2 * cross(n, dv)
    gr = torch.cat([gw, gu], -1)
    gd = torch.cat([-2 * nu, 2 * (w * n + cross(n, u))], -1)
    return torch.where(small, gr, (gr - _dot4(r, gr) * r) / s), gd


def _pure_mul(i, q):
    qw, qx, qy, qz = q.unbind(-1)
    return torch.stack([(-qx, qw, -qz, qy), (-qy, qz, qw, -qx), (-qz, -qy, qx, qw)][i], -1)


def _twist_rows(gq, ge, a):
    """g · d(from_twist(eps) ⊗ a)/d eps at eps = 0: csrc/dq.cuh twist_row."""
    rot = [_dot4(gq, _pure_mul(i, a[..., :4]))[..., 0] + _dot4(ge, _pure_mul(i, a[..., 4:]))[..., 0] for i in range(3)]
    tr = [0.5 * _dot4(ge, _pure_mul(i, a[..., :4]))[..., 0] for i in range(3)]
    return torch.stack(rot + tr, -1)


def data_jac_closed_form(dq_k, w_k, p, n):
    """jac_k = w_k s_k g M(dq_k): g the gradient of n·transform(normalize(b))
    at the blend b, chained through the dual-quaternion normalize."""
    signs = tdq.blend_signs(dq_k)[..., 0]
    b = (w_k[..., None] * dq_k * signs[..., None]).sum(-2)
    br, be = b[..., :4], b[..., 4:]
    n2 = _dot4(br, br)
    small = n2 < 1e-12
    sn = torch.sqrt(torch.where(small, 1.0, n2))
    r, d0 = br / sn, be / sn
    rd0 = _dot4(r, d0)
    gr, gd = _grad_transform(r, d0 - rd0 * r, p, n)
    h = gd - _dot4(r, gd) * r
    big_g = gr - rd0 * gd - _dot4(r, gd) * d0
    gq = torch.where(small, big_g, (big_g - _dot4(r, big_g) * r) / sn - r * _dot4(d0, h) / sn)
    ge = torch.where(small, h, h / sn)
    return (w_k * signs)[..., None] * _twist_rows(gq[..., None, :], ge[..., None, :], dq_k)


def edge_jac_closed_form(dq, v):
    """(3, 6) Jacobian of transform(from_twist(eps) ⊗ dq, v) at eps = 0."""
    eye = torch.eye(3)
    rows = []
    for c in range(3):
        gr, gd = _grad_transform(dq[..., :4], dq[..., 4:], v, eye[c].expand(v.shape))
        rows.append(_twist_rows(gr, gd, dq))
    return torch.stack(rows, -2)


@pytest.mark.parametrize("antipodal", [False, True])
def test_closed_form_data_jacobian_matches_jacrev(prob, antipodal):
    _, tfield, _, _, _, t = prob
    dq_k = tfield.dq[t.knn_idx].clone()
    if antipodal:
        dq_k[:, 3] = -dq_k[:, 3]  # a neighbour on the other sheet: the blend sign flips it back
    eps0 = torch.zeros(dq_k.shape[:2] + (6,))
    ref = torch.func.vmap(torch.func.jacrev(ts._data_residual))(eps0, dq_k, t.w_knn, t.p_can, t.p_live, t.n_live)[:, 0]
    got = data_jac_closed_form(dq_k, t.w_knn, t.p_can, t.n_live)
    assert _rel(got.numpy(), ref.numpy()) <= TOL_CLOSED


def test_closed_form_point_to_point_jacobian_matches_jacrev(prob):
    """Kernel F's point-to-point rows: the closed form along each world axis
    is the Jacobian of that component of warp(p_can) - p_live."""
    _, tfield, _, _, _, t = prob
    dq_k = tfield.dq[t.knn_idx]
    eps0 = torch.zeros(dq_k.shape[:2] + (6,))
    ref = torch.func.vmap(torch.func.jacrev(ts._data_residual_p2p))(eps0, dq_k, t.w_knn, t.p_can, t.p_live)
    axes = torch.eye(3)
    got = torch.stack([data_jac_closed_form(dq_k, t.w_knn, t.p_can, axes[j].expand(t.p_can.shape)) for j in range(3)],
                      1)
    assert got.shape == ref.shape == (t.p_can.shape[0], 3, 8, 6)
    assert _rel(got.numpy(), ref.numpy()) <= TOL_CLOSED


def test_closed_form_edge_jacobian_matches_jacrev(prob):
    _, tfield, _, _, _, t = prob
    z = torch.zeros((t.e_src.shape[0], 6))
    dq_i, dq_j = tfield.dq[t.e_src], tfield.dq[t.e_dst]
    ji, jj = torch.func.vmap(torch.func.jacrev(ts._edge_residual, argnums=(0, 2)))(z, dq_i, z, dq_j, t.v_dst)
    assert _rel(edge_jac_closed_form(dq_i, t.v_dst).numpy(), ji.numpy()) <= TOL_CLOSED
    assert _rel(-edge_jac_closed_form(dq_j, t.v_dst).numpy(), jj.numpy()) <= TOL_CLOSED


# ---------------------------------------------------------------- linear algebra


def test_spd6_inv_matches_jax_and_inverts():
    rng = np.random.RandomState(3)
    a = rng.randn(N, 6, 6).astype(np.float32)
    m = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)).astype(np.float32)
    got = ts.spd6_inv(_t(m)).numpy()
    assert _rel(got, js.spd6_inv(jnp.asarray(m))) <= TOL_SPD6
    assert _rel(got, np.linalg.inv(m.astype(np.float64))) <= TOL_SPD6


def _coupled_blocks(spread, lam, n=1024, k=24, seed=0):
    """Damped 6x6 blocks as the factored solve builds them, for nodes about
    1 m from the world origin whose points lie within ``spread`` of the
    node: twist rows [p x n, n] sqrt(w) of point-to-plane residuals, their
    Gram, then lam * diag_eff + 1e-8 on the diagonal (diag_eff floored at
    solver_damping_floor times the mean). A rotation about the origin and a
    translation are then nearly the same motion."""
    rng = np.random.RandomState(seed)
    c = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n), rng.uniform(0.8, 1.2, n)], -1)
    p = c[:, None, :] + spread * rng.randn(n, k, 3)
    nrm = rng.randn(n, k, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    w = rng.uniform(0.2, 1.0, (n, k, 1))
    j = np.concatenate([np.cross(p, nrm), nrm], -1) * np.sqrt(w)
    jtj = np.einsum("nki,nkj->nij", j, j).astype(np.float32)
    diag = np.diagonal(jtj, axis1=1, axis2=2)
    eff = np.maximum(diag, TC.solver_damping_floor * diag.mean())
    return (jtj + np.einsum("ni,ij->nij", lam * eff + 1e-8, np.eye(6))).astype(np.float32)


@pytest.mark.parametrize("spread,lam", [(0.01, 1e-4), (0.005, 1e-4), (0.01, 1e-3)])
def test_spd6_inv_on_coupled_damped_blocks_matches_jax(spread, lam):
    """The closed form on the solver's ill-conditioned blocks (median
    condition numbers 1e4 to 5e4): the Schur complement cancels, so both
    packages are far from the float64 inverse on some blocks. The port must
    fail the same way: the same NaN and inf pattern (blocks with a zero, a
    NaN and an inf entry added) and the same error distribution against
    float64 (median within 1.5x of JAX's, 99th percentile within 2x)."""
    m = _coupled_blocks(spread, lam)
    cond = np.linalg.cond(m.astype(np.float64))
    assert np.median(cond) > 1e4
    specials = np.zeros((3, 6, 6), np.float32)
    specials[1] = specials[2] = np.eye(6)
    specials[1, 0, 4] = np.nan
    specials[2, 5, 5] = np.inf
    m = np.concatenate([m, specials])
    jo = np.asarray(js.spd6_inv(jnp.asarray(m)))
    to = ts.spd6_inv(_t(m)).numpy()
    np.testing.assert_array_equal(np.isnan(to), np.isnan(jo))
    np.testing.assert_array_equal(np.isinf(to), np.isinf(jo))
    np.testing.assert_array_equal(to[-3], jo[-3])  # the zero block: the guarded 3x3 adjugate gives zeros
    assert not np.isfinite(to[-2:]).all((1, 2)).any()
    ref = np.linalg.inv(m[:-3].astype(np.float64))
    scale = np.abs(ref).max((1, 2))
    ej = np.abs(jo[:-3] - ref).max((1, 2)) / scale
    et = np.abs(to[:-3] - ref).max((1, 2)) / scale
    assert np.median(ej) > 1e-4  # far from the well-conditioned 1e-6
    assert np.median(et) <= 1.5 * np.median(ej)
    assert np.quantile(et, 0.99) <= 2.0 * np.quantile(ej, 0.99)


def _jax_system(prob, lam=1e-4):
    """JAX's factored system (rows, damping, preconditioner, mv) at the
    field's linearization point, as solve builds it."""
    jfield, _, _, _, s, _ = prob
    r, jac, _ = js.data_residual_and_jac(JC, s, jfield.dq, True)
    rows = jnp.einsum("prkd,pkn->prdn", jac.astype(jnp.bfloat16), jax.nn.one_hot(s.knn_idx, N, dtype=jnp.bfloat16))
    rows = rows.reshape(-1, 6 * N)
    re, je_i, je_j, _ = js.edge_residual_and_jac(JC, s, jfield.dq)
    eb = js.edge_blocks(s, je_i, je_j, N)
    hi = jax.lax.Precision.HIGHEST
    h_p = jnp.einsum("prkd,prke->pkde", jac, jac, precision=hi)
    blocks = jnp.einsum("pkn,pkde->nde", jax.nn.one_hot(s.knn_idx, N, dtype=jnp.float32), h_p, precision=hi)
    blocks_full = blocks + eb["diag_blocks"]
    diag = jnp.diagonal(blocks_full, axis1=-2, axis2=-1).reshape(-1)
    active = jnp.repeat(jfield.active, 6)
    mean = jnp.sum(jnp.where(active, diag, 0.0)) / jnp.maximum(jnp.sum(active.astype(jnp.float32)), 1.0)
    damp = lam * jnp.maximum(diag, JC.solver_damping_floor * mean) + jnp.where(active & (diag > 1e-12), 1e-8, 1.0)

    def mv(p):
        pd = p.reshape(N, 6).T.reshape(-1)
        tt = jnp.dot(rows, pd.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
        apd = jnp.dot(tt.astype(jnp.bfloat16), rows, preferred_element_type=jnp.float32)
        return apd.reshape(6, N).T.reshape(-1) + js.edge_matvec(s, eb, p, N) + damp * p

    minv = js.spd6_inv(blocks_full + jax.vmap(jnp.diag)(damp.reshape(N, 6)))
    jtr = js.data_jtr(s, jac, r, N) + js.edge_jtr(s, je_i, je_j, re, N)
    return jac, damp, mv, minv, jtr


def _port_system(prob, jac, damp):
    """The port's System from JAX's own bf16 rows and damping."""
    _, tfield, _, _, _, t = prob
    rows = torch.from_numpy(np.array(jac.astype(jnp.float32))).to(torch.bfloat16)
    return ts.System(rows, ts.edge_term(TC, t, tfield.dq), _t(damp))


def test_matvec_and_pcg_match_jax(prob):
    """From JAX's own rows, damping and preconditioner: one matvec to
    1e-4; one PCG iteration to 1e-4; twelve within four times the spread of
    JAX's own under a 1e-7 relative perturbation of the right-hand side (a
    flipped bf16 rounding of one intermediate is amplified by the
    iteration)."""
    jac, damp, mv, minv, jtr = _jax_system(prob)
    t = prob[5]
    sys_t = _port_system(prob, jac, damp)
    pv = np.random.RandomState(4).randn(6 * N).astype(np.float32)
    assert _rel(ts.matvec(t, sys_t, _t(pv)).numpy(), mv(jnp.asarray(pv))) <= TOL_MV
    on = torch.ones((), dtype=torch.bool)
    tol = TC.solver_linear_tol
    x1 = js._pcg(mv, minv, jtr, N, 1, tol)
    assert _rel(ts.pcg(t, sys_t, _t(minv), _t(jtr), 1, tol, on).numpy(), x1) <= TOL_MV
    x = np.asarray(js._pcg(mv, minv, jtr, N, 12, tol))
    rng = np.random.RandomState(6)
    spread = max(
        float(np.abs(np.asarray(js._pcg(mv, minv, jtr * (1.0 + 1e-7 * jnp.asarray(rng.randn(6 * N).astype(np.float32))),
                                        N, 12, tol)) - x).max())
        for _ in range(3)
    )
    got = ts.pcg(t, sys_t, _t(minv), _t(jtr), 12, tol, on).numpy()
    assert float(np.abs(got - x).max()) <= SPREAD * spread + TOL_MV * float(np.abs(x).max())
    assert not bool(ts.pcg(t, sys_t, _t(minv), _t(jtr), 12, tol, ~on).any())
