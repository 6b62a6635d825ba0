"""The orders of kernels K and D's redesigns, transcribed in torch on the CPU.

Kernel K (``csrc/classify.cu``) lists the fusion's work with a cluster of
16 CTAs: each CTA owns a contiguous x-major range of bricks, counts its
four lists (front, surface band, the rest of the band in the fixed
permutation's order, wide), the counts are scanned exclusively in CTA
order, and inside a CTA a brick's rank is its round's running rank, its
warp's offset and its rank in the warp (ballots). ``cluster_list``
transcribes that, with the kernel's constants, and is held equal to the
JAX package's work list (``integrate_bricks``, bricks.py:617-649) on
``test_torch_bricks_plan``'s cases, from JAX's own classes, and to the
port's ``_plan`` on the sharded fusion's slabs (4 x 1 024 bricks).

Kernel D (``csrc/fuse_bricks.cu``) stages a brick's corner grid in shared
memory, contracts x once for each (voxel x, grid j, grid k), then y once
for each (voxel x, voxel y, grid k), and each voxel lerps z.
``separable_positions`` transcribes that and is held bit-equal to the
port's ``_voxel_positions`` at grid strides 8 and 16; with each lerp
fused (``fma(f, p1, p0 (1 - f))``, as XLA's CPU dot contracts the JAX
package's einsums, op by op and jitted) it is bit-equal to JAX's
``_voxel_positions``: the one difference between the two packages'
positions.

The gate: ``plan(..., ok=False)`` gives count 0 and counts (0, 0, 0), and
``integrate_bricks`` with ok False leaves the volume bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_bricks_plan as tbp
from dynamicfusion_tpu.ops import bricks as jbricks
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.models.volume import TsdfVolume
from dynamicfusion_tpu_torch.ops import bricks as tbricks
from dynamicfusion_tpu_torch.parallel import sharded_fusion

# csrc/classify.cu's cluster: CTAs, most and fewest threads a CTA
CLUSTER, MAX_THREADS, MIN_THREADS = 16, 1024, 256
FRONT, BAND, WIDE = tbricks.FRONT, tbricks.BAND, tbricks.WIDE


def cluster_threads(per: int) -> int:
    """A CTA's threads for ``per`` bricks: lanes a brick the most of 4, 2
    and 1 with per x lanes within MIN_THREADS, a warp's multiple, within
    the bounds."""
    lanes = 4 if per * 4 <= MIN_THREADS else 2 if per * 2 <= MIN_THREADS else 1
    return min(MAX_THREADS, max(MIN_THREADS, (per * lanes + 31) // 32 * 32))


def cluster_list(cls, surf, perm, band_cap: int, wide_cap: int):
    """Kernel K's work list built as its cluster builds it: (ids, kind,
    count, (band, wide, dropped))."""
    nbr = cls.shape[0]
    per = -(-nbr // CLUSTER)
    threads = cluster_threads(per)
    band = cls == BAND
    flags = torch.stack([cls == FRONT, band & surf, (band & ~surf)[perm], cls == WIDE]).to(torch.int64)
    ranges = [(min(nbr, r * per), min(nbr, r * per + per)) for r in range(CLUSTER)]
    # every CTA's four counts (in every CTA's shared memory), scanned
    # exclusively in CTA order
    counts = torch.stack([flags[:, b0:b1].sum(1) for b0, b1 in ranges])
    before = torch.cumsum(counts, 0) - counts
    tot = counts.sum(0).tolist()
    n_front, n_band, n_wide = tot[0], tot[1] + tot[2], tot[3]
    n_hi, n_band_sel = min(tot[1], band_cap), min(n_band, band_cap)
    n_list = n_front + n_band_sel + min(n_wide, wide_cap)
    ids = torch.full((nbr,), nbr, dtype=torch.int64)
    kind = torch.zeros(nbr, dtype=torch.int64)
    for r, (b0, b1) in enumerate(ranges):
        run = before[r].clone()  # the CTA's running ranks
        for r0 in range(b0, b1, threads):
            m = min(threads, b1 - r0)
            f = torch.zeros((4, threads), dtype=torch.int64)
            f[:, :m] = flags[:, r0:r0 + m]
            w = f.reshape(4, threads // 32, 32)  # the warps' ballots
            warp_off = torch.cumsum(w.sum(2), 1) - w.sum(2)
            lane = torch.cumsum(w, 2) - w  # popc(mask & lanes below)
            rank = (run[:, None, None] + warp_off[:, :, None] + lane).reshape(4, threads)[:, :m]
            b = torch.arange(r0, r0 + m)
            set_ = f[:, :m].bool()
            slots = (
                (set_[0], rank[0], b, FRONT),
                (set_[1] & (rank[1] < band_cap), n_front + rank[1], b, BAND),
                (set_[2] & (n_hi + rank[2] < band_cap), n_front + n_hi + rank[2], perm[b], BAND),
                (set_[3] & (rank[3] < wide_cap), n_front + n_band_sel + rank[3], b, WIDE),
            )
            for sel, at, who, k in slots:
                ids[at[sel]] = who[sel]
                kind[at[sel]] = k
            run += f.sum(1)
    dropped = max(n_band - band_cap, 0) + max(n_wide - wide_cap, 0)
    return ids, kind, n_list, [n_band, n_wide, dropped]


@pytest.mark.parametrize("name", sorted(tbp.CASES))
def test_cluster_list_is_jax_list(name):
    """The cluster's listing from JAX's classes equals JAX's work list."""
    jc, _ = tbp._configs(name)
    dists, cam, g = tbp._inputs(name)
    split = tbp.CASES[name][4]
    _, jbc, jids, jkind, jcount, jcounts = tbp._jax_plan(jc, dists, cam, g, 1 if split > 1 else None, split)
    nbr = jids.shape[0]
    perm = torch.from_numpy(tbricks._brick_perm(nbr))
    assert np.array_equal(perm.numpy(), np.asarray(jbricks._brick_perm(nbr)))
    band_cap = min(max(jc.integrate_band_cap // split, 1), nbr)
    wide_cap = min(max(jc.integrate_wide_cap // split, 1), nbr)
    ids, kind, count, counts = cluster_list(torch.from_numpy(np.array(jbc.cls)).to(torch.int64),
                                            torch.from_numpy(np.array(jbc.surf)), perm, band_cap, wide_cap)
    assert count == jcount and counts == jcounts
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(kind.numpy(), jkind)
    # more than one CTA lists, and rounds split a CTA at 32^3
    per = -(-nbr // CLUSTER)
    assert per < nbr and (nbr < 32768 or per > cluster_threads(per))


@pytest.mark.parametrize("split", [1, 2])
def test_cluster_list_is_port_list_on_slabs(split):
    """The sharded fusion's slab plans (4 x 1 024 bricks, its caps, the
    phase on the global brick plane): the cluster's listing equals the
    port's ``_plan``."""
    _, tc = tbp._configs("preset_warped")
    tc = dataclasses.replace(tc, fusion_phase_split=split)
    dists, cam, g = tbp._inputs("preset_warped")
    n, b = 4, tc.brick_size
    band_cap, wide_cap = sharded_fusion.caps(tc, n)
    phase = torch.tensor(1, dtype=torch.int32)
    listed = 0
    for k in range(n):
        gk = tbricks.corner_slab(torch.from_numpy(cam), k, n, b, g)
        bp = tbricks.plan_slab(tc, torch.from_numpy(dists), gk, g, tc.intr, k * (tc.volume_dims // n) // b, band_cap,
                               wide_cap, phase, split)
        nbr = bp.classes.cls.shape[0]
        assert nbr == 1024
        ids, kind, count, counts = cluster_list(bp.classes.cls, bp.classes.surf,
                                                torch.from_numpy(tbricks._brick_perm(nbr)), band_cap, wide_cap)
        assert count == int(bp.work.count[0]) and counts == bp.work.counts.tolist()
        assert torch.equal(ids.to(torch.int32), bp.work.ids) and torch.equal(kind.to(torch.int32), bp.work.kind)
        listed += count
    assert listed > 0


def test_gated_plan_and_integrate():
    """ok False: the plan lists nothing (count 0, counts 0) and the
    integrate leaves the volume bit for bit; ok True lists and fuses."""
    _, tc = tbp._configs("small_rigid")
    dists, cam, g = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in tbp._inputs("small_rigid"))
    off, on = torch.tensor(False), torch.tensor(True)
    gated = tbricks.plan(tc, dists, cam, g, tc.intr, ok=off)
    assert int(gated.work.count[0]) == 0 and gated.work.counts.tolist() == [0, 0, 0]
    full = tbricks.plan(tc, dists, cam, g, tc.intr, ok=on)
    ref = tbricks.plan(tc, dists, cam, g, tc.intr)
    assert torch.equal(full.work.count, ref.work.count) and int(ref.work.count[0]) > 0
    rng = np.random.RandomState(5)
    d = tc.volume_dims
    vol = TsdfVolume(torch.from_numpy(rng.randint(-32767, 32768, (d, d, d)).astype(np.int16)),
                     torch.from_numpy(rng.randint(0, 4096, (d, d, d)).astype(np.int16)).view(torch.uint16))
    vk = TsdfVolume(vol.tsdf.clone(), vol.weight.clone())
    counts = tbricks.integrate_bricks(tc, vk, dists, cam, g, tc.intr, ok=off)
    assert counts.tolist() == [0, 0, 0]
    assert torch.equal(vk.tsdf, vol.tsdf) and torch.equal(vk.weight.view(torch.int16), vol.weight.view(torch.int16))
    tbricks.integrate_bricks(tc, vk, dists, cam, g, tc.intr, ok=on)
    assert not torch.equal(vk.tsdf, vol.tsdf)


def separable_positions(cam_flat, corner_idx, b: int, g: int, fused: bool = False):
    """Kernel D's voxel positions (and extra channels): the corners staged,
    x contracted once for each (vx, grid j, grid k), y once for each (vx,
    vy, grid k), then each voxel's z lerp; p0 * (1 - f) + p1 * f each, or
    with ``fused`` fma(f, p1, p0 * (1 - f)) (the sum of the exact product
    and the rounded one, rounded once: in float64, exact for these
    operands, then to float32)."""
    c = b // g + 1
    k, ch = corner_idx.shape[0], cam_flat.shape[-1]
    pts = cam_flat[corner_idx].reshape(k, c, c, c, ch)
    o = torch.arange(b)
    ci = o // g
    f = (o % g).to(torch.float32) / g
    f0 = 1.0 - f

    def lerp(t, axis):
        shape = [1] * t.dim()
        shape[axis] = b
        lo = t.index_select(axis, ci) * f0.reshape(shape)
        if fused:
            return (t.index_select(axis, ci + 1).double() * f.reshape(shape).double() + lo.double()).float()
        return lo + t.index_select(axis, ci + 1) * f.reshape(shape)

    xs = lerp(pts, 1)   # (k, vx, j, k, ch)
    ys = lerp(xs, 2)    # (k, vx, vy, k, ch)
    return lerp(ys, 3).reshape(k, b * b * b, ch)


@pytest.mark.parametrize("stride", [8, 16])
def test_separable_contraction_is_voxel_positions(stride):
    """At grid stride 8 (the non-rigid fusion's, with the blend quality as
    a fourth channel) and 16 (the rigid one's) on the preset's grid: the
    transcription bit-equal to the port's _voxel_positions, and with fused
    lerps to JAX's, op by op and jitted (the two differ)."""
    _, tc = tbp._configs("preset_warped")
    _, cam, g = tbp._inputs("preset_warped" if stride == 8 else "preset_rigid_split")
    assert g == stride
    rng = np.random.RandomState(stride)
    flat = cam.reshape(-1, 3)
    if stride == 8:
        flat = np.concatenate([flat, rng.rand(flat.shape[0], 1).astype(np.float32)], axis=1)
    nbr = (tc.volume_dims // tc.brick_size) ** 3
    ids = torch.from_numpy(rng.choice(nbr, 48, replace=False).astype(np.int64))
    corner = tbricks._corner_indices(tc.volume_dims, tc.brick_size, g, ids)
    got = separable_positions(torch.from_numpy(flat), corner, tc.brick_size, g)
    port = tbricks._voxel_positions(torch.from_numpy(flat), corner, tc.brick_size, g)
    assert torch.equal(got, port)
    fused = separable_positions(torch.from_numpy(flat), corner, tc.brick_size, g, fused=True).numpy()
    args = (jnp.asarray(flat), jnp.asarray(corner.numpy()), tc.brick_size, g)
    for jax_pos in (jbricks._voxel_positions(*args), jax.jit(jbricks._voxel_positions, static_argnums=(2, 3))(*args)):
        np.testing.assert_array_equal(fused, np.asarray(jax_pos))
    assert not np.array_equal(fused, got.numpy())
    assert TCfg.default_dynamicfusion().knn_field_stride == 8
