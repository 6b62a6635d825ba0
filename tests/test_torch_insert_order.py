"""Kernel H's select (``csrc/insert_nodes.cu``) in its own order on the CPU.

The kernel decimates with an open-addressed hash table (the lowest
candidate index of every 32-bit cell hash, an atomicMin a word) and ranks
only the kept candidates: where more are kept than there are slots, a
radix select over their 48-bit keys ((~bits(d2)) << 16 | index) cuts the
first ``cap``, and a sort orders them. Here:

- ``select_transcribed``: the select in torch, the decimation as a
  ``scatter_reduce("amin")`` of the index over the hash ids, the ranking by
  counting over the kept candidates only, with the radix cut of
  ``radix_cut``; held bit for bit against the port's
  ``_insert_select_plain`` (a stable sort of every candidate, then a
  second) and against the JAX package's ``_insert_nodes_impl`` (the new
  nodes' positions, the active set and the count);
- ``table_first``: the kernel's table (its multiplicative home word,
  linear probing, a table as small as the kernel allows) in numpy,
  against the scatter_reduce decimation, for several insertion orders;
- ``radix_cut``: the kernel's six 8-bit digit passes, against a sort.

Inputs: ``chip_smoke.insert_case``'s adversarial cases (repeated cells;
NaN and negative coordinates; invalid and covered candidates ahead of a
valid one in their cell; two distinct cells with one hash; equal
distances; more kept candidates than slots; the gate closed; no free slot;
infinite and NaN distances), 600 candidates and 64 slots. One JAX
compile. Tolerance: none, every comparison is exact (integers, and
positions that are copies of the candidates).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import INSERT_CASES, hash_twins, insert_case
from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.models import warpfield as jw
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.core import compact
from dynamicfusion_tpu_torch.models import warpfield as tw

NC, CAP = 600, 64
KEY_MASK = (1 << 48) - 1


def home(h: int, t: int) -> int:
    """The kernel's first word to probe for the 32-bit hash h."""
    return (((h * 2654435761) & 0xFFFFFFFF) * t) >> 32


def table_first(h: np.ndarray, t: int, order: np.ndarray) -> np.ndarray:
    """first[i]: i is the lowest index of its hash, by the kernel's table
    of t words filled in ``order``, then probed for every candidate."""
    table = [None] * t
    for i in order:
        s = home(int(h[i]), t)
        while table[s] is not None and table[s][0] != h[i]:
            s = (s + 1) % t
        if table[s] is None:
            table[s] = [int(h[i]), int(i)]
        else:
            table[s][1] = min(table[s][1], int(i))
    first = np.zeros(h.shape[0], bool)
    for i in range(h.shape[0]):
        s = home(int(h[i]), t)
        while table[s][0] != h[i]:
            s = (s + 1) % t
        first[i] = table[s][1] == i
    return first


def radix_cut(keys: np.ndarray, m: int) -> int:
    """The m-th smallest of distinct 48-bit keys as the kernel finds it:
    six digits of 8 bits from the top; a digit's histogram counts the keys
    that match the prefix so far, and the bin that holds the need-th of
    them extends the prefix."""
    keys = keys.astype(np.uint64)
    prefix, need = 0, m
    for d in range(5, -1, -1):
        shift = 8 * d
        mask = np.uint64((~0 << (shift + 8)) & KEY_MASK)
        sel = keys[(keys & mask) == np.uint64(prefix)]
        hist = np.bincount(((sel >> np.uint64(shift)) & np.uint64(255)).astype(np.int64), minlength=256)
        run = np.cumsum(hist)
        b = int(np.searchsorted(run, need))
        need -= int(run[b - 1]) if b > 0 else 0
        prefix |= b << shift
    return prefix


def cell_hash(cand: torch.Tensor, cov: float) -> np.ndarray:
    """The int32 cell hash as the kernel's unsigned 32-bit word."""
    return (tw._cell_ids(cand, cov).numpy() & 0xFFFFFFFF).astype(np.int64)


def select_transcribed(case: dict):
    """Kernel H's select in torch: (slots, new positions, k)."""
    cand = torch.from_numpy(case["cand"])
    valid = torch.from_numpy(case["valid"])
    d2 = torch.from_numpy(case["d2"])
    active = torch.from_numpy(case["active"])
    cov, cap, nc = case["cov"], active.shape[0], cand.shape[0]
    idx = torch.arange(nc)
    ids, inv = torch.unique(tw._cell_ids(cand, cov), return_inverse=True)
    low = torch.full((ids.shape[0],), nc, dtype=torch.int64).scatter_reduce(0, inv, idx, "amin")
    keep = (low[inv] == idx) & valid & (d2 > cov * cov)
    bits = (torch.clamp(d2, min=0.0) + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = (((~bits) & 0xFFFFFFFF) << 16) | idx
    kk, ki = key[keep], idx[keep]
    k = kk.shape[0]
    m = min(cap, k)
    cut = radix_cut(kk.numpy(), m) if k > cap else KEY_MASK
    take = kk <= cut
    assert int(take.sum()) == m
    kk, ki = kk[take], ki[take]
    rank = (kk[None, :] < kk[:, None]).sum(dim=1)
    sel = torch.full((cap,), -1, dtype=torch.int64)
    sel[rank] = ki
    sel = torch.where((sel >= 0) & torch.isinf(d2[sel.clamp(min=0)]), -1, sel)
    free = max(cap - case["count"], 0)
    ok = (sel >= 0) & (torch.arange(cap) < free) & case["gate"]
    slots = torch.where(ok, compact.first_true(~active, cap, fill=cap), cap)
    return slots, cand[sel.clamp(min=0)], k


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@functools.lru_cache(maxsize=None)
def case(name: str) -> dict:
    return insert_case(name, NC, CAP)


def plain_select(c: dict):
    cfg = TCfg(node_coverage=c["cov"], max_nodes=CAP)
    field = tw.WarpField(torch.zeros((CAP, 3)), torch.zeros((CAP, 8)), torch.zeros(CAP), torch.from_numpy(c["active"]),
                         torch.tensor(c["count"], dtype=torch.int32), torch.zeros(CAP, dtype=torch.int32))
    return tw._insert_select_plain(cfg, field, torch.from_numpy(c["cand"]), torch.from_numpy(c["valid"]),
                                   torch.from_numpy(c["d2"]), torch.tensor(c["gate"]))


@functools.lru_cache(maxsize=None)
def jax_impl():
    cfg = JCfg(node_coverage=0.025, max_nodes=CAP)
    return jax.jit(functools.partial(jw._insert_nodes_impl, cfg))


def test_hash_twins_share_one_hash():
    a, b = hash_twins(0.025)
    cells = torch.from_numpy((np.stack([a, b]) + 0.5) * 0.025).float()
    h = tw._cell_ids(cells, 0.025)
    assert (a != b).any() and int(h[0]) == int(h[1])
    assert torch.equal(torch.floor(cells / 0.025).to(torch.int64), torch.from_numpy(np.stack([a, b])))


def test_cases_reach_both_ranking_paths():
    k = {name: select_transcribed(case(name))[2] for name in INSERT_CASES}
    assert k["repeated"] <= CAP < k["overflow"]
    assert all(v > 0 for v in k.values())


@pytest.mark.parametrize("words", ["tight", "pow2"])
def test_table_finds_the_first_occurrence(words):
    c = case("hash_twins")
    cand = torch.from_numpy(c["cand"])
    h = cell_hash(cand, c["cov"])
    t = NC + NC // 8 + 1 if words == "tight" else 1 << (2 * NC - 1).bit_length()
    ids, inv = np.unique(h, return_inverse=True)
    low = np.full(ids.shape[0], NC)
    np.minimum.at(low, inv, np.arange(NC))
    want = low[inv] == np.arange(NC)
    rs = np.random.RandomState(3)
    for order in (np.arange(NC), np.arange(NC)[::-1], rs.permutation(NC)):
        assert np.array_equal(table_first(h, t, order), want)


@pytest.mark.parametrize("m", [1, 2, 255, 256, 1000, 2999, 3000])
def test_radix_cut_is_the_mth_key(m):
    rs = np.random.RandomState(m)
    # squared distances in a narrow band share their top digits
    d2 = np.float32(0.025 ** 2) * rs.uniform(1.0, 1.01, size=3000).astype(np.float32)
    d2[::7] = d2[0]
    keys = ((~d2.view(np.uint32)).astype(np.int64) << 16) | rs.permutation(3000)
    assert radix_cut(keys, m) == int(np.sort(keys)[m - 1])


@pytest.mark.parametrize("name", INSERT_CASES)
def test_transcription_is_the_plain_select(name):
    c = case(name)
    slots, new_pos, _ = select_transcribed(c)
    ref = plain_select(c)
    assert torch.equal(slots, ref.slots)
    assert same_bits(new_pos, ref.new_pos)


@pytest.mark.parametrize("name", [n for n in INSERT_CASES if n != "gate_closed"])
def test_transcription_against_jax(name):
    """The JAX package's insertion (behind its gate) places the same
    candidates in the same slots."""
    c = case(name)
    slots, new_pos, _ = select_transcribed(c)
    dq = np.zeros((CAP, 8), np.float32)
    dq[:, 0] = 1.0
    field = jw.WarpField(jnp.zeros((CAP, 3), jnp.float32), jnp.asarray(dq), jnp.full((CAP,), 0.05, jnp.float32),
                         jnp.asarray(c["active"]), jnp.asarray(c["count"], jnp.int32), jnp.zeros((CAP,), jnp.int32))
    out = jax_impl()(field, jnp.asarray(c["cand"]), jnp.asarray(c["valid"]), jnp.asarray(c["d2"]),
                     jnp.asarray(9, jnp.int32))
    ok = slots < CAP
    want_pos = torch.zeros((CAP, 3))
    want_pos[slots[ok]] = new_pos[ok]
    want_active = torch.from_numpy(c["active"]).clone()
    want_active[slots[ok]] = True
    assert np.array_equal(np.asarray(out.active), want_active.numpy())
    assert int(out.count) == c["count"] + int(ok.sum())
    assert np.array_equal(np.asarray(out.positions), want_pos.numpy(), equal_nan=True)
