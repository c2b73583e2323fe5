"""Paged decode attention's split plan and split-then-combine, on the CPU.

``repro_torch.kernels.paged_attention.plan`` cuts each slot's block table
into contiguous runs of entries for the CUDA kernel, from the table's width,
the block size and the heads alone. It is tested here without a card, as
qgemm's plan is (``test_torch_qgemm_plan.py``).

The kernel itself runs only on a card. What it computes is emulated here in
torch, in its order: each lane group's online softmax over the rows it
holds (log2 domain, the max moved only past ``RESCALE``, an explicit zero
weight past the horizon), the groups of a warp merged by an xor butterfly,
the warps in order, then the splits' partials folded in split order. The
emulation lives in this file only; the cuda-marked test in
``test_torch_kernels.py`` and ``chip_smoke.py`` hold the kernel against the
plain version on the card.

Tolerance: the emulation against the Pallas kernel in interpret mode and
against the plain version, rtol = atol = 1e-5: the split online softmax and
the full-row softmax differ only by f32 rounding (the contract of
``test_torch_kernels.py``).
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_decode_attention as pallas_paged
from repro_torch.kernels import paged_attention as tpa

SMS = 132                      # the H100's SMs


# ------------------------------------------------------------------ plan

@pytest.mark.parametrize("bs", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("H,KV", [(32, 4), (4, 4), (8, 1), (12, 4)])
def test_plan_covers_every_entry_once_in_order(bs, H, KV):
    for MB in range(1, 300):
        p = tpa.plan(MB, bs, H, KV)
        runs = [range(s * p.per, min((s + 1) * p.per, MB)) for s in range(p.splits)]
        assert [j for run in runs for j in run] == list(range(MB))
        assert all(len(run) > 0 for run in runs)
        assert 1 <= p.splits <= tpa.MAX_SPLITS


def test_plan_takes_no_batch_and_no_horizon():
    """A slot's reduction order comes from the plan, so it must not change
    with the number of slots in the call or with any slot's horizon."""
    assert list(inspect.signature(tpa.plan).parameters) == ["MB", "bs", "H", "KV"]
    p = tpa.plan(10, 16, 32, 4)
    assert [p.blocks(B, 32) for B in (1, 2, 8)] == [p.blocks(1, 32) * B for B in (1, 2, 8)]


@pytest.mark.parametrize("MB,bs", [(1, 16), (2, 16), (1, 32), (4, 8), (8, 4), (3, 8)])
def test_plan_one_split_for_a_small_table(MB, bs):
    assert MB * bs <= tpa.MIN_SPLIT_TOKENS
    assert tpa.plan(MB, bs, 32, 4) == tpa.Plan(1, MB, 8)


@pytest.mark.parametrize("MB", [10, 128])
def test_plan_fills_the_card_at_the_serving_and_long_shapes(MB):
    """tinyllama's heads (32 over 4 KV heads), 16-token blocks, 8 slots: the
    serving table (160 positions) and the full 2048-token context."""
    p = tpa.plan(MB, 16, 32, 4)
    assert p.blocks(8, 32) >= SMS
    assert p.splits > 1 and p.heads == 8


@pytest.mark.parametrize("H,KV,heads", [(32, 4, 8), (32, 8, 4), (8, 4, 2), (4, 4, 1),
                                        (12, 4, 1), (64, 4, 8), (24, 4, 2)])
def test_plan_heads_divide_the_group(H, KV, heads):
    assert tpa.plan(10, 16, H, KV).heads == heads


@pytest.mark.parametrize("hd,dtype,lanes", [(64, torch.bfloat16, 8), (16, torch.float32, 4),
                                            (256, torch.bfloat16, 32), (8, torch.float32, 2),
                                            (128, torch.float32, 32)])
def test_lanes_per_row(hd, dtype, lanes):
    assert tpa.lanes_per_row(hd, dtype) == lanes


@pytest.mark.parametrize("hd,dtype", [(8, torch.bfloat16), (24, torch.bfloat16),
                                      (256, torch.float32), (48, torch.float32)])
def test_lanes_per_row_refuses_rows_the_kernel_does_not_take(hd, dtype):
    with pytest.raises(ValueError):
        tpa.lanes_per_row(hd, dtype)


# ------------------------------------------- emulation of the split kernel

def _merge(m, l, acc, mo, lo, ao):
    mt = torch.maximum(m, mo)
    es, eo = torch.exp2(m - mt), torch.exp2(mo - mt)
    return mt, l * es + lo * eo, acc * es[..., None] + ao * eo[..., None]


def emulate(q, k_pool, v_pool, tables, index):
    """The split kernel's arithmetic in its order, in f32 torch."""
    B, H, hd = q.shape
    NB, bs, KV, _ = k_pool.shape
    MB = tables.shape[1]
    p = tpa.plan(MB, bs, H, KV)
    lpr = tpa.lanes_per_row(hd, k_pool.dtype)
    rg = 32 // lpr                                   # lane groups of a warp
    step = tpa.WARPS * rg * tpa.ROWS
    rep = H // KV
    c = torch.tensor(hd ** -0.5, dtype=torch.float32) * torch.tensor(math.log2(math.e),
                                                                      dtype=torch.float32)
    qs = q.float() * c
    k, v = k_pool.float(), v_pool.float()
    out = torch.empty((B, H, hd), dtype=torch.float32)
    neg = torch.tensor(tpa.NEG_INF, dtype=torch.float32)
    for b in range(B):
        last = min(int(index[b]), MB * bs - 1)
        parts = []
        for s in range(p.splits):
            p0 = s * p.per * bs
            n = max(0, min(last + 1 - p0, p.per * bs))
            # state of each lane group (warp, group) and head
            m = torch.full((tpa.WARPS, rg, H), tpa.NEG_INF)
            l = torch.zeros((tpa.WARPS, rg, H))
            acc = torch.zeros((tpa.WARPS, rg, H, hd))
            mine = (torch.arange(tpa.WARPS)[:, None] * rg + torch.arange(rg)[None, :])
            for t in range(-(-n // step)):
                sc, vv, ok = [], [], []
                for u in range(tpa.ROWS):
                    pos = t * step + u * tpa.WARPS * rg + mine           # (WARPS, rg)
                    valid = pos < n
                    cell = p0 + pos
                    blk = tables[b, (cell // bs).clamp(max=MB - 1)].long().clamp(0, NB - 1)
                    kk = torch.where(valid[..., None, None], k[blk, cell % bs], 0.0)
                    kk = kk.repeat_interleave(rep, dim=2)                # (W, rg, H, hd)
                    sc.append(torch.where(valid[..., None], (qs[b] * kk).sum(-1), neg))
                    vv.append(torch.where(valid[..., None, None], v[blk, cell % bs], 0.0)
                              .repeat_interleave(rep, dim=2))
                    ok.append(valid)
                m_new = torch.stack([m] + sc).amax(0)
                moved = m_new > m + tpa.RESCALE
                corr = torch.where(moved, torch.exp2(m - m_new), torch.ones(()))
                l, acc = l * corr, acc * corr[..., None]
                m = torch.where(moved, m_new, m)
                for u in range(tpa.ROWS):
                    pr = torch.where(ok[u][..., None], torch.exp2(sc[u] - m), torch.zeros(()))
                    l = l + pr
                    acc = acc + pr[..., None] * vv[u]
            o = 1
            while o < rg:                                 # xor butterfly over groups
                partner = torch.arange(rg) ^ o
                m, l, acc = _merge(m, l, acc, m[:, partner], l[:, partner], acc[:, partner])
                o *= 2
            m, l, acc = m[:, 0], l[:, 0], acc[:, 0]      # (WARPS, H[, hd])
            mt = m.amax(0)
            lt, at = torch.zeros(H), torch.zeros((H, hd))
            for w in range(tpa.WARPS):                    # warps in order
                e = torch.exp2(m[w] - mt)
                lt, at = lt + l[w] * e, at + acc[w] * e[:, None]
            parts.append((mt, lt, at))
        mt = torch.stack([x[0] for x in parts]).amax(0)
        lt, at = torch.zeros(H), torch.zeros((H, hd))
        for ms, ls, acs in parts:                         # splits in order
            e = torch.exp2(ms - mt)
            lt, at = lt + ls * e, at + acs * e[:, None]
        out[b] = at / lt[:, None]
    return out


def _case(B, H, KV, hd, bs, MB, seed, index=None, full=False):
    rng = np.random.default_rng(seed)
    NB = B * MB + 1
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp = rng.normal(size=(NB, bs, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(NB, bs, KV, hd)).astype(np.float32)
    tables = np.zeros((B, MB), np.int32)
    free = list(range(1, NB))
    idx = np.zeros((B,), np.int32)
    for b in range(B):
        n_lease = MB if full else int(rng.integers(1, MB + 1))
        for j in range(n_lease):
            tables[b, j] = free.pop()
        idx[b] = int(rng.integers(0, n_lease * bs))
    if index is not None:
        idx[:] = index
    return q, kp, vp, tables, idx


def _poison(kp, vp, tables, index):
    """The null block and every cell past each slot's horizon, whole splits
    past it included, set to +-1e4."""
    kp, vp = kp.copy(), vp.copy()
    bs = kp.shape[1]
    for b in range(tables.shape[0]):
        for j in range(tables.shape[1]):
            for t in range(bs):
                if j * bs + t > index[b] and tables[b, j]:
                    kp[tables[b, j], t], vp[tables[b, j], t] = -1e4, -1e4
    kp[0], vp[0] = 1e4, 1e4
    return kp, vp


def _to_torch(q, kp, vp, tables, index, bf16=False):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, kp, vp, tables, index)]
    if bf16:
        t[1], t[2] = t[1].to(torch.bfloat16), t[2].to(torch.bfloat16)
    return t


def _pallas(q, kp, vp, tables, index, bf16=False):
    if bf16:
        kp, vp = jnp.asarray(kp).astype(jnp.bfloat16), jnp.asarray(vp).astype(jnp.bfloat16)
    return np.asarray(pallas_paged(q, kp, vp, tables, index, interpret=True))


CASES = {
    # GQA rep 4, 3 splits of 8 entries, partial leases: splits past the horizon
    "gqa_partial": dict(B=3, H=8, KV=2, hd=16, bs=4, MB=24, seed=1),
    # 8 splits of 8 entries
    "gqa_long": dict(B=2, H=8, KV=2, hd=16, bs=4, MB=64, seed=2),
    # horizons at 0, on both sides of the first split boundary (per * bs = 32),
    # at the table's last cell and past it (an idle slot), full leases
    "edges": dict(B=6, H=8, KV=2, hd=16, bs=4, MB=24, seed=3, full=True,
                  index=[0, 31, 32, 95, 96 + 40, 50]),
    # MHA, one split
    "mha": dict(B=3, H=4, KV=4, hd=8, bs=8, MB=3, seed=4),
    # one KV head for 8 query heads, wide rows (LPR 8), 2 splits
    "mqa": dict(B=2, H=8, KV=1, hd=32, bs=8, MB=8, seed=5),
}


# every case in f32 pools, and in bf16 where its rows are wide enough for
# the kernel (hd 8 in bf16 is 16 bytes)
POOLS = [(name, bf16) for name in sorted(CASES) for bf16 in (False, True)
         if CASES[name]["hd"] * (2 if bf16 else 4) in tpa.ROW_BYTES]


@pytest.mark.parametrize("name,bf16", POOLS)
def test_emulated_split_kernel_matches_pallas(name, bf16):
    case = _case(**CASES[name])
    out = emulate(*_to_torch(*case, bf16=bf16)).numpy()
    np.testing.assert_allclose(out, _pallas(*case, bf16=bf16), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, tpa.paged_decode_attention_plain(
        *_to_torch(*case, bf16=bf16)).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32_pool", "bf16_pool"])
@pytest.mark.parametrize("name", ["gqa_partial", "edges", "gqa_long"])
def test_emulated_split_kernel_ignores_poisoned_cells(name, bf16):
    """The null block and every cell past a horizon, whole splits past it
    included, at +-1e4: the output must not move from the clean Pallas
    result."""
    q, kp, vp, tables, index = _case(**CASES[name])
    kx, vx = _poison(kp, vp, tables, index)
    out = emulate(*_to_torch(q, kx, vx, tables, index, bf16=bf16)).numpy()
    np.testing.assert_allclose(out, _pallas(q, kp, vp, tables, index, bf16=bf16),
                               rtol=1e-5, atol=1e-5)


def test_emulated_slot_alone_equals_slot_in_batch():
    """The plan ignores B, so a slot served alone runs the same reduction."""
    q, kp, vp, tables, index = _to_torch(*_case(**CASES["gqa_partial"]))
    batch = emulate(q, kp, vp, tables, index)
    for b in range(q.shape[0]):
        alone = emulate(q[b:b + 1], kp, vp, tables[b:b + 1], index[b:b + 1])
        assert torch.equal(alone[0], batch[b])
