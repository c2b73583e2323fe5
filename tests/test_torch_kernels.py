"""Port parity: the port's kernel wrappers (repro_torch.kernels) against the
JAX package's kernels and oracles.

On the CPU a wrapper runs its plain PyTorch version; the CUDA kernels run
only on a card (tests marked ``cuda``, skipped here with a reason).

Tolerances
  * qgemm int32 accumulation: EXACT (integer arithmetic).
  * qgemm f32 output vs ``ref.qgemm_ref`` / ``ops.qgemm_f32(interpret=True)``:
    rtol = atol = 1e-6, the JAX kernel contract (tests/test_kernels.py).
  * qgemm with per-row ``sa`` vs pdot's formula: bitwise (same f32 ops in the
    same order, one rounding to bf16).
  * paged attention vs the Pallas kernel in interpret mode: 1e-5 — the
    Pallas kernel's online softmax and the plain full-row softmax differ
    only by f32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.kernels.paged_attention import paged_decode_attention as pallas_paged
from repro_torch.kernels import qgemm as tq
from repro_torch.kernels import paged_attention as tpa

RNG = np.random.default_rng(42)


def _i8(shape, rng=RNG):
    return rng.integers(-127, 128, shape).astype(np.int8)


# ----------------------------------------------------------------- qgemm

@pytest.mark.parametrize("M,K,N,bk", [
    (128, 512, 128, 512),
    (256, 512, 256, 256),
    (128, 1024, 384, 512),
])
def test_qgemm_plain_matches_jax(M, K, N, bk):
    aq, bq = _i8((M, K)), _i8((K, N))
    sb = RNG.uniform(1e-3, 1e-2, (N,)).astype(np.float32)
    out = tq.qgemm(torch.from_numpy(aq), torch.from_numpy(bq),
                   torch.from_numpy(sb)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref.qgemm_ref(aq, bq, sb)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        out, np.asarray(ops.qgemm_f32(aq, bq, sb, bk=bk, interpret=True)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("M,K,N", [(128, 512, 128), (7, 5632, 33), (1, 2048, 256)])
def test_qgemm_int32_exact(M, K, N):
    """int8 x int8 -> int32 accumulation is bit-exact, including the
    worst case |acc| = K * 127^2 that a wrapping int8 matmul would ruin."""
    aq, bq = _i8((M, K)), _i8((K, N))
    aq[0, :] = 127
    bq[:, 0] = 127
    ones = torch.ones(N)
    out = tq.qgemm(torch.from_numpy(aq), torch.from_numpy(bq), ones).numpy()
    expect = aq.astype(np.int64) @ bq.astype(np.int64)
    assert np.array_equal(out.astype(np.int64), expect)
    assert out[0, 0] == K * 127 * 127


@pytest.mark.parametrize("M,K,N", [(3, 70, 19), (13, 130, 257), (1, 64, 5)])
def test_qgemm_row_scales_match_pdot_formula(M, K, N):
    """Unaligned shapes with per-row activation scales, bf16 out: equal to
    pdot's ``(acc.f32 * (sa * sb)).astype(bf16)`` bit for bit."""
    aq, bq = _i8((M, K)), _i8((K, N))
    sa = RNG.uniform(1e-3, 1e-1, (M,)).astype(np.float32)
    sb = RNG.uniform(1e-3, 1e-1, (N,)).astype(np.float32)
    out = tq.qgemm(torch.from_numpy(aq), torch.from_numpy(bq), torch.from_numpy(sb),
                   sa=torch.from_numpy(sa), out_dtype=torch.bfloat16)
    acc = (aq.astype(np.int64) @ bq.astype(np.int64)).astype(np.float32)
    expect = jnp.asarray(acc * (sa[:, None] * sb[None, :])).astype(jnp.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(expect.astype(jnp.float32)))


@pytest.mark.parametrize("bad", ["a_dtype", "b_dtype", "sb_dtype", "k_mismatch",
                                 "sb_shape", "sa_shape", "out_dtype", "noncontig",
                                 "rank"])
def test_qgemm_rejects_bad_inputs(bad):
    a = torch.zeros(4, 8, dtype=torch.int8)
    b = torch.zeros(8, 6, dtype=torch.int8)
    sb = torch.ones(6)
    kw = {}
    if bad == "a_dtype":
        a = a.float()
    elif bad == "b_dtype":
        b = b.to(torch.int32)
    elif bad == "sb_dtype":
        sb = sb.double()
    elif bad == "k_mismatch":
        b = torch.zeros(9, 6, dtype=torch.int8)
    elif bad == "sb_shape":
        sb = torch.ones(5)
    elif bad == "sa_shape":
        kw["sa"] = torch.ones(3)
    elif bad == "out_dtype":
        kw["out_dtype"] = torch.float16
    elif bad == "noncontig":
        b = torch.zeros(6, 8, dtype=torch.int8).T
    elif bad == "rank":
        a = a[None]
    with pytest.raises((TypeError, ValueError)):
        tq.qgemm(a, b, sb, **kw)


# -------------------------------------------------------- paged attention

def _paged_case(B, H, KV, hd, bs, MB, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    NB = B * MB + 1
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k_pool = rng.normal(size=(NB, bs, KV, hd)).astype(dtype)
    v_pool = rng.normal(size=(NB, bs, KV, hd)).astype(dtype)
    tables = np.zeros((B, MB), np.int32)
    free = list(range(1, NB))
    index = np.zeros((B,), np.int32)
    for b in range(B):
        n_lease = int(rng.integers(1, MB + 1))         # partial leases incl. full
        for j in range(n_lease):
            tables[b, j] = free.pop()
        index[b] = int(rng.integers(0, n_lease * bs))  # horizon inside lease
    return q, k_pool, v_pool, tables, index


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,H,KV,hd,bs,MB", [
    (2, 4, 4, 8, 4, 2),       # MHA
    (3, 4, 2, 8, 4, 3),       # GQA rep=2
    (2, 8, 1, 16, 8, 2),      # MQA
])
def test_paged_attention_plain_matches_pallas(B, H, KV, hd, bs, MB):
    case = _paged_case(B, H, KV, hd, bs, MB)
    out = tpa.paged_decode_attention(*_torch(*case)).numpy()
    expect = np.asarray(pallas_paged(*case, interpret=True))
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)


def test_paged_attention_plain_bf16_pool_matches_pallas():
    """The main path's pool dtype: bf16 cells, f32 math on both sides."""
    q, kp, vp, tables, index = _paged_case(3, 8, 2, 16, 4, 3, seed=5)
    kb = jnp.asarray(kp).astype(jnp.bfloat16)
    vb = jnp.asarray(vp).astype(jnp.bfloat16)
    expect = np.asarray(pallas_paged(q, kb, vb, tables, index, interpret=True))
    tk = torch.from_numpy(np.array(kb.astype(jnp.float32))).to(torch.bfloat16)
    tv = torch.from_numpy(np.array(vb.astype(jnp.float32))).to(torch.bfloat16)
    out = tpa.paged_decode_attention(torch.from_numpy(q), tk, tv,
                                     torch.from_numpy(tables),
                                     torch.from_numpy(index)).numpy()
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)


def test_paged_attention_masks_beyond_horizon():
    """Poisoning the null block and every cell past each slot's horizon must
    not move the output: those positions get weight exactly 0."""
    q, k_pool, v_pool, tables, index = _paged_case(2, 4, 2, 8, 4, 3, seed=1)
    clean = tpa.paged_decode_attention(*_torch(q, k_pool, v_pool, tables, index))
    kp, vp = k_pool.copy(), v_pool.copy()
    kp[0] = 1e6
    vp[0] = 1e6
    bs = k_pool.shape[1]
    for b in range(tables.shape[0]):
        for j in range(tables.shape[1]):
            blk = tables[b, j]
            if blk == 0:
                continue
            for t in range(bs):
                if j * bs + t > index[b]:
                    kp[blk, t] = -1e6
                    vp[blk, t] = -1e6
    poisoned = tpa.paged_decode_attention(*_torch(q, kp, vp, tables, index))
    np.testing.assert_allclose(poisoned.numpy(), clean.numpy(), rtol=1e-5, atol=1e-5)
    expect = np.asarray(pallas_paged(q, kp, vp, tables, index, interpret=True))
    np.testing.assert_allclose(poisoned.numpy(), expect, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["q_dtype", "pool_dtype", "tables_dtype",
                                 "index_dtype", "heads", "hd", "batch",
                                 "noncontig"])
def test_paged_attention_rejects_bad_inputs(bad):
    q, kp, vp, tables, index = _torch(*_paged_case(2, 4, 2, 8, 4, 3))
    if bad == "q_dtype":
        q = q.double()
    elif bad == "pool_dtype":
        kp, vp = kp.to(torch.int8), vp.to(torch.int8)
    elif bad == "tables_dtype":
        tables = tables.long()
    elif bad == "index_dtype":
        index = index.long()
    elif bad == "heads":
        q = torch.zeros(2, 3, 8)
    elif bad == "hd":
        q = torch.zeros(2, 4, 16)
    elif bad == "batch":
        index = index[:1].contiguous()
    elif bad == "noncontig":
        q = torch.zeros(2, 8, 4).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        tpa.paged_decode_attention(q, kp, vp, tables, index)


# ------------------------------------------------- on the card (CUDA only)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_qgemm_kernel_matches_plain_on_card(cuda_device):
    """Both regimes (M <= 16 and above), split and unsplit K, ragged and
    unaligned M, N and K (the staged path), and operands holding int8's -128:
    bitwise against the plain version, int32 sums exactly."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    shapes = [(M, K, N) for M in (1, 8, 16, 17, 128)
              for K, N in ((2048, 256), (5632, 2048), (2048, 32000))]
    shapes += [(37, 130, 257), (7, 5632, 33), (13, 130, 257), (20, 32, 64),
               (4096, 1024, 1024)]
    splits = set()
    for M, K, N in shapes:
        splits.add(tq.plan(M, K, N, sms).splits > 1)
        a = torch.randint(-128, 128, (M, K), generator=gen, device=cuda_device,
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (K, N), generator=gen, device=cuda_device,
                          dtype=torch.int8)
        a[0, :], b[:, 0] = -128, -128
        sb = torch.rand(N, generator=gen, device=cuda_device) * 1e-2
        sa = torch.rand(M, generator=gen, device=cuda_device) * 1e-1
        ones = torch.ones(N, device=cuda_device)
        acc = tq.qgemm(a, b, ones)
        assert torch.equal(acc, tq.qgemm_plain(a, b, ones))
        assert torch.equal(acc.double(), a.double() @ b.double())
        assert torch.equal(tq.qgemm(a, b, sb), tq.qgemm_plain(a, b, sb))
        assert torch.equal(tq.qgemm(a, b, sb, sa, torch.bfloat16),
                           tq.qgemm_plain(a, b, sb, sa, torch.bfloat16))
    assert splits == {False, True}


@pytest.mark.cuda
@pytest.mark.parametrize("MB,horizons", [
    (6, None),                                  # partial leases, 3 splits
    (10, [0, 31, 32, 63, 159, 159 + 40, 100, 5]),   # split edges, last cell, idle slot
    (128, [2047] * 8),                          # the 2048-token context, 8 splits
])
def test_paged_attention_kernel_matches_plain_on_card(cuda_device, MB, horizons):
    """The split kernel (and its combine) against the plain version with bf16
    pools, then with the null block and every cell past each horizon
    poisoned; two launches bitwise equal."""
    q, kp, vp, tables, index = _paged_case(8, 32, 4, 64, 16, MB, seed=2)
    if horizons is not None:
        tables = np.arange(1, 8 * MB + 1, dtype=np.int32).reshape(8, MB)   # full leases
        index = np.asarray(horizons, np.int32)
    q, kp, vp, tables, index = [t.to(cuda_device) for t in _torch(q, kp, vp, tables, index)]
    kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    out = tpa.paged_decode_attention(q, kp, vp, tables, index)
    expect = tpa.paged_decode_attention_plain(q, kp, vp, tables, index)
    torch.testing.assert_close(out, expect, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, tpa.paged_decode_attention(q, kp, vp, tables, index))
    pos = torch.arange(MB * 16, device=cuda_device).reshape(MB, 16)
    past = pos[None] > index[:, None, None]
    blk = tables[:, :, None].expand(-1, -1, 16)[past].long()
    cell = torch.arange(16, device=cuda_device).expand(8, MB, 16)[past]
    kp[blk, cell], vp[blk, cell] = -1e4, -1e4
    kp[0], vp[0] = 1e4, 1e4
    torch.testing.assert_close(tpa.paged_decode_attention(q, kp, vp, tables, index), out,
                               rtol=1e-5, atol=1e-5)
