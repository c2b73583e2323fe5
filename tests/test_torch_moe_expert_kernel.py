"""The routed experts' kernel pair (repro_torch.kernels.moe_expert) on the CPU,
and on the card where one is present.

The pair's plain version is the plain route of ``moe.expert_outputs``
(``moe.plain_experts``: the experts dequantized to bf16, then batched
products of exactly (E, 32, D) over zero-padded queues), which every CPU
forward takes. On the CPU the kernel route of ``expert_outputs`` runs with
the pair's contract stood in for, on data whose every sum is exact, and
must put each pair's output where the plain route does, bit for bit. The
queues the kernels read are counted on the device (``scatter_add_`` and an
exclusive cumsum) and must equal ``torch.bincount``'s. The wrappers refuse
what the kernels do not take and have no CPU mode; on meta tensors they
return the result's shape and record the call with the accounting context;
float experts (training) never reach them.

The tests marked ``cuda`` (skipped here with a reason) hold the kernel
route to the plain route on the card, bit for bit, and a row's bits to its
batchmates and to the tile size.
"""

import pytest
import torch

from repro_torch import accounting, tracing
from repro_torch.configs import get_config
from repro_torch.core.tensorizer import QTensor
from repro_torch.kernels import moe_expert as K
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

E, TOPK = 64, 6


def _cfg(d, f):
    return get_config("deepseek-moe-16b").smoke().replace(
        d_model=d, d_ff=f, n_experts=E, topk=TOPK)


def _weights(gen, d, f, device="cpu"):
    """Seeded int8 experts ``wi``, ``wg`` (E, d, f) and ``wo`` (E, f, d)
    with positive per-column f32 scales, as the quantized tree holds them."""
    def q(k, n):
        codes = torch.randint(-128, 128, (E, k, n), generator=gen, dtype=torch.int8)
        scale = torch.rand((E, 1, n), generator=gen) * 0.02 + 0.001
        return QTensor(codes.to(device), scale.to(device), (E, k, n))
    return {"wi": q(d, f), "wg": q(d, f), "wo": q(f, d)}


def _routing(gen, T, hot=None):
    """(T * TOPK,) expert ids, TOPK distinct a token; with ``hot`` every
    token picks expert ``hot`` first and its others among the rest."""
    ids = torch.argsort(torch.rand((T, E), generator=gen), dim=1)[:, :TOPK]
    if hot is not None:
        rest = torch.argsort(torch.rand((T, E - 1), generator=gen), dim=1)[:, :TOPK - 1]
        rest = rest + (rest >= hot).long()
        ids = torch.cat([torch.full((T, 1), hot), rest], dim=1)
    return ids.reshape(-1)


def _exact(gen, T, d, f):
    """Weights and tokens on which every sum of both routes is exact: unit
    scales, tokens of 0s and 1s, ``wi`` codes of 0, 6 or 7 (so each
    ``x @ wi`` is 0 or at least 6, where bf16's ``silu`` op by op is exact:
    0, or the value itself) and ``wg``/``wo`` codes in -2..2."""
    def q(k, n, values):
        codes = values[torch.randint(len(values), (E, k, n), generator=gen)]
        return QTensor(codes.to(torch.int8), torch.ones((E, 1, n)), (E, k, n))
    p = {"wi": q(d, f, torch.tensor([0, 6, 7])), "wg": q(d, f, torch.arange(-2, 3)),
         "wo": q(f, d, torch.arange(-2, 3))}
    return p, (torch.rand((T, d), generator=gen) < 0.3).to(torch.bfloat16)


def _contract(a, w, s):
    """``a @ W(w, s)`` in f64 (exact here), rounded once to bf16."""
    return (a.double() @ (w.double() * s.double())).to(torch.bfloat16)


def _swiglu_stand_in(x, rows, offsets, counts, wi, si, wg, sg):
    """``moe_expert_swiglu``'s contract, expert by expert over its queue."""
    h = torch.empty((rows.shape[0], wi.shape[2]), dtype=torch.bfloat16)
    for e in range(wi.shape[0]):
        lo, n = int(offsets[e]), int(counts[e])
        xe = x[rows[lo:lo + n].long()]
        h[lo:lo + n] = L.silu(_contract(xe, wi[e], si[e])) * _contract(xe, wg[e], sg[e])
    return h


def _down_stand_in(h, pairs, offsets, counts, wo, so, n_tokens):
    """``moe_expert_down``'s contract, expert by expert over its queue."""
    out = torch.empty((pairs.shape[0], wo.shape[2]), dtype=torch.bfloat16)
    for e in range(wo.shape[0]):
        lo, n = int(offsets[e]), int(counts[e])
        out[pairs[lo:lo + n].long()] = _contract(h[lo:lo + n], wo[e], so[e])
    return out


CASES = {
    # name: (tokens, hot expert or None, routing kept to the first few experts)
    "decode_64x6": (64, None, None),
    "prefill_2x300": (600, None, None),
    "empty_experts": (40, None, 10),
    "one_expert_every_token": (48, 5, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_kernel_route_puts_each_pair_where_the_plain_route_does(case, monkeypatch):
    """``expert_outputs``' kernel route (queues, token rows, pair order)
    with the pair's contract stood in for, its plain route, and each pair
    computed alone (token n // k through expert ``experts[n]``): the same
    bits, on data whose sums are exact. The plain route takes one pass and
    one host read at or below EXPERT_ROWS tokens, more above; the kernel
    route one pass and none."""
    T, hot, few = CASES[case]
    d, f = 32, 48
    gen = torch.Generator().manual_seed(len(case))
    p, x = _exact(gen, T, d, f)
    experts = _routing(gen, T, hot)
    if few is not None:
        experts = experts % few    # experts few.. E - 1 get no pairs
    cfg = _cfg(d, f)
    monkeypatch.setattr(K, "moe_expert_swiglu", _swiglu_stand_in)
    monkeypatch.setattr(K, "moe_expert_down", _down_stand_in)
    tracing.enable()
    try:
        plain = MOE.expert_outputs(p, x, experts, T, cfg)
        monkeypatch.setattr(MOE, "takes_kernel", lambda p, x: True)
        kernel = MOE.expert_outputs(p, x, experts, T, cfg)
    finally:
        tracing.disable()
    alone = torch.empty_like(plain)
    for n in range(T * TOPK):
        e, xt = int(experts[n]), x[n // TOPK][None]
        h = L.silu(_contract(xt, p["wi"].q[e], p["wi"].scale[e])) * _contract(
            xt, p["wg"].q[e], p["wg"].scale[e])
        alone[n] = _contract(h, p["wo"].q[e], p["wo"].scale[e])[0]
    assert plain.dtype == kernel.dtype == torch.bfloat16
    assert plain.shape == kernel.shape == (T * TOPK, d)
    assert torch.equal(kernel, plain) and torch.equal(plain, alone)
    spans = [(s.attrs["route"], s.attrs["passes"], s.attrs["host_reads"])
             for s in tracing.take() if s.name == "moe.experts"]
    passes = -(-int(torch.bincount(experts).max()) // MOE.EXPERT_ROWS)
    assert spans == [("plain", passes, 1 if T <= MOE.EXPERT_ROWS else 2), ("kernel", 1, 0)]
    counts = torch.bincount(experts, minlength=E)
    if few is not None:
        assert (counts[few:] == 0).all()
    if hot is not None:
        assert int(counts[hot]) == T > MOE.EXPERT_ROWS


@pytest.mark.parametrize("T,seed", [(1, 0), (64, 1), (600, 2)])
def test_device_queues_are_bincount_and_its_exclusive_cumsum(T, seed):
    gen = torch.Generator().manual_seed(seed)
    experts = _routing(gen, T)
    counts, offsets, order = K.queues(experts, E)
    ref = torch.bincount(experts, minlength=E)
    assert counts.dtype == offsets.dtype == torch.int32
    assert torch.equal(counts.long(), ref)
    assert torch.equal(offsets.long(), torch.cumsum(ref, 0) - ref)
    assert torch.equal(order, torch.argsort(experts, stable=True))
    sorted_ids = experts[order]
    for e in range(E):
        lo, n = int(offsets[e]), int(counts[e])
        assert (sorted_ids[lo:lo + n] == e).all()


def _args(d=32, f=48, P=12, device="meta"):
    gen = torch.Generator().manual_seed(7)
    p = _weights(gen, d, f)
    x = torch.randn((4, d), generator=gen).to(torch.bfloat16)
    experts = torch.arange(P) % E
    counts, offsets, order = K.queues(experts, E)
    rows = (order // 3).to(torch.int32)
    args = [x, rows, offsets, counts, p["wi"].q, p["wi"].scale, p["wg"].q, p["wg"].scale]
    return [t.to(device) for t in args]


BAD = {
    "codes_not_int8": (4, lambda t: t.to(torch.int16), TypeError),
    "codes_wrong_rank": (4, lambda t: t[0], ValueError),
    "gate_other_shape": (6, lambda t: t[:, :16], ValueError),
    "scales_not_per_column": (5, lambda t: t[:, :, :8].contiguous(), ValueError),
    "scales_f64": (5, lambda t: t.double(), ValueError),
    "x_not_bf16": (0, lambda t: t.float(), TypeError),
    "x_other_width": (0, lambda t: t[:, :16].contiguous(), ValueError),
    "rows_int64": (1, lambda t: t.long(), TypeError),
    "counts_other_length": (3, lambda t: t[:8].contiguous(), ValueError),
    "codes_not_contiguous": (4, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
                             ValueError),
    "x_not_contiguous": (0, lambda t: torch.cat([t, t], 1)[:, ::2], ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    """On meta tensors, where only the wrapper's checks can raise."""
    i, spoil, err = BAD[case]
    args = _args()
    args[i] = spoil(args[i])
    with pytest.raises(err):
        K.moe_expert_swiglu(*args)


def test_down_refuses_rows_that_do_not_match_the_pairs():
    args = _args()
    h = K.moe_expert_swiglu(*args)
    wo = _weights(torch.Generator().manual_seed(1), 32, 48, "meta")["wo"]
    K.moe_expert_down(h, args[1], args[2], args[3], wo.q, wo.scale, 4)
    with pytest.raises(ValueError, match="rows for"):
        K.moe_expert_down(h[:-1].contiguous(), args[1], args[2], args[3], wo.q, wo.scale, 4)


@pytest.mark.parametrize("which", ["swiglu", "down"])
def test_the_wrappers_have_no_cpu_mode(which):
    """CPU tensors take ``moe.expert_outputs``' plain route, never a wrapper."""
    args = _args(device="cpu")
    launches = (K.moe_expert_swiglu.launches, K.moe_expert_down.launches)
    with pytest.raises(ValueError, match="plain route"):
        if which == "swiglu":
            K.moe_expert_swiglu(*args)
        else:
            wo = _weights(torch.Generator().manual_seed(1), 32, 48)["wo"]
            h = torch.zeros((args[1].shape[0], 48), dtype=torch.bfloat16)
            K.moe_expert_down(h, args[1], args[2], args[3], wo.q, wo.scale, 4)
    assert (K.moe_expert_swiglu.launches, K.moe_expert_down.launches) == launches


def test_the_meta_route_returns_the_shapes_and_records_its_calls():
    d, f, P = 2048, 1408, 63 * TOPK
    meta = torch.device("meta")

    def q(k, n):
        return (torch.empty((E, k, n), dtype=torch.int8, device=meta),
                torch.empty((E, 1, n), dtype=torch.float32, device=meta))
    x = torch.empty((63, d), dtype=torch.bfloat16, device=meta)
    idx = torch.empty((P,), dtype=torch.int32, device=meta)
    qe = torch.empty((E,), dtype=torch.int32, device=meta)
    launches = (K.moe_expert_swiglu.launches, K.moe_expert_down.launches)
    with accounting.Accounting() as acc:
        h = K.moe_expert_swiglu(x, idx, qe, qe, *q(d, f), *q(d, f))
        out = K.moe_expert_down(h, idx, qe, qe, *q(f, d), 63)
    assert (h.shape, h.dtype, h.device) == ((P, f), torch.bfloat16, meta)
    assert (out.shape, out.dtype, out.device) == ((P, d), torch.bfloat16, meta)
    assert acc.kernel_calls("moe_expert_swiglu") == acc.kernel_calls("moe_expert_down") == 1
    assert acc.kernels["moe_expert_swiglu"]["flops"] == 4 * P * d * f
    assert acc.kernels["moe_expert_down"]["flops"] == 2 * P * f * d
    assert (K.moe_expert_swiglu.launches, K.moe_expert_down.launches) == launches


def test_float_experts_still_reach_bmm_and_not_the_kernels(monkeypatch):
    d, f, T = 32, 48, 40
    gen = torch.Generator().manual_seed(3)
    p = {n: torch.randn(s, generator=gen) for n, s in
         (("wi", (E, d, f)), ("wg", (E, d, f)), ("wo", (E, f, d)))}
    calls = []
    real = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda a, b: calls.append(a.shape) or real(a, b))
    for name in ("moe_expert_swiglu", "moe_expert_down"):
        monkeypatch.setattr(K, name, lambda *a, **k: pytest.fail("float experts took the kernel"))
    x = torch.randn((T, d), generator=gen)
    out = MOE.expert_outputs(p, x, _routing(gen, T), T, _cfg(d, f))
    assert out.shape == (T * TOPK, d)
    assert calls and all(s[1:] == (MOE.EXPERT_ROWS, d) or s[1:] == (MOE.EXPERT_ROWS, f)
                         for s in calls)


@pytest.mark.parametrize("w,dtype,device,takes", [
    ("int8", torch.bfloat16, "cpu", False),
    ("int8", torch.bfloat16, "meta", False),
    ("float", torch.bfloat16, "meta", False),
    ("int8", torch.float32, "meta", False),
])
def test_only_int8_experts_in_a_bf16_forward_on_a_card_take_the_kernel(w, dtype, device,
                                                                       takes):
    q = torch.empty((E, 8, 16), dtype=torch.int8, device=device)
    wi = QTensor(q, torch.empty((E, 1, 16), device=device)) if w == "int8" else q.float()
    x = torch.empty((4, 8), dtype=dtype, device=device)
    assert MOE.takes_kernel({"wi": wi}, x) is takes


@pytest.mark.parametrize("tokens,rows,slices", [
    (1, 16, 1), (16, 16, 1), (63, 16, 1), (85, 16, 1), (86, 64, 2), (1024, 64, 16),
    (2048, 64, 32), (4096, 64, 32)])
def test_the_plan_follows_the_pairs_an_expert_and_the_longest_queue(tokens, rows, slices):
    assert K.plan(tokens * TOPK, tokens, E) == (rows, slices)


# ------------------------------------------------------------------ the card

D_CELL, F_CELL = 2048, 1408     # deepseek-moe-16b's expert widths


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the moe_expert kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(T, hot, seed):
    gen = torch.Generator().manual_seed(seed)
    p = _weights(gen, D_CELL, F_CELL, "cuda")
    experts = _routing(gen, T, hot).cuda()
    x = torch.randn((T, D_CELL), generator=gen).to(torch.bfloat16).cuda()
    return p, x, experts


@pytest.mark.cuda
@pytest.mark.parametrize("T,hot", [(63, None), (1024, None), (1024, 3)])
def test_the_kernels_match_the_plain_version_on_the_card(cuda_device, T, hot):
    """``expert_outputs``' kernel route, one launch of each kernel, bit for
    bit its plain route (``plain_experts``) at the cell's widths: 63 decode
    tokens, a 1024-token chunk, and 1024 tokens that all pick expert 3."""
    p, x, experts = _card_case(T, hot, T)
    cfg = _cfg(D_CELL, F_CELL)
    launches = (K.moe_expert_swiglu.launches, K.moe_expert_down.launches)
    out = MOE.expert_outputs(p, x, experts, T, cfg)
    assert (K.moe_expert_swiglu.launches, K.moe_expert_down.launches) == tuple(
        n + 1 for n in launches)
    plain = MOE.plain_experts(p, x, experts, T, cfg)[0]
    torch.cuda.synchronize()
    assert torch.equal(out, plain)


@pytest.mark.cuda
def test_a_rows_bits_follow_neither_its_batchmates_nor_the_tile(cuda_device):
    """Token 0's outputs alone (16-row tiles), within 63 tokens (16-row
    tiles) and within 1024 (64-row tiles), bit for bit."""
    p, x, experts = _card_case(1024, None, 11)
    cfg = _cfg(D_CELL, F_CELL)
    outs = [MOE.expert_outputs(p, x[:n], experts[:n * TOPK], n, cfg)[:TOPK]
            for n in (1, 63, 1024)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
