#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one JSON line each:

  1. card     — name and power limit (nvidia-smi), device count
  2. build    — nvcc builds of every kernel under src/repro_torch/kernels/csrc,
                with ptxas' registers and spills
  3. kernels  — each kernel against its plain PyTorch version on the card at
                its paths' shapes (qgemm: int32-exact and the bf16 pdot
                epilogue bitwise, in both regimes of its plan and both split
                paths, ragged shapes and -128 operands included; paged
                attention: partial leases, horizons on split boundaries, at
                0, at the last cell and past S, the 2048-token context,
                poisoned cells, and the engine's prefill rows at the serve
                batch's and the chunked phase's shapes, 1e-5;
                tile-scales GEMM bitwise; stencil bitwise at shapes on its
                plan's edges (W % 4 != 0, H = 1, W = 1, H around a strip
                boundary, an unaligned view), and on int8 codes bitwise
                against an int64 sum; qgemv within rtol 2e-4 / atol 1e-4
                on both its paths (B from 1 to 16, ragged K, K shorter than
                the cluster's stages, weights only 4-byte aligned), its
                fp64 error at most 4x the plain version's, two launches
                bitwise equal, bad operands refused), then timed beside its
                plain version, a PyTorch library yardstick and its bound,
                with each launch plan
  4. ops      — the public kernel entries (repro_torch.kernels.ops: qgemm_f32,
                qgemm_i32, qgemm_tiles, stencil, qgemv) on the card against
                the same entries on CPU copies, each launching its kernel
                exactly once
  5. serve    — the serving path at full width: tinyllama-1.1b W8A8, fused
                prefill-with-cache admission, block-native paged decode
                through qgemm and paged attention (repro_torch.launch.serve;
                prefill's queries attend through the kernel too, one launch
                per layer of every forward), with every kernel's launch
                count read around the run; a second run of the same traffic
                must give the same tokens
  6. batch_invariance — each request of the serve traffic served alone
                (one slot: qgemm at M = 1, not 8) gives the tokens it got in
                the batched run
  7. reference — the full-width model on the card against the same model
                on the CPU through the plain versions (f32 compute dtype:
                the kernel route's prefill and three decode steps)
  8. decode_profile — host time of a served decode step beside the device
                time torch.profiler sees in it, qgemm's and paged
                attention's shares of it, and its top kernels; then the
                RMSNorm's fixed-tree row sum against one torch.sum, in turns
  9. stores   — the serve traffic through the contiguous store, the paged
                gather bridge and block-native decode without the kernel:
                tokens and every valid cache entry bitwise equal, qgemm 155
                launches per forward and no paged-attention launch on each;
                each route's TTFT, prefill wait and peak device memory; the
                kernel route held to the plain one by check_reference's
                rule at f32
 10. int8_kv  — the same with the int8 KV cache through those three routes
                and the kernel route (which attends by the plain
                contraction: no paged-attention launch); the quantizer's
                codes and scales card against CPU, bitwise
 11. chunked  — prompts of 1536 and 1900 tokens admitted by 256-token
                chunks and by single-shot fused prefill: first tokens, the
                seeded pool and the decoded tokens bitwise, and each
                admission's peak device memory; the same prompts fused on
                the contiguous store, for its admission time and memory
 12. prefix_cache — the serve traffic with a shared half-prompt preamble,
                with and without the prefix radix cache: tokens bitwise,
                hits, reused blocks and positions, TTFT, launches, and
                every block free or cached unreferenced after draining
 13. sampling — the serve traffic on the main path with the CLI's sampling
                mix (even requests sampled at temperature 0.8, top-k 50,
                top-p 0.9), a stop pair and logprobs: greedy requests keep
                their serve streams, sampled ones their streams alone and
                on a second run; threefry, the uniform and the Gumbel noise
                and sample_tokens card against CPU; Engine.embed's logits
                row bitwise the fused prefill's; tok/s, TTFT, the sampled
                and greedy decode step and the sampler's device time
 14. speculative — greedy draft-verify decode (spec_k = 4) on the serve
                traffic, contiguous, gather bridge and block-native plain,
                with the target's weights and other weights as the draft:
                tokens and retire-time cache rows bitwise plain decode's,
                the good draft's acceptance within the length budget 1.0,
                qgemm launches per round, the census after draining
 15. fleet    — the serve traffic through the serving fleet, tokens bitwise
                the serve phase's: a Router over two in-process engines
                (affinity hits, spills, tok/s and TTFT beside the single
                engine's); prefill:1,decode:1 disaggregation (ships and no
                fallback, no prefill on the decode host, the census after
                draining, each ship's export, frame and import ms and
                bytes); host 0 drained mid-run (handoffs, and request 0's
                continuation cut points all clean), on the kernel route and
                on the contiguous store (tokens bitwise the stores phase's
                contiguous run); each in-process run's launches held to its
                forwards; two worker
                processes (boot s, RPC p50/p99, tok/s, pids, exited); the
                HTTP API (a completion, an SSE stream, a classify)
 16. gptpu    — the GPTPU library path: the card's instruction table and
                the tpuGemm lowering it picks, tpuGemm at 4096^3 in both
                lowerings against an fp64 product, the seven applications
                at n = 1024 (quantized) under the paper's Table-4 limits and
                hotspot3d's fp path, with each kernel's launches read around
                each call and checked where the path fixes them
 17. gptpu_reference — the applications on the card against the same
                applications on the CPU through the plain versions
 18. gptpu_profile — each application's host wall time beside the device
                time torch.profiler sees in it, and its top kernels

then the ``{"kernels": [...]}`` line (all five kernels, each with its
launches on each path: serve, stores, int8_kv, chunked, prefix_cache,
sampling, speculative, fleet (its in-process runs), gptpu and ops; ``ms`` and
``library_ms`` there are device times, from CUDA graphs) and, last, the
``{"ok": true, ...}`` line. Any failed check exits nonzero before the last
line.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import types
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT8_OPS_PER_S = 1.979e15      # H100 SXM dense int8 tensor-core peak
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores

ROOT = Path(__file__).resolve().parent
SERVE_ARGS = ["--arch", "tinyllama-1.1b", "--quantize", "serve",
              "--cache-backend", "paged", "--paged-native", "--paged-kernel",
              "--slots", "8", "--requests", "8", "--prompt-len", "128",
              "--gen", "32", "--stagger-steps", "2", "--device", "cuda"]


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def phase(label, **fields):
    print(json.dumps({"phase": label, **fields}), flush=True)


def time_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from CUDA
    events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed once: the launches run back to back on the card with
    no host work between them. ``time_ms`` of the same calls issued eagerly
    from Python also counts the host's time per call where that is longer."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


L2_BYTES = 50e6                # H100 L2 cache


def cold_copies(make, nbytes):
    """Enough independent copies of an operand (``make()`` each) that cycling
    through them streams more than twice the L2 cache: each timed call then
    reads its operand from device memory, as a decode step reads each
    layer's weights and pool once."""
    return [make() for _ in range(max(2, int(2 * L2_BYTES // nbytes) + 1))]


def sms_of(dev):
    import torch
    return torch.cuda.get_device_properties(dev).multi_processor_count


def plan_of(module, *args):
    """The launch plan ``module.plan(*args)`` as JSON (None for a module
    without one)."""
    fn = getattr(module, "plan", None)
    if fn is None:
        return None
    p = fn(*args)
    return p._asdict() if hasattr(p, "_asdict") else list(p)


# --------------------------------------------------------------- qgemm

def bound(moved_bytes, ops, ops_per_s):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def qgemm_bound(M, K, N, out_bytes=2):
    """Each input read once (int8 A and B, f32 scales), the output written once."""
    moved = M * K + K * N + 4 * (M + N) + out_bytes * M * N
    return bound(moved, 2 * M * K * N, INT8_OPS_PER_S)


def check_qgemm(dev):
    """Bitwise against the plain version (and the int32 sums against an fp64
    product) in both regimes of the kernel's plan and both split paths: M in
    {1, 8, 16} (decode) and {17, 40, 128, 1024} at the five projection pairs,
    ragged and unaligned shapes (the kernel's staged path), decode shapes
    whose tiles fill the card unsplit, every operand
    holding int8's -128 in a row of A and a column of B."""
    import torch
    from repro_torch.kernels.qgemm import _sm_count, plan, qgemm, qgemm_plain
    gen = torch.Generator(device=dev).manual_seed(1)
    pairs = [(2048, 256), (2048, 2048), (2048, 5632), (5632, 2048), (2048, 32000)]
    # M = 40: the verify window of speculative decode (8 slots x 5 positions)
    cases = [(M, K, N) for M in (1, 8, 16, 17, 40, 128, 1024) for K, N in pairs]
    cases += [(37, 130, 257), (7, 5632, 33), (13, 130, 257), (20, 32, 64), (3, 32, 4096),
              (16, 1024, 40960)]
    sms = _sm_count(torch.device(dev).index or 0)
    paths = set()
    max_err = 0.0
    for M, K, N in cases:
        p = plan(M, K, N, sms)
        paths.add(("decode" if M <= 16 else "large", "split" if p.splits > 1 else "whole"))
        a = torch.randint(-128, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-128, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        a[0, :], b[:, 0] = -128, -128
        ones = torch.ones(N, device=dev)
        acc = qgemm(a, b, ones)
        exact = (a.double() @ b.double())
        check(torch.equal(acc.double(), exact), f"qgemm int32 accumulation {M}x{K}x{N}")
        sb = torch.rand(N, generator=gen, device=dev) * 1e-2 + 1e-4
        sa = torch.rand(M, generator=gen, device=dev) * 1e-1 + 1e-3
        out = qgemm(a, b, sb, sa, torch.bfloat16)
        ref = qgemm_plain(a, b, sb, sa, torch.bfloat16)
        check(torch.equal(out, ref), f"qgemm bf16 pdot epilogue {M}x{K}x{N}")
        out32 = qgemm(a, b, sb)
        max_err = max(max_err, float((out32 - qgemm_plain(a, b, sb)).abs().max()))
    check(max_err == 0.0, f"qgemm f32 output differs from plain by {max_err}")
    check(len(paths) == 4, f"qgemm cases took only the plan paths {sorted(paths)}")
    torch.cuda.synchronize()
    return {"cases": len(cases), "plan_paths": sorted("/".join(x) for x in paths),
            "max_abs_err": max_err}


def time_qgemm(dev):
    """Kernel, plain and library times at every main-path projection shape:
    decode (M = 8 slots), the speculative verify window (M = 40 = 8 slots x
    5 positions) and one admission (M = 128 = one 128-token bucket),
    with the weight operand cold (``cold_copies``). ``ms``, ``plain_ms`` and
    ``library_ms`` are eager means (``time_ms``), which at these sizes count
    the host's time per call; ``graph_ms`` and ``library_graph_ms`` are
    device times (``graph_ms``). ``plan`` is the kernel's launch plan."""
    import itertools
    import torch
    from repro_torch.kernels.qgemm import _sm_count, plan, qgemm, qgemm_plain
    gen = torch.Generator(device=dev).manual_seed(2)
    sms = _sm_count(torch.device(dev).index or 0)
    rows = []
    for M in (8, 40, 128):
        for K, N in ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000)):
            a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
            bs = cold_copies(lambda: torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                                                   dtype=torch.int8), K * N)
            sb = torch.rand(N, generator=gen, device=dev) * 1e-2
            sa = torch.rand(M, generator=gen, device=dev) * 1e-1
            cyc = itertools.cycle(bs)
            ms = time_ms(lambda: qgemm(a, next(cyc), sb, sa, torch.bfloat16), 50)
            g_ms = graph_ms(lambda: qgemm(a, next(cyc), sb, sa, torch.bfloat16), 50)
            plain = time_ms(lambda: qgemm_plain(a, next(cyc), sb, sa, torch.bfloat16), 10)
            lib = lib_graph = None
            if M > 16 and K % 8 == 0 and N % 8 == 0:   # torch._int_mm's limits
                lib = time_ms(lambda: torch._int_mm(a, next(cyc)), 50)
                lib_graph = graph_ms(lambda: torch._int_mm(a, next(cyc)), 50)
            bound_ms, by = qgemm_bound(M, K, N)
            rows.append({"M": M, "K": K, "N": N, "ms": ms, "graph_ms": g_ms,
                         "plain_ms": plain, "library_ms": lib, "library_graph_ms": lib_graph,
                         "bound_ms": bound_ms, "bound_by": by,
                         "plan": list(plan(M, K, N, sms))})
            del bs
    return rows


# ----------------------------------------------------- paged attention

def paged_case(dev, B=8, H=32, KV=4, hd=64, bs=16, MB=10, seed=3):
    """Main-path shapes: 8 slots, 160-token rows in 16-token blocks, partial
    leases, horizons inside each lease, bf16 pools."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    NB = B * MB + 1
    q = torch.randn((B, H, hd), generator=gen)
    k = torch.randn((NB, bs, KV, hd), generator=gen).to(torch.bfloat16)
    v = torch.randn((NB, bs, KV, hd), generator=gen).to(torch.bfloat16)
    tables = torch.zeros((B, MB), dtype=torch.int32)
    index = torch.zeros((B,), dtype=torch.int32)
    free = list(range(1, NB))
    for b in range(B):
        n_lease = int(torch.randint(MB // 2, MB + 1, (1,), generator=gen))
        for j in range(n_lease):
            tables[b, j] = free.pop()
        index[b] = int(torch.randint(0, n_lease * bs, (1,), generator=gen))
    return [t.to(dev) for t in (q, k, v, tables, index)]


def paged_bound(q, k_pool, tables, index):
    """Bytes: q and out in f32, the tables and index, and the K and V cells
    of every position this run's horizons reach. Operations: q.k and p.v,
    2*hd each per head and position, on the f32 units."""
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    S = tables.shape[1] * k_pool.shape[1]
    positions = int((index.clamp(max=S - 1) + 1).sum())     # cells this run reads
    moved = (2 * B * H * hd * 4 + tables.numel() * 4 + index.numel() * 4
             + 2 * positions * KV * hd * k_pool.element_size())
    return bound(moved, 4 * positions * H * hd, F32_OPS_PER_S)


def paged_full_case(dev, index, MB, B=8, H=32, KV=4, hd=64, bs=16, seed=5):
    """Every lease full (MB entries per slot, no null block in a table) and
    the horizons given: ``index`` may run past the S = MB * bs cells, as an
    idle slot's does."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    NB = B * MB + 1
    q = torch.randn((B, H, hd), generator=gen)
    k = torch.randn((NB, bs, KV, hd), generator=gen).to(torch.bfloat16)
    v = torch.randn((NB, bs, KV, hd), generator=gen).to(torch.bfloat16)
    tables = torch.randperm(NB - 1, generator=gen)[:B * MB].reshape(B, MB).int() + 1
    return [t.to(dev) for t in (q, k, v, tables, torch.tensor(index, dtype=torch.int32))]


def poisoned(k, v, tables, index):
    """Copies of the pools with the null block at 1e4 and every cell of every
    slot past its horizon at -1e4: whole splits past the horizon included."""
    import torch
    kp, vp = k.clone(), v.clone()
    B, MB = tables.shape
    bs = k.shape[1]
    pos = torch.arange(MB * bs, device=k.device).reshape(MB, bs)
    past = pos[None] > index[:, None, None]                  # (B, MB, bs)
    blk = tables[:, :, None].expand(B, MB, bs)[past].long()
    t = torch.arange(bs, device=k.device).expand(B, MB, bs)[past]
    kp[blk, t], vp[blk, t] = -1e4, -1e4
    kp[0], vp[0] = 1e4, 1e4
    return kp, vp


def prefill_rows_case(dev, B, Sq, length, start=0, seed=9, H=32, KV=4, hd=64, bs=16):
    """The kernel's operands as an engine prefill builds them
    (models/attention.py ``decode_row_operands``): B rows of Sq queries at
    positions start..start+Sq-1, each query a kernel row over its row's
    table of decode's width length // bs in a scratch pool; K/V of the
    start + Sq positions written so far (the rest of the row zero), bf16."""
    import torch
    from repro_torch.models import attention as A
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Sq, H, hd), generator=gen)
    k, v = (torch.randn((B, start + Sq, KV, hd), generator=gen).to(torch.bfloat16)
            for _ in range(2))
    positions = (start + torch.arange(Sq, dtype=torch.int32)).expand(B, Sq)
    return list(A.decode_row_operands(q.to(dev), k.to(dev), v.to(dev), positions.to(dev),
                                      A.DecodeRows(length, bs)))


def plain_in_slices(q, k, v, tables, index, rows=128):
    """The plain version ``rows`` kernel rows at a time (its gathered,
    head-expanded f32 view of a prefill case would not fit at once)."""
    import torch
    from repro_torch.kernels.paged_attention import paged_decode_attention_plain
    return torch.cat([paged_decode_attention_plain(q[i:i + rows], k, v, tables[i:i + rows],
                                                   index[i:i + rows])
                      for i in range(0, q.shape[0], rows)])


def check_paged(dev):
    """Against the plain version at rtol = atol = 1e-5 (the online softmax
    and the plain full-row softmax differ only by f32 rounding), in every
    case; two launches bitwise equal; in the decode cases, with the null
    block and every cell past each horizon poisoned the output must not
    move (a prefill case's rows share their blocks, so a cell past one
    query's horizon lies inside another's). Decode cases: the serving shape
    (partial leases); its horizons on and beside split boundaries, at 0, at
    the table's last cell and past S (an idle slot); the long-context shape
    (MB = 128) with every horizon at the last cell, and with mixed horizons
    whose slots leave whole splits past the horizon; MHA with f32 pools in
    one split. Prefill cases, the main path's prefill shapes: the serve
    traffic's batch (8 rows x 128 queries, horizons 0..127, tables of
    decode's 10 blocks) and the chunked phase's last 256-query piece of two
    2048-position rows (MB = 128, horizons 1792..2047)."""
    import torch
    from repro_torch.kernels.paged_attention import paged_decode_attention, plan
    per = plan(10, 16, 32, 4).per * 16                       # positions per split
    prefill = {
        "prefill_serving": prefill_rows_case(dev, 8, 128, 160),
        "prefill_chunked": prefill_rows_case(dev, 2, CHUNK_W, CHUNK_SEQ,
                                             start=CHUNK_SEQ - CHUNK_W, seed=10),
    }
    cases = {
        "serving": paged_case(dev),
        "serving_edges": paged_full_case(
            dev, [0, per - 1, per, 2 * per - 1, 2 * per, 159, 159 + 37, 100], 10),
        "long_full": paged_full_case(dev, [2047] * 8, 128, seed=6),
        "long_edges": paged_full_case(
            dev, [0, 127, 128, 1023, 1024, 2047, 2047 + 500, 5], 128, seed=7),
        "mha_f32": [t.float() if t.dtype == torch.bfloat16 else t for t in
                    paged_case(dev, B=3, H=4, KV=4, hd=16, bs=8, MB=3, seed=4)],
        **prefill,
    }
    out_rows, max_err = {}, 0.0
    for name, (q, k, v, tables, index) in cases.items():
        out = paged_decode_attention(q, k, v, tables, index)
        ref = plain_in_slices(q, k, v, tables, index)
        err = float((out - ref).abs().max())
        check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
              f"paged attention ({name}) err {err}")
        check(torch.equal(out, paged_decode_attention(q, k, v, tables, index)),
              f"paged attention ({name}): two launches differ")
        if name not in prefill:
            kp, vp = poisoned(k, v, tables, index)
            pois = paged_decode_attention(q, kp, vp, tables, index)
            check(torch.allclose(pois, out, rtol=1e-5, atol=1e-5),
                  f"paged attention ({name}) leaks masked cells")
        B, H, _ = q.shape
        p = plan(tables.shape[1], k.shape[1], H, k.shape[2])
        out_rows[name] = {"max_abs_err": err, "plan": list(p), "blocks": p.blocks(B, H),
                          "B": B, "MB": tables.shape[1],
                          "index": index.tolist() if name not in prefill else
                          [int(index.min()), int(index.max())]}
        max_err = max(max_err, err)
    check(out_rows["long_full"]["plan"][0] > 1 and out_rows["mha_f32"]["plan"][0] == 1
          and out_rows["prefill_chunked"]["plan"][0] > 1,
          f"paged attention cases missed the split or the one-split path: {out_rows}")
    torch.cuda.synchronize()
    return {"cases": out_rows, "max_abs_err": max_err}


def time_paged(dev):
    """Kernel, plain and library times at the serving shape and at the
    long-context shape (8 slots, MB = 128: tinyllama's 2048-token context,
    every lease full, every horizon at the last cell), pools cold. ``ms``,
    ``plain_ms`` and ``library_ms`` are eager means (``time_ms``);
    ``graph_ms`` and ``library_graph_ms`` device times (``graph_ms``)."""
    import itertools
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain, plan)
    rows = []
    for name, case in (("serving", paged_case(dev)),
                       ("long", paged_full_case(dev, [2047] * 8, 128, seed=8))):
        q, k, v, tables, index = case
        # cold pools: each layer of a decode step reads its own pool once
        pools = itertools.cycle(cold_copies(lambda: (k.clone(), v.clone()),
                                            2 * k.numel() * k.element_size()))
        ms = time_ms(lambda: paged_decode_attention(q, *next(pools), tables, index), 100)
        g_ms = graph_ms(lambda: paged_decode_attention(q, *next(pools), tables, index), 100)
        plain = time_ms(lambda: paged_decode_attention_plain(q, *next(pools), tables, index),
                        20 if name == "serving" else 5)
        del pools
        # yardstick: SDPA over the already-gathered, head-expanded bf16 view
        B, H, hd = q.shape
        S = tables.shape[1] * k.shape[1]
        rep = H // k.shape[2]

        def gathered(pool):
            g = pool[tables.reshape(-1).long()].reshape(B, S, -1, hd).repeat_interleave(rep, 2)
            return g.transpose(1, 2).contiguous()

        views = itertools.cycle(cold_copies(lambda: (gathered(k), gathered(v)),
                                            2 * B * H * S * hd * k.element_size()))
        qb = q.to(torch.bfloat16)[:, :, None]
        mask = (torch.arange(S, device=dev)[None, :] <= index[:, None])[:, None, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(qb, *next(views), attn_mask=mask),
                      100)
        lib_graph = graph_ms(lambda: F.scaled_dot_product_attention(qb, *next(views),
                                                                    attn_mask=mask), 100)
        del views
        bound_ms, by = paged_bound(q, k, tables, index)
        rows.append({"shape": name, "B": B, "MB": tables.shape[1],
                     "plan": list(plan(tables.shape[1], k.shape[1], H, k.shape[2])),
                     "ms": ms, "graph_ms": g_ms, "plain_ms": plain, "library_ms": lib,
                     "library_graph_ms": lib_graph, "bound_ms": bound_ms, "bound_by": by})
    return rows


# ---------------------------------------------------- tile-scales GEMM

TILE = 128


def tile_case(dev, M, K, N, gen):
    import torch
    a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
    sa = torch.rand((M // TILE, K // TILE), generator=gen, device=dev) * 1e-2 + 1e-3
    sb = torch.rand((K // TILE, N // TILE), generator=gen, device=dev) * 1e-2 + 1e-3
    return a, b, sa, sb


def check_tile_scales(dev):
    """Bitwise against the plain k loop, whose int32 partials are exact
    float64 products and whose two roundings per step are the kernel's."""
    import torch
    from repro_torch.kernels.qgemm import qgemm_tile_scales, qgemm_tile_scales_plain
    gen = torch.Generator(device=dev).manual_seed(7)
    shapes = [(128, 256, 128), (1024, 1024, 1024), (4096, 4096, 4096)]
    max_err = 0.0
    for M, K, N in shapes:
        args = tile_case(dev, M, K, N, gen)
        out, ref = qgemm_tile_scales(*args), qgemm_tile_scales_plain(*args)
        max_err = max(max_err, float((out - ref).abs().max()))
        check(torch.equal(out, ref), f"qgemm_tile_scales differs from plain at {M}x{K}x{N}")
    torch.cuda.synchronize()
    return {"shapes": shapes, "bitwise": True, "max_abs_err": max_err}


def tile_bound(M, K, N):
    """int8 A and B and the f32 tile scales read once, f32 out written once."""
    moved = M * K + K * N + 4 * (M * K + K * N) // TILE ** 2 + 4 * M * N
    return bound(moved, 2 * M * K * N, INT8_OPS_PER_S)


def time_tile_scales(dev):
    """At 1024^3 and 4096^3, operands cold, eager means and device times (as
    in ``time_qgemm``). Library yardstick: torch._int_mm on the same int8
    operands, which computes the int32 product without the tile scales and
    their f32 accumulation, so it is a lower yardstick."""
    import itertools
    import torch
    from repro_torch.kernels.qgemm import qgemm_tile_scales, qgemm_tile_scales_plain
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for n in (1024, 4096):
        cases = itertools.cycle(cold_copies(lambda: tile_case(dev, n, n, n, gen), 2 * n * n))
        ms = time_ms(lambda: qgemm_tile_scales(*next(cases)), 20)
        g_ms = graph_ms(lambda: qgemm_tile_scales(*next(cases)), 20)
        plain = time_ms(lambda: qgemm_tile_scales_plain(*next(cases)), 3)
        lib = time_ms(lambda: torch._int_mm(*next(cases)[:2]), 20)
        lib_graph = graph_ms(lambda: torch._int_mm(*next(cases)[:2]), 20)
        bound_ms, by = tile_bound(n, n, n)
        rows.append({"M": n, "K": n, "N": n, "ms": ms, "graph_ms": g_ms, "plain_ms": plain,
                     "library_ms": lib, "library_graph_ms": lib_graph,
                     "bound_ms": bound_ms, "bound_by": by})
    return rows


# ------------------------------------------------------------- stencil

def check_stencil(dev):
    """Bitwise against the plain version (the same nine multiply-adds from
    zero, in the same order, each rounded), at shapes on the plan's edges:
    W % 4 in {1, 2, 3} (width 1), H = 1 and W = 1, H one row under, at and
    over a strip boundary, and a contiguous view whose base is not 16-byte
    aligned (width 1 though W % 4 == 0); on int8 codes as f32, bitwise
    against the int64 sum computed on the card (every partial sum < 2^24)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import stencil3x3 as ts
    gen = torch.Generator(device=dev).manual_seed(9)
    sms = sms_of(dev)
    shapes = [(64, 128), (100, 300), (257, 129), (4096, 4096),
              (37, 129), (64, 130), (50, 131), (1, 1), (1, 256), (77, 1),
              (1023, 1024), (1025, 1024), (4095, 4096), (4097, 4096), (4095, 4095)]
    cases = [(H, W, False) for H, W in shapes] + [(96, 256, True), (1023, 1024, True)]
    max_abs = max_rel = 0.0
    plans = []
    for H, W, offset in cases:
        if offset:
            x = torch.randn(H * W + 1, generator=gen, device=dev)[1:].view(H, W)
        else:
            x = torch.randn((H, W), generator=gen, device=dev)
        w = torch.randn((3, 3), generator=gen, device=dev)
        out, ref = ts.stencil3x3(x, w), ts.stencil3x3_plain(x, w)
        err = float((out - ref).abs().max())
        max_abs, max_rel = max(max_abs, err), max(max_rel, err / float(ref.abs().max()))
        check(torch.equal(out, ref), f"stencil3x3 differs from plain at {H}x{W}"
                                     f"{' (offset view)' if offset else ''}")
        p = ts.plan(H, W, x.data_ptr() % 16 == 0, sms)
        check(not offset or p.width == 1, "stencil3x3: an unaligned view took width 4")
        plans.append({"H": H, "W": W, "offset_view": offset, "width": p.width,
                      "rows": p.rows, "H_mod_rows": H % p.rows})
    xq = torch.randint(-127, 128, (1024, 1024), generator=gen, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3), generator=gen, device=dev, dtype=torch.int8)
    xq[0, 0] = wq[1, 1] = 127
    xp = F.pad(xq.long(), (1, 1, 1, 1))
    exact = sum(wq[p, q].long() * xp[p:p + 1024, q:q + 1024] for p in range(3) for q in range(3))
    codes = ts.stencil3x3(xq.float(), wq.float())
    check(torch.equal(codes, exact.float()), "stencil3x3 on int8 codes is not exact")
    torch.cuda.synchronize()
    return {"cases": plans, "bitwise": True, "max_abs_err": max_abs,
            "max_rel_err": max_rel, "codes_1024x1024_exact": True}


def stencil_bound(H, W):
    """The field read once and written once (f32), 9 multiplies and 9 adds
    per cell on the f32 units."""
    return bound(8 * H * W + 36, 18 * H * W, F32_OPS_PER_S)


def time_stencil(dev):
    """At 1024^2 and 4096^2, the field cold: eager means and device times (as
    in ``time_qgemm``), with the kernel's plan. Library yardstick: F.conv2d
    on the (1, 1, H, W) field with TF32 off."""
    import itertools
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import stencil3x3 as ts
    from repro_torch.kernels.stencil3x3 import stencil3x3, stencil3x3_plain
    gen = torch.Generator(device=dev).manual_seed(10)
    w = torch.randn((3, 3), generator=gen, device=dev)
    w4 = w[None, None]
    cudnn = torch.backends.cudnn
    rows = []
    for n in (1024, 4096):
        xs = itertools.cycle(cold_copies(lambda: torch.randn((n, n), generator=gen, device=dev),
                                         4 * n * n))
        ms = time_ms(lambda: stencil3x3(next(xs), w), 50)
        g_ms = graph_ms(lambda: stencil3x3(next(xs), w), 50)
        plain = time_ms(lambda: stencil3x3_plain(next(xs), w), 10)
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            lib = time_ms(lambda: F.conv2d(next(xs)[None, None], w4, padding=1), 50)
            lib_graph = graph_ms(lambda: F.conv2d(next(xs)[None, None], w4, padding=1), 50)
        bound_ms, by = stencil_bound(n, n)
        rows.append({"H": n, "W": n, "ms": ms, "graph_ms": g_ms, "plain_ms": plain,
                     "library_ms": lib, "library_graph_ms": lib_graph,
                     "bound_ms": bound_ms, "bound_by": by,
                     "plan": plan_of(ts, n, n, True, sms_of(dev))})
    return rows


def time_qgemm_gptpu(dev):
    """qgemm at the GPTPU path's shapes, f32 out with unit or per-channel
    scales: pagerank's mat-vec (M = 1, n = 1024: the adjacency operand cold)
    and the quantized conv2D lowering of tpuGemm at 4096 (patches 64 x 64,
    so K = 4096); eager means and device times, as in ``time_qgemm``."""
    import itertools
    import torch
    from repro_torch.kernels.qgemm import qgemm, qgemm_plain
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for M, K, N in ((1, 1024, 1024), (4096, 4096, 4096)):
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
        bs = itertools.cycle(cold_copies(lambda: torch.randint(
            -127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8), K * N))
        sb = torch.rand(N, generator=gen, device=dev) * 1e-2
        ms = time_ms(lambda: qgemm(a, next(bs), sb), 50)
        g_ms = graph_ms(lambda: qgemm(a, next(bs), sb), 50)
        plain = time_ms(lambda: qgemm_plain(a, next(bs), sb), 10)
        lib = time_ms(lambda: torch._int_mm(a, next(bs)), 50) if M > 16 else None
        lib_graph = graph_ms(lambda: torch._int_mm(a, next(bs)), 50) if M > 16 else None
        bound_ms, by = qgemm_bound(M, K, N, out_bytes=4)
        rows.append({"M": M, "K": K, "N": N, "ms": ms, "graph_ms": g_ms, "plain_ms": plain,
                     "library_ms": lib, "library_graph_ms": lib_graph,
                     "bound_ms": bound_ms, "bound_by": by})
    return rows


# ---------------------------------------------------------------- qgemv

QGEMV_PAIRS = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000))
QGEMV_ERR_RATIO = 4.0   # the kernel's fp64 error may be at most this times the plain's

# check_qgemv's cases, (B, K, N, w offset by 4 bytes from an aligned base):
# B from 1 to 16, K not a multiple of a stage, K shorter than the cluster's
# stages (a rank with no k), weights only 4-byte aligned; on 132 SMs they
# take every kernel variant in QGEMV_VARIANTS.
QGEMV_CASES = [(B, K, N, False) for B, K, N in (
    (1, 256, 256), (8, 384, 512), (3, 640, 768), (8, 2048, 256), (8, 2048, 32000),
    (2, 2048, 2048), (1, 5632, 2048), (5, 2048, 5632), (9, 5632, 2048), (16, 2048, 256),
    (8, 2048, 2048), (1, 2048, 5632), (2, 2048, 32000), (1, 2048, 32000),
    (8, 1000, 512), (8, 100, 256), (2, 130, 256))] + [(8, 704, 768, True),
                                                      (1, 704, 768, True)]
QGEMV_VARIANTS = frozenset(
    [f"tensor/tn{tn}" for tn in (128, 64, 32)] + [f"cores/tn{tn}" for tn in (128, 64)]
    + ["cores/depth4", "cores/depth8"]
    + [f"{path}/vec={v}" for path in ("tensor", "cores") for v in (True, False)])


def qgemv_variant(p, K, w_ptr, x_ptr):
    """The kernel variants a launch with plan ``p`` takes (csrc/qgemv.cu's
    template arguments): its path and stripe width, its loads in flight on
    the CUDA cores, and whether its copies are 16-byte (the tensor cores: w
    and x 16-byte aligned, K % 4 == 0) or its weight loads a lane's whole
    tn / 8 bytes (the CUDA cores: w that aligned)."""
    if p.mma:
        vec = w_ptr % 16 == 0 and x_ptr % 16 == 0 and K % 4 == 0
        return {f"tensor/tn{p.tn}", f"tensor/vec={vec}"}
    return {f"cores/tn{p.tn}", f"cores/depth{p.depth}", f"cores/vec={w_ptr % (p.tn // 8) == 0}"}


def qgemv_bound(B, K, N):
    """The int8 weights, x and the scales read once, the f32 output written
    once; 2*B*K*N operations on the f32 units."""
    return bound(K * N + 4 * B * K + 4 * N + 4 * B * N, 2 * B * K * N, F32_OPS_PER_S)


def check_qgemv(dev):
    """Against the plain version within rtol 2e-4 / atol 1e-4 (the JAX
    contract, tests/test_kernels.py), with TF32 off around the plain
    version's matmul (PyTorch's default; the port sets it nowhere); two
    launches on the same inputs bitwise equal; the error against an fp64
    product (max |diff| over max |product|) at most ``QGEMV_ERR_RATIO`` times
    the plain version's at every shape. Shapes on the plan's edges: B in
    {1, 2, 3, 5, 8, 9, 16}, K not a multiple of a stage, K shorter than the
    cluster's stages (a rank with no k), weights only 4-byte aligned; the
    cases must take every kernel variant in ``QGEMV_VARIANTS``. Bad operands
    raise."""
    import torch
    from repro_torch.kernels import qdot_serve as tqs
    from repro_torch.kernels.qdot_serve import qgemv, qgemv_plain
    gen = torch.Generator(device=dev).manual_seed(12)
    sms = sms_of(dev)
    rows = []
    variants = set()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for f32 matmuls")
    for B, K, N, offset in QGEMV_CASES:
        x = torch.randn((B, K), generator=gen, device=dev)
        if offset:
            flat = torch.randint(-128, 128, (K * N + 4,), generator=gen, device=dev,
                                 dtype=torch.int8)
            w = flat[4:].view(K, N)
        else:
            w = torch.randint(-128, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        w[0, :2] = torch.tensor([-128, 127], dtype=torch.int8)    # both ends of int8
        s = torch.rand(N, generator=gen, device=dev) * 9e-3 + 1e-3
        p = tqs.plan(B, K, N, sms)
        variant = qgemv_variant(p, K, w.data_ptr(), x.data_ptr())
        variants |= variant
        out = qgemv(x, w, s)
        check(torch.equal(out, qgemv(x, w, s)), f"qgemv: two launches differ at {B}x{K}x{N}")
        ref = qgemv_plain(x, w, s)
        err = float((out - ref).abs().max())
        check(torch.allclose(out, ref, rtol=2e-4, atol=1e-4),
              f"qgemv differs from plain at {B}x{K}x{N}: max abs {err}")
        exact = (x.double() @ w.double()) * s.double()
        e_kernel = float((out.double() - exact).abs().max() / exact.abs().max())
        e_plain = float((ref.double() - exact).abs().max() / exact.abs().max())
        check(e_kernel <= QGEMV_ERR_RATIO * e_plain,
              f"qgemv at {B}x{K}x{N}: fp64 error {e_kernel} over {QGEMV_ERR_RATIO} x "
              f"the plain version's {e_plain}")
        rows.append({"B": B, "K": K, "N": N, "w_offset_4": offset, "max_abs_err": err,
                     "fp64_max_err_over_abs_max": e_kernel,
                     "plain_fp64_max_err_over_abs_max": e_plain,
                     "plan": p._asdict(), "variant": sorted(variant)})
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for f32 matmuls")
    check(variants == QGEMV_VARIANTS,
          f"qgemv cases missed the kernel variants {sorted(QGEMV_VARIANTS - variants)}")
    x = torch.zeros((2, 256), device=dev)
    s = torch.ones(256, device=dev)
    flat = torch.zeros(256 * 256 + 1, dtype=torch.int8, device=dev)
    bad = {"misaligned w_q": (x, flat[1:].view(256, 256), s),
           "N % 256 != 0": (x, torch.zeros((256, 384), dtype=torch.int8, device=dev),
                            torch.ones(384, device=dev)),
           "f32 w_q": (x, torch.zeros((256, 256), device=dev), s),
           "scale on the CPU": (x, flat[:-1].view(256, 256), s.cpu())}
    before = qgemv.launches
    for what, args in bad.items():
        try:
            qgemv(*args)
        except (TypeError, ValueError):
            continue
        raise SmokeFailure(f"qgemv accepted a bad operand ({what})")
    check(qgemv.launches == before, "qgemv launched on a bad operand")
    torch.cuda.synchronize()
    return {"shapes": rows, "variants": sorted(variants), "bitwise_repeat": True,
            "refused": sorted(bad),
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def time_weight_int8pack(x, ws, s):
    """(ms, None) of torch._weight_int8pack_mm, the same function with the
    weights as (N, K), on transposed copies of ``ws``, timed as ``graph_ms``;
    (None, the first line of its error) where the card's PyTorch has no
    kernel for it."""
    import itertools
    import torch
    wts = [w.t().contiguous() for w in ws]
    try:
        torch._weight_int8pack_mm(x, wts[0], s)
    except RuntimeError as e:
        return None, (str(e).splitlines() or [type(e).__name__])[0]
    cyc = itertools.cycle(wts)
    return graph_ms(lambda: torch._weight_int8pack_mm(x, next(cyc), s), 50), None


def time_qgemv(dev, qgemm_rows):
    """At B = 8 and B = 1 and the (K, N) of every serving projection, the
    weights cold. ``ms``, ``plain_ms`` and ``library_ms`` are device times
    (``graph_ms``): issued eagerly from Python the kernel's calls are
    host-bound (``eager_ms``, ``time_ms``). For information only, each row
    carries qgemm's W8A8 times at the same (M = 8, K, N) from ``time_qgemm``,
    another function (int8 activations, bf16 out): eager and device time;
    and the kernel's plan (stripe width, cluster size, k range, ring depth)."""
    import itertools
    import torch
    from repro_torch.kernels import qdot_serve as tqs
    from repro_torch.kernels.qdot_serve import qgemv, qgemv_plain
    gen = torch.Generator(device=dev).manual_seed(13)
    w8a8 = {(r["K"], r["N"]): r for r in qgemm_rows if r["M"] == 8}
    rows = []
    for B in (8, 1):
        for K, N in QGEMV_PAIRS:
            x = torch.randn((B, K), generator=gen, device=dev)
            s = torch.rand(N, generator=gen, device=dev) * 1e-2
            ws = cold_copies(lambda: torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                                                   dtype=torch.int8), K * N)
            cyc = itertools.cycle(ws)
            ms = graph_ms(lambda: qgemv(x, next(cyc), s), 50)
            eager = time_ms(lambda: qgemv(x, next(cyc), s), 50)
            plain = graph_ms(lambda: qgemv_plain(x, next(cyc), s), 10)
            lib, lib_error = time_weight_int8pack(x, ws, s)
            bound_ms, by = qgemv_bound(B, K, N)
            row = {"B": B, "K": K, "N": N, "ms": ms, "eager_ms": eager, "plain_ms": plain,
                   "library_ms": lib, "bound_ms": bound_ms, "bound_by": by,
                   "plan": plan_of(tqs, B, K, N, sms_of(dev))}
            if lib_error is not None:
                row["library_error"] = lib_error
            if B == 8 and (K, N) in w8a8:
                row["info_only_qgemm_w8a8_M8_ms"] = w8a8[(K, N)]["ms"]
                row["info_only_qgemm_w8a8_M8_graph_ms"] = w8a8[(K, N)]["graph_ms"]
            rows.append(row)
            del ws, cyc
    return rows


# -------------------------------------------------------------- main path

def serve_once():
    from repro_torch.launch import serve
    counters = all_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    reqs, stats = serve.run(SERVE_ARGS)
    wall = time.perf_counter() - t0
    return reqs, stats, wall, {k: c.launches for k, c in counters.items()}


def check_serve():
    from repro_torch.configs import get_config
    cfg = get_config("tinyllama-1.1b")
    reqs, stats, wall, launches = serve_once()
    gen = int(SERVE_ARGS[SERVE_ARGS.index("--gen") + 1])
    check(all(r.done and len(r.tokens) == gen for r in reqs), "a request did not finish")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.tokens), "token out of vocab")
    steps = stats["decode_steps"]
    # per forward: q, k, v, o, wi, wg, wo per layer, plus the lm_head; and on
    # this route every forward, decode step or prefill batch, attends
    # through the paged-attention kernel once per layer
    per_forward = 7 * cfg.n_layers + 1
    forwards = steps + stats["prefill_batches"]
    check(launches["paged_decode_attention"] == forwards * cfg.n_layers,
          f"paged attention launched {launches['paged_decode_attention']} times, "
          f"expected {forwards} forwards x {cfg.n_layers} layers")
    check(launches["qgemm"] == per_forward * forwards,
          f"qgemm launched {launches['qgemm']} times, expected {per_forward} x "
          f"{forwards} forwards")
    reqs2, _, _, _ = serve_once()
    check([r.tokens for r in reqs2] == [r.tokens for r in reqs],
          "a second run of the same traffic gave other tokens")
    return reqs, launches, {
        "requests": len(reqs), "decode_steps": steps,
        "prefill_batches": stats["prefill_batches"],
        "tokens_generated": stats["tokens_generated"],
        "sustained_tok_s": stats["sustained_tok_s"], "wall_s": wall,
        "prefill_wait_s": stats["prefill_wait_s"], "seed_write_s": stats["seed_write_s"],
        "mean_ttft_ms": 1e3 * sum(r.metrics.ttft_s for r in reqs) / len(reqs),
        "launches": launches,
    }


def check_batch_invariance(reqs):
    """Each request of the ``serve`` traffic served alone, by an engine of
    one slot built as ``serve.run`` builds its own (same weights, same
    prompt), must get the tokens it got in the batched run: there every
    decode step ran the 8 slots (qgemm at M = 8), here 1 (M = 1)."""
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, params, _, args = serve_setup()
    engine = Engine(cfg, params, EngineConfig(
        max_slots=1, max_queue=args.max_queue, max_seq_len=args.prompt_len + args.gen,
        cache_backend=args.cache_backend, block_size=args.block_size,
        paged_native=args.paged_native, paged_kernel=args.paged_kernel), device=args.device)
    t0 = time.perf_counter()
    try:
        for i, r in enumerate(reqs):
            alone = engine.submit(r.prompt, args.gen, strict=True)
            engine.run_until_complete()
            if alone.tokens != r.tokens:
                first = next((j for j, (x, y) in enumerate(zip(alone.tokens, r.tokens))
                              if x != y), min(len(alone.tokens), len(r.tokens)))
                raise SmokeFailure(f"request {i} served alone gave other tokens than in "
                                   f"the batch, from token {first} on")
    finally:
        engine.close()
    return {"requests": len(reqs), "tokens_compared": sum(len(r.tokens) for r in reqs),
            "same_tokens": True, "wall_s": time.perf_counter() - t0}


def _store_length(P, n_steps):
    """The positions of _prefill_then_decode's store rows: P prompt
    positions and whole 16-token blocks for the decode steps, one spare."""
    return P + 16 * ((n_steps + 15) // 16 + 1)


def _prefill_then_decode(params, cfg, tokens, n_steps, feed=None, use_kernel=True):
    """Prefill ``tokens`` (B, P) as an engine of this store's route does
    (each query a one-query decode row of the store's length, through the
    paged-attention kernel with ``use_kernel``), seed a paged store with the
    K/V, and run ``n_steps`` block-native decode steps (through the kernel
    with ``use_kernel``), feeding each step's greedy tokens (or
    ``feed[i]``). Returns the prefill logits, each decode step's logits, and
    the fed tokens."""
    import torch
    from repro_torch.models import attention as A, serve as SV
    from repro_torch.serving.store import PagedKVStore
    B, P = tokens.shape
    dev = tokens.device
    length = _store_length(P, n_steps)
    store = PagedKVStore(cfg, B, length, block_size=16, native=True, device=dev)
    for b in range(B):
        check(store.lease(b, P, n_steps + 1), "lease refused")
    logits, kv = SV.prefill_with_cache(params, cfg, tokens,
                                       A.DecodeRows(length, 16 if use_kernel else None))
    store.write_slots(list(range(B)), kv, [P] * B)
    toks = logits[:, -1].float().argmax(-1).to(torch.int32)[:, None]
    steps, fed = [], []
    for i in range(n_steps):
        if feed is not None:
            toks = feed[i].to(dev)
        fed.append(toks.cpu())
        out, cache = SV.decode_paged(params, cfg, store.decode_cache(), toks,
                                     use_kernel=use_kernel)
        store.swap(cache)
        steps.append(out[:, -1])
        toks = out[:, -1].float().argmax(-1).to(torch.int32)[:, None]
    return logits, steps, fed


def check_reference():
    """The full-width model on the card (kernels) against the same model on
    the CPU (plain versions), same weights and inputs, in the f32 compute
    dtype: a 16-token prefill of 2 prompts, as the kernel route's engine
    runs it (every query through the paged-attention kernel, its plain
    version on the CPU), and 3 block-native decode steps.

    Tolerance: RMS difference <= 1.5% and max <= 6% of the CPU logits'
    absolute max, and the same greedy token wherever the CPU's top-2 margin
    exceeds 0.3. Transcendentals and f32 sums differ in their last bits
    between the two devices, and the full-width W8A8 model amplifies a
    last-bit change: it moves int8 activation codes, 1/127 of a row's range
    each, and 22 layers carry them on. The phase reports that sensitivity
    beside the comparison: the CPU prefill again with every embedding entry
    moved by one f32 ulp. A broken kernel moves the logits by their whole
    size."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tensorizer as tz
    from repro_torch.launch.serve import quant_predicate
    from repro_torch.models import attention as A, init_model, serve as SV
    cfg = get_config("tinyllama-1.1b").replace(quantize="serve", dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tz.quantize_params(init_model(cfg, gen, device="cuda"),
                                predicate=quant_predicate)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(5))
    cpu_params = _to_cpu(params)
    c_pre, c_steps, fed = _prefill_then_decode(cpu_params, cfg, tokens, 3)
    g_pre, g_steps, _ = _prefill_then_decode(params, cfg, tokens.cuda(), 3, feed=fed)
    nudged = dict(cpu_params, embed=torch.nextafter(
        cpu_params["embed"], torch.full_like(cpu_params["embed"], float("inf"))))
    n_pre, _ = SV.prefill_with_cache(nudged, cfg, tokens,
                                     A.DecodeRows(_store_length(16, 3), 16))
    dn = (n_pre.float() - c_pre.float()).abs()
    out = {"cpu_one_ulp_embed_sensitivity": {
        "max_abs_diff": float(dn.max()), "rms_diff": float(dn.pow(2).mean().sqrt()),
        "abs_max": float(c_pre.float().abs().max())}}
    for name, g, c in [("prefill", g_pre, c_pre)] + [
            (f"decode{i}", g, c) for i, (g, c) in enumerate(zip(g_steps, c_steps))]:
        g, c = g.float().cpu(), c.float()
        check(bool(torch.isfinite(g).all()), f"non-finite {name} logits on the card")
        d = (g - c).abs()
        scale, rms = float(c.abs().max()), float(d.pow(2).mean().sqrt())
        check(float(d.max()) <= 0.06 * scale and rms <= 0.015 * scale,
              f"card vs CPU {name} logits: max {float(d.max())}, rms {rms}, "
              f"scale {scale}")
        top2 = c.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 0.3
        check(torch.equal(g.argmax(-1)[clear], c.argmax(-1)[clear]),
              f"card and CPU pick different clear greedy tokens ({name})")
        out[name] = {"max_abs_diff": float(d.max()), "rms_diff": rms, "abs_max": scale,
                     "clear_tokens_compared": int(clear.sum())}
    return out


def profile_decode():
    """Where a served decode step's time goes: the bf16 W8A8 model at full
    width, 8 slots of 128-token prompts, block-native decode. Host wall time
    per step (synchronised) over 8 steps, then the same 8 steps under
    torch.profiler for the device busy time and the kernels that fill it.

    Then the RMSNorm two ways, in turns (fused, tree, tree, fused), each 8
    steps timed and 8 profiled: the model's ``F.rms_norm`` (one launch) and
    :func:`tree_norm`, the same norm with its row sums by a fixed tree of
    halving adds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import tensorizer as tz
    from repro_torch.launch.serve import quant_predicate
    from repro_torch.models import attention as A, init_model, layers as L, serve as SV
    from repro_torch.serving.store import PagedKVStore
    cfg = get_config("tinyllama-1.1b").replace(quantize="serve")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tz.quantize_params(init_model(cfg, gen, device="cuda"),
                                predicate=quant_predicate)
    B, P, n = 8, 128, 8
    tokens = torch.randint(0, cfg.vocab, (B, P), generator=torch.Generator().manual_seed(6))
    store = PagedKVStore(cfg, B, P + 32, block_size=16, native=True, device="cuda")
    for b in range(B):
        store.lease(b, P, 32)
    _, kv = SV.prefill_with_cache(params, cfg, tokens.cuda(), A.DecodeRows(P + 32, 16))
    store.write_slots(list(range(B)), kv, [P] * B)
    toks = torch.zeros((B, 1), dtype=torch.int32, device="cuda")

    def step():
        nonlocal toks
        logits, cache = SV.decode_paged(params, cfg, store.decode_cache(), toks)
        store.swap(cache)
        toks = logits[:, -1].float().argmax(-1).to(torch.int32)[:, None]

    def measure():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        return wall_ms, prof

    for _ in range(2):
        step()
    wall_ms, prof = measure()
    busy_ms, top = device_time(prof, n, 8)
    fused, norm_ab = L.apply_norm, []
    try:
        for name in ("fused", "tree", "tree", "fused"):
            L.apply_norm = fused if name == "fused" else tree_norm
            step()
            w, pr = measure()
            norm_ab.append({"norm": name, "decode_step_wall_ms": w,
                            "device_busy_ms_per_step": device_time(pr, n, 0)[0]})
    finally:
        L.apply_norm = fused
    return {"decode_step_wall_ms": wall_ms, "device_busy_ms_per_step": busy_ms,
            "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "qgemm_ms_per_step": device_time(prof, n, 0, "qgemm")[0],
            "paged_attention_ms_per_step": device_time(prof, n, 0, "paged_attention")[0],
            "top_kernels_ms_per_step": top, "norm_ab": norm_ab}


def tree_norm(p, x, cfg, eps=1e-6):
    """``layers.apply_norm`` with each row's sum of squares by a fixed tree
    of elementwise halving adds (11 launches at D = 2048; zero-padded to a
    power of two): row-invariant by construction, the yardstick of the
    fused norm's cost in ``decode_profile``."""
    import torch
    xf = x.to(torch.float32)
    t = xf * xf
    width = 1 << max(t.shape[-1] - 1, 0).bit_length()
    t = torch.cat([t, t.new_zeros(t.shape[:-1] + (width - t.shape[-1],))], dim=-1)
    while t.shape[-1] > 1:
        t = t[..., :t.shape[-1] // 2] + t[..., t.shape[-1] // 2:]
    return (xf * torch.rsqrt(t / xf.shape[-1] + eps) * p["scale"]).to(x.dtype)


def device_time(prof, n, k, name=""):
    """Device busy ms per run (of ``n`` profiled runs) and the ``k`` kernels
    that fill most of it, from device-side events only (the kernels and
    copies themselves: the operator events above them carry the same time
    again); with ``name``, of the kernels whose name holds it only."""
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and name in e.key]

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    busy_ms = sum(dev_us(e) for e in events) / 1e3 / n
    top = sorted(events, key=dev_us, reverse=True)[:k]
    return busy_ms, [[e.key[:60], dev_us(e) / 1e3 / n] for e in top]


# ------------------------------------------------- the other serving routes

# EngineConfig fields of the SlotStore routes beside the main path's
ROUTES = {
    "contiguous": {"cache_backend": "contiguous"},
    "bridge": {"cache_backend": "paged"},
    "native_plain": {"cache_backend": "paged", "paged_native": True},
    "native_kernel": {"cache_backend": "paged", "paged_native": True,
                      "paged_kernel": True},
}
CLEAR_MARGIN = 0.3     # check_reference's clear top-2 margin


def serve_setup(**replace):
    """The serve phase's model, weights and prompts, as serve.run builds
    them from SERVE_ARGS (``replace``: config fields to change)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tensorizer as tz
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    args = serve.build_parser().parse_args(SERVE_ARGS)
    cfg = get_config(args.arch)
    cfg = (cfg.smoke() if args.smoke else cfg).replace(quantize=args.quantize, **replace)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = tz.quantize_params(init_model(cfg, gen, device=args.device),
                                predicate=serve.quant_predicate)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.requests, args.prompt_len), dtype=np.int32)
    return cfg, params, prompts, args


def drive(cfg, params, prompts, args, submit_kw=None, engine_cls=None, draft_params=None,
          **ecfg_kw):
    """serve.run's traffic (a request every ``--stagger-steps`` engine
    steps) through an Engine (``engine_cls``) with ``ecfg_kw``, every
    kernel's launches counted from 0; request i is submitted with
    ``submit_kw(i)``. Returns the requests, the engine's stats, the
    launches, the wall time, the contiguous view of the cache once every
    request was submitted, the engine and the host time of each decode step
    (a speculative round: draft steps and verify). A speculative engine
    also counts in ``spec_budget`` the draft proposals that fell within
    their request's length budget (min(spec_k, tokens left - 1) per
    slot-round): the denominator of an acceptance rate that the budget's
    cut of the last round does not lower. The stats gain
    ``device_peak_bytes``, the peak of allocated device memory over the run
    above what was allocated before it."""
    import torch
    from repro_torch.serving.engine import Engine, EngineConfig
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = (engine_cls or Engine)(cfg, params, EngineConfig(**{
        "max_slots": args.slots, "max_queue": args.max_queue,
        "max_seq_len": args.prompt_len + args.gen, "block_size": args.block_size,
        **ecfg_kw}), device=args.device, draft_params=draft_params)
    decode_s = []
    name = "_spec_decode_once" if engine.ecfg.speculative else "_decode_once"
    decode_once = getattr(engine, name)
    engine.spec_budget = 0

    def timed_decode():
        if engine.ecfg.speculative:
            engine.spec_budget += sum(
                min(engine.ecfg.spec_k, r.max_new_tokens - r.metrics.n_generated - 1)
                for r in engine.scheduler.active.values())
        t = time.perf_counter()
        decode_once()
        decode_s.append(time.perf_counter() - t)
    setattr(engine, name, timed_decode)
    counters = all_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    try:
        reqs = []
        for i, p in enumerate(prompts):
            reqs.append(engine.submit(p, args.gen, strict=True,
                                      **(submit_kw(i) if submit_kw else {})))
            for _ in range(args.stagger_steps):
                engine.step()
        view = {n: t.clone() for n, t in engine.store.gather_view().items()}
        engine.run_until_complete()
    finally:
        engine.close()
    wall = time.perf_counter() - t0
    stats = dict(engine.stats(), device_peak_bytes=torch.cuda.max_memory_allocated() - before)
    return (reqs, stats, {k: c.launches for k, c in counters.items()},
            wall, view, engine, decode_s)


def per_forward(cfg):
    """qgemm launches per forward of one token position block: q, k, v, o,
    wi, wg, wo in every layer, plus the lm_head."""
    return 7 * cfg.n_layers + 1


def check_route_launches(name, cfg, stats, launches, paged):
    forwards = stats["decode_steps"] + stats["prefill_batches"]
    check(launches["qgemm"] == per_forward(cfg) * forwards,
          f"{name}: qgemm launched {launches['qgemm']} times, expected "
          f"{per_forward(cfg)} x {forwards} forwards")
    want = forwards * cfg.n_layers if paged else 0
    check(launches["paged_decode_attention"] == want,
          f"{name}: paged attention launched {launches['paged_decode_attention']} "
          f"times, expected {want}")


def same_valid_entries(name, a, b, index):
    """``a`` and ``b`` (contiguous views) bitwise equal on every slot's
    positions below its index."""
    import torch
    for slot, n in enumerate(index.tolist()):
        for leaf in a:
            if leaf != "index":
                check(torch.equal(a[leaf][:, slot, :n], b[leaf][:, slot, :n]),
                      f"{name}: cache leaf {leaf} of slot {slot} differs")


def serve_routes(cfg, params, prompts, args, routes, timed_only=()):
    """The serve traffic through each route of ``routes`` and
    ``timed_only``: tokens bitwise equal across ``routes``, the cache views
    equal on every valid position, qgemm's launches 155 per forward and
    paged attention's 22 per forward (decode step or prefill batch) on the
    float-KV kernel route only, 0 elsewhere; each route's decode step
    times, mean TTFT, prefill wait and peak device memory over the run.
    Returns that summary and each route's tokens."""
    import numpy as np
    runs, out = {}, {}
    for route in list(routes) + list(timed_only):
        reqs, stats, launches, wall, view, _, decode_s = drive(
            cfg, params, prompts, args, **ROUTES[route])
        check(all(r.done and len(r.tokens) == args.gen for r in reqs),
              f"{route}: a request did not finish")
        check_route_launches(route, cfg, stats, launches,
                             ROUTES[route].get("paged_kernel", False)
                             and cfg.kv_cache_dtype != "int8")
        runs[route] = ([r.tokens for r in reqs], view)
        out[route] = {"decode_steps": stats["decode_steps"],
                      "prefill_batches": stats["prefill_batches"], "wall_s": wall,
                      "decode_step_ms_mean": 1e3 * float(np.mean(decode_s)),
                      "decode_step_ms_median": 1e3 * float(np.median(decode_s)),
                      "sustained_tok_s": stats["sustained_tok_s"],
                      "mean_ttft_ms": 1e3 * float(np.mean([r.metrics.ttft_s for r in reqs])),
                      "prefill_wait_s": stats["prefill_wait_s"],
                      "device_peak_bytes": stats["device_peak_bytes"],
                      "launches": launches,
                      "decode_view_bytes": stats["cache"].get("decode_view_bytes", 0),
                      "cache_bytes": stats["cache"]["bytes"]}
    first = routes[0]
    for route in routes[1:]:
        if runs[route][0] != runs[first][0]:
            i = next(i for i, (x, y) in enumerate(zip(runs[route][0], runs[first][0]))
                     if x != y)
            raise SmokeFailure(f"{route} gave other tokens than {first} (request {i})")
        same_valid_entries(f"{route} vs {first}", runs[route][1], runs[first][1],
                           runs[first][1]["index"])
    return out, {route: run[0] for route, run in runs.items()}


def kernel_vs_plain_route(cfg, params, prompts, args):
    """The kernel route held to native-plain by check_reference's rule, at
    the f32 compute dtype: the serve prompts prefilled and decoded
    ``n_steps`` steps by both routes, each fed the plain route's greedy
    tokens; the kernel's greedy token must equal the plain route's wherever
    the plain route's top-2 margin exceeds CLEAR_MARGIN."""
    import torch
    cfg = cfg.replace(dtype="float32")
    n_steps = args.gen
    tokens = torch.as_tensor(prompts, device=args.device)
    _, plain, fed = _prefill_then_decode(params, cfg, tokens, n_steps, use_kernel=False)
    _, kern, _ = _prefill_then_decode(params, cfg, tokens, n_steps, feed=fed)
    compared, max_diff = 0, 0.0
    for i, (k, p) in enumerate(zip(kern, plain)):
        k, p = k.float(), p.float()
        top2 = p.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > CLEAR_MARGIN
        check(torch.equal(k.argmax(-1)[clear], p.argmax(-1)[clear]),
              f"kernel and plain routes pick different clear tokens at step {i}")
        compared += int(clear.sum())
        max_diff = max(max_diff, float((k - p).abs().max()))
    return {"dtype": "float32", "steps": n_steps, "clear_tokens_compared": compared,
            "of": n_steps * tokens.shape[0], "max_abs_logit_diff": max_diff}


def check_stores():
    """The serve traffic through the contiguous store, the paged gather
    bridge and block-native decode without the kernel: bitwise the same
    tokens and cache entries, no paged-attention launch; the kernel route
    too, for its step times beside theirs; then the kernel route held to the
    plain one (f32). Returns the summary and the contiguous route's tokens
    (the fleet phase's plain-route baseline)."""
    cfg, params, prompts, args = serve_setup()
    out, tokens = serve_routes(cfg, params, prompts, args,
                               ["contiguous", "bridge", "native_plain"],
                               timed_only=["native_kernel"])
    out["kernel_vs_plain"] = kernel_vs_plain_route(cfg, params, prompts, args)
    return out, tokens["contiguous"]


def check_int8_kv():
    """The serve traffic with the int8 KV cache through all four routes:
    bitwise the same tokens and cache entries, and no paged-attention launch
    (int8 KV attends by the plain contraction on every route, as in the
    JAX package). Then the quantizer on the card against the CPU: the
    int8 codes and scales of a 16-token prefill's K/V, bitwise."""
    import torch
    from repro_torch.models import attention as A, serve as SV
    cfg, params, prompts, args = serve_setup(kv_cache_dtype="int8")
    out, _ = serve_routes(cfg, params, prompts, args, list(ROUTES))
    _, kv = SV.prefill_with_cache(params, cfg.replace(kv_cache_dtype="bfloat16"),
                                  torch.as_tensor(prompts[:2, :16], device=args.device))
    card = A._quantize_kv(kv["k"], kv["v"])
    cpu = A._quantize_kv(kv["k"].cpu(), kv["v"].cpu())
    for name, g, c in zip(("k_q", "v_q", "k_scale", "v_scale"), card, cpu):
        check(torch.equal(g.cpu(), c), f"int8 KV {name} on the card differs from the CPU's")
    # what a Python-scalar divisor would have done on the card
    amax = kv["k"].float().abs().amax(-1)
    out["quantize_card_vs_cpu"] = {
        "entries": int(card[0].numel()), "scales": int(card[2].numel()), "bitwise": True,
        "scales_off_with_python_scalar_divisor": int(
            ((amax / 127.0 + 1e-12).cpu() != (amax.cpu() / 127.0 + 1e-12)).sum())}
    return out


CHUNK_PROMPTS = (1536, 1900)
CHUNK_GEN = 16
CHUNK_SEQ = 2048
CHUNK_W = 256


def check_chunked():
    """Two long prompts (1536 and 1900 tokens, tinyllama's 2048-token
    context) admitted through the chunked scan (256-token chunks) and
    through single-shot fused prefill, paged native with the kernel: first
    tokens, the seeded pool (every valid position) and the decoded tokens
    bitwise equal; each admission's peak device memory. Then the same
    prompts fused on the contiguous store (the CLI's default route, every
    query through the plain one-query contraction) for that route's
    long-prompt admission time and memory."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, params, _, args = serve_setup()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in CHUNK_PROMPTS]
    runs, out = {}, {}
    for name, kw in (("fused", ROUTES["native_kernel"]),
                     ("chunked", {**ROUTES["native_kernel"], "prefill_chunk": CHUNK_W}),
                     ("fused_contiguous", ROUTES["contiguous"])):
        engine = Engine(cfg, params, EngineConfig(max_slots=2, max_seq_len=CHUNK_SEQ, **kw),
                        device=args.device)
        try:
            reqs = [engine.submit(p, CHUNK_GEN, strict=True) for p in prompts]
            counters = all_counters()
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            engine._admit()
            torch.cuda.synchronize()
            admit_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            view = {n: t.clone() for n, t in engine.store.gather_view().items()}
            engine.run_until_complete()
            stats = engine.stats()
        finally:
            engine.close()
        check(all(r.done and len(r.tokens) == CHUNK_GEN for r in reqs),
              f"chunked/{name}: a request did not finish")
        runs[name] = ([r.tokens for r in reqs], view)
        out[name] = {"admission_peak_bytes": peak, "admission_peak_over_before_bytes": peak - before,
                     "admission_wall_s": admit_s, "flags": stats["opq"]["flags"],
                     "launches": {k: c.launches for k, c in counters.items()}}
    check(runs["chunked"][0] == runs["fused"][0], "chunked prefill gave other tokens "
          f"than fused: {runs['chunked'][0]} vs {runs['fused'][0]}")
    same_valid_entries("chunked vs fused", runs["chunked"][1], runs["fused"][1],
                       runs["fused"][1]["index"])
    check(any(f.startswith("prefill_chunked/") for f in out["chunked"]["flags"]),
          "no chunked admission")
    out["tokens_compared"] = sum(len(t) for t in runs["fused"][0])
    return out


def check_prefix_cache():
    """The serve traffic with the half-prompt preamble of ``--prefix-cache``,
    with and without the cache (paged native, kernel): tokens bitwise,
    hits counted, 7 suffix admissions, qgemm 155 launches per forward (a
    suffix prefill is one pass), and after draining every block free or
    cached with refcount 0."""
    import numpy as np
    cfg, params, prompts, args = serve_setup()
    half = args.prompt_len // 2
    prompts[:, :half] = prompts[0, :half]
    route = ROUTES["native_kernel"]
    cold = drive(cfg, params, prompts, args, **route)
    hot = drive(cfg, params, prompts, args, prefix_cache=True, **route)
    check([r.tokens for r in hot[0]] == [r.tokens for r in cold[0]],
          "the prefix cache changed the tokens")
    stats, launches, store = hot[1], hot[2], hot[5].store
    cold_stats = cold[1]
    census = store.debug_block_census()
    check(census["referenced"] == [] and sorted(census["free"] + census["cached_unreferenced"])
          == list(range(1, store.n_blocks)), f"blocks held after draining: {census}")
    check(stats["prefix_hits"] == args.requests - 1, f"{stats['prefix_hits']} prefix hits")
    flags = stats["opq"]["flags"]
    check(flags.get(f"prefill_prefix/{args.prompt_len}") == args.requests - 1,
          f"prefix cache: suffix admissions {flags}")
    # a suffix admission is one pass of the layer stack, like a fused one
    check_route_launches("prefix_cache", cfg, stats, launches, paged=True)
    def ttft_ms(reqs):
        return 1e3 * float(np.mean([r.metrics.ttft_s for r in reqs]))
    return {"prefix_hits": stats["prefix_hits"],
            "prefix_blocks_reused": stats["prefix_blocks_reused"],
            "prefix_tokens_reused": stats["prefix_tokens_reused"],
            "prefill_chunks": stats["prefill_chunks"], "flags": flags,
            "mean_ttft_ms_hot": ttft_ms(hot[0]), "mean_ttft_ms_cold": ttft_ms(cold[0]),
            "prefill_wait_s_hot": stats["prefill_wait_s"],
            "prefill_wait_s_cold": cold_stats["prefill_wait_s"],
            "wall_s_hot": hot[3], "wall_s_cold": cold[3],
            "cache": stats["cache"], "census_after_drain": {k: len(v) for k, v in census.items()},
            "launches": launches}


# ------------------------------------------ sampling and speculative decode

SAMPLED_ARGS = ["--temperature", "0.8", "--top-k", "50", "--top-p", "0.9"]
STOP_AT = 10           # the stop pair: request 1's serve tokens 10 and 11
SAMPLER_MARGIN = 1e-5  # card vs CPU sampler: rows closer to a decision are not compared
GUMBEL_ULPS = 4.0      # tests/test_torch_sampling.py's bound on |gumbel - JAX's|


def sampler_margins(logits, sp, positions):
    """Per row, on the CPU: how far the sampler's two float decisions lie
    from flipping: the nucleus, min |cum - probs - top_p| over the row's
    top-k entries (rows with top_p < 1), and the Gumbel-max, the gap
    between the best and second-best allowed ``l + g``. ``sample_tokens``'s
    steps, kept apart to read the margins."""
    import torch
    from repro_torch.serving import sampling as SMP
    V = logits.shape[-1]
    rep = sp["rep_penalty"][:, None]
    pen = torch.where(logits > 0, logits / rep, logits * rep)
    l = torch.where(sp["presence"], pen, logits) / torch.clamp(sp["temperature"], min=1e-6)[:, None]
    srt = torch.sort(l, dim=-1, descending=True).values
    k = torch.clamp(sp["top_k"], 0, V)[:, None]
    in_k = (k <= 0) | (torch.arange(V)[None, :] < k)
    probs = torch.softmax(torch.where(in_k, srt, torch.full_like(srt, -torch.inf)), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    top_p = sp["top_p"][:, None]
    keep = in_k & (((cum - probs) < top_p) | (top_p >= 1.0))
    keep[:, 0] = True
    nucleus = torch.where(in_k & (top_p < 1.0), (cum - probs - top_p).abs(),
                          torch.full_like(cum, torch.inf)).amin(dim=-1)
    thresh = torch.where(keep, srt, torch.full_like(srt, torch.inf)).amin(dim=-1, keepdim=True)
    z = torch.where(l >= thresh, l + SMP._gumbel_rows(sp["seed"], positions, V),
                    torch.full_like(l, -torch.inf))
    top2 = z.topk(2, dim=-1).values
    return nucleus, top2[:, 0] - top2[:, 1]


def check_sampler_card_vs_cpu(dev):
    """(c) threefry bits and the uniform bitwise card against CPU, the
    Gumbel value within GUMBEL_ULPS; (d) ``sample_tokens`` on the same f32
    rows (uploaded from the CPU): the same tokens in every row whose
    decisions lie more than SAMPLER_MARGIN from flipping; the sampler's
    device time at the decode batch."""
    import numpy as np
    import torch
    from repro_torch.core.opq import to_device
    from repro_torch.serving import sampling as SMP
    V = 32000
    seeds = torch.tensor([0, 1, 7, 2**31 + 5, 2**32 - 1]).repeat_interleave(4)
    pos = torch.tensor([0, 127, 159, 2047]).repeat(5)
    kc, kg = SMP.fold_in(seeds, pos), SMP.fold_in(seeds.to(dev), pos.to(dev))
    check(all(torch.equal(a, b.cpu()) for a, b in zip(kc, kg)), "fold_in differs on the card")
    check(torch.equal(SMP.random_bits(kg, V).cpu(), SMP.random_bits(kc, V)),
          "threefry bits differ on the card")
    uc, ug = SMP.uniform(kc, V), SMP.uniform(kg, V).cpu()
    check(torch.equal(ug.view(torch.int32), uc.view(torch.int32)), "uniform differs on the card")
    gc, gg = SMP.gumbel(kc, V).double(), SMP.gumbel(kg, V).cpu().double()
    eps = float(np.finfo(np.float32).eps)
    ratio = float(((gg - gc).abs() / (eps * gc.abs().clamp(min=1.0))).max())
    check(ratio <= GUMBEL_ULPS, f"gumbel card vs CPU {ratio} eps, bound {GUMBEL_ULPS}")
    rng = np.random.default_rng(4)
    B = 64
    logits = torch.from_numpy((rng.standard_normal((B, V)) * 3).astype(np.float32))
    grid = [dict(temperature=0.8, top_k=50, top_p=0.9), dict(temperature=1.0, top_p=0.9),
            dict(temperature=0.6, top_k=0, top_p=0.95, repetition_penalty=1.2),
            dict(temperature=1.3, top_k=200), dict()]
    sps = [SMP.SamplingParams(seed=int(rng.integers(0, 2**32)), **grid[i % len(grid)])
           for i in range(B)]
    presence = rng.random((B, V)) < 0.01
    positions = torch.from_numpy(rng.integers(0, 2048, B).astype(np.int32))
    host = SMP.stack_params(sps, presence)
    sp_c, sp_g = to_device(host, torch.device("cpu")), to_device(host, dev)
    tc = SMP.sample_tokens(logits, sp_c, positions)
    tg = SMP.sample_tokens(logits.to(dev), sp_g, positions.to(dev)).cpu()
    nucleus, gap = sampler_margins(logits, sp_c, positions)
    clear = (nucleus > SAMPLER_MARGIN) & (gap > SAMPLER_MARGIN)
    check(torch.equal(tg[clear], tc[clear]),
          f"sample_tokens picks other tokens on the card in rows {torch.nonzero(clear & (tg != tc)).tolist()}")
    # the sampler's time at the decode batch: 8 rows, the serve mix
    dsp = to_device(SMP.stack_params(
        [SMP.SamplingParams(seed=i, **grid[0]) if i % 2 == 0 else None for i in range(8)],
        presence[:8]), dev)
    row8, pos8 = logits[:8].to(dev), positions[:8].to(dev)
    return {"seeds_x_positions": len(seeds), "vocab": V, "bits_bitwise": True,
            "uniform_bitwise": True, "gumbel_max_eps_ratio": ratio,
            "rows": B, "rows_compared": int(clear.sum()),
            "rows_under_nucleus_margin": int((nucleus <= SAMPLER_MARGIN).sum()),
            "rows_under_gumbel_margin": int((gap <= SAMPLER_MARGIN).sum()),
            "rows_differing_under_margin": int((tg != tc).sum()),
            "sampler_graph_ms": graph_ms(lambda: SMP.sample_tokens(row8, dsp, pos8), 20),
            "sampler_eager_ms": time_ms(lambda: SMP.sample_tokens(row8, dsp, pos8), 20),
            "greedy_batch_eager_ms": time_ms(lambda: SMP.sample_tokens(
                row8, dict(dsp, sampled=False), pos8), 20),
            "logprob_info_graph_ms": graph_ms(lambda: SMP.logprob_info(
                row8, row8.argmax(-1), V), 20)}


def check_sampling(serve_reqs, serve_stats):
    """The serve traffic on the main path with the CLI's sampling mix
    (requests 0, 2, 4, 6 sample at temperature 0.8, top-k 50, top-p 0.9,
    seeds 0, 2, 4, 6; the odd ones stay greedy), a stop pair taken from a
    greedy request's serve stream, and logprobs on every request:
    (a) greedy requests get their serve streams (up to a stop); (b) each
    sampled request served alone by a one-slot engine gets its stream, and
    a second run of the traffic gives the same streams; (c, d)
    ``check_sampler_card_vs_cpu``; (e) a greedy token's logprob is the top
    logprob; (f) ``Engine.embed``'s logits row of a 128-token prompt is the
    fused prefill's last row, bitwise, and its argmax the first token."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import serve as SV
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, params, prompts, args = serve_setup()
    stop = serve_reqs[1].tokens[STOP_AT:STOP_AT + 2]
    sargs = serve.build_parser().parse_args(
        SERVE_ARGS + SAMPLED_ARGS + ["--stop", ",".join(map(str, stop))])

    def submit_kw(i):
        return {"sampling": serve.sampling_for(sargs, i), "want_logprobs": 5}
    route = ROUTES["native_kernel"]
    greedy = drive(cfg, params, prompts, args, **route)
    runs = [drive(cfg, params, prompts, args, submit_kw=submit_kw, **route) for _ in range(2)]
    reqs, stats, launches = runs[0][0], runs[0][1], runs[0][2]
    check([r.tokens for r in runs[1][0]] == [r.tokens for r in reqs],
          "a second run of the sampled traffic gave other tokens")
    check_route_launches("sampling", cfg, stats, launches, paged=True)
    check(stats["sampled_tokens"] > 0 and stats["stop_hits"] >= 1,
          f"sampling: {stats['sampled_tokens']} sampled tokens, {stats['stop_hits']} stops")
    for i, r in enumerate(reqs):
        if r.sampling.greedy:                                        # (a), (e)
            want = serve_reqs[i].tokens
            check(r.tokens == want[:len(r.tokens)] and (
                r.finish_reason == "length" and r.tokens == want
                or r.finish_reason == "stop" and r.tokens[-2:] == stop),
                f"greedy request {i} beside sampled ones left its serve stream")
            check(all(lp == top[0][1] for lp, top in zip(r.logprobs, r.top_logprobs)),
                  f"greedy request {i}: chosen logprob is not the top logprob")
        check(len(r.logprobs) == len(r.top_logprobs) == len(r.tokens)
              and all(len(t) == 5 for t in r.top_logprobs), f"request {i}: logprob records")
    engine = Engine(cfg, params, EngineConfig(
        max_slots=1, max_seq_len=args.prompt_len + args.gen, cache_backend="paged",
        block_size=args.block_size, paged_native=True, paged_kernel=True), device=args.device)
    alone = 0
    try:                                                             # (b)
        for i, r in enumerate(reqs):
            if not r.sampling.greedy:
                solo = engine.submit(r.prompt, args.gen, strict=True, **submit_kw(i))
                engine.run_until_complete()
                check(solo.tokens == r.tokens, f"sampled request {i} alone gave other tokens")
                alone += 1
        t = torch.as_tensor(prompts[:1], device=args.device)     # (f)
        emb = engine.embed(prompts[0])
        logits, _ = SV.prefill_with_cache(params, cfg, t, decode_rows=engine.decode_rows)
        row = logits[0, -1, :cfg.vocab].float().cpu().numpy()
        check(np.array_equal(emb["logits"], row), "embed's logits row is not the prefill's")
        check(int(np.argmax(emb["logits"])) == serve_reqs[0].tokens[0],
              "embed's argmax is not the first token")
    finally:
        engine.close()

    def med(xs):
        return 1e3 * float(np.median(xs))

    def ttft(rs):
        return 1e3 * float(np.mean([r.metrics.ttft_s for r in rs]))
    return launches, {
        "stop": stop, "stop_hits": stats["stop_hits"],
        "finish_reasons": [r.finish_reason for r in reqs],
        "sampled_tokens": stats["sampled_tokens"], "tokens_generated": stats["tokens_generated"],
        "greedy_streams_equal_serve": True, "sampled_alone_equal": alone,
        "embed": {"bucket": args.prompt_len, "logits_row_bitwise": True,
                  "embedding_norm": float(np.linalg.norm(emb["embedding"]))},
        "sustained_tok_s": stats["sustained_tok_s"],
        "sustained_tok_s_greedy_same_phase": greedy[1]["sustained_tok_s"],
        "sustained_tok_s_serve_phase": serve_stats["sustained_tok_s"],
        "mean_ttft_ms": ttft(reqs), "mean_ttft_ms_greedy_same_phase": ttft(greedy[0]),
        "mean_ttft_ms_serve_phase": serve_stats["mean_ttft_ms"],
        "decode_step_ms_median_sampled": med(runs[0][6]),
        "decode_step_ms_median_sampled_second_run": med(runs[1][6]),
        "decode_step_ms_median_greedy": med(greedy[6]),
        "card_vs_cpu": check_sampler_card_vs_cpu(torch.device(args.device)),
        "launches": launches}


SPEC_K = 4


def snapshot_engine_cls():
    """An Engine that keeps each request's cache rows (its lease's extent,
    prompt + max_new) at retire, before the reset scrubs them."""
    from repro_torch.serving.engine import Engine

    class SnapshotEngine(Engine):
        def _retire(self, slot):
            req = self.scheduler.active[slot]
            ext = len(req.prompt) + req.max_new_tokens
            self.rows = getattr(self, "rows", {})
            self.rows[req.id] = {n: leaf[:, slot, :ext].clone() for n, leaf in
                                 self.store.gather_view().items() if n != "index"}
            super()._retire(slot)
    return SnapshotEngine


def check_speculative():
    """Greedy speculative decode (spec_k = 4) on the serve traffic through
    the contiguous store, the paged gather bridge and block-native plain,
    with a good draft (the target's weights) and a bad one (generator seed
    --seed + 1): tokens and every request's retire-time cache rows bitwise
    those of plain decode on the same route, the good draft's acceptance
    within the length budget exactly 1.0, qgemm 155 launches per forward
    (k + 1 draft steps and one verify per round), and every block back in
    the free list after draining."""
    import numpy as np
    import torch
    from repro_torch.core import tensorizer as tz
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    cfg, params, prompts, args = serve_setup()
    gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)
    bad = tz.quantize_params(init_model(cfg, gen, device=args.device),
                             predicate=serve.quant_predicate)
    snap = snapshot_engine_cls()
    out, launches_all = {}, []
    for route in ("contiguous", "bridge", "native_plain"):
        plain = drive(cfg, params, prompts, args, engine_cls=snap, **ROUTES[route])
        out[route] = {"plain": {"sustained_tok_s": plain[1]["sustained_tok_s"],
                                "decode_steps": plain[1]["decode_steps"],
                                "wall_s": plain[3]}}
        for draft, dparams in (("good", params), ("bad", bad)):
            reqs, stats, launches, wall, _, engine, round_s = drive(
                cfg, params, prompts, args, engine_cls=snap, draft_params=dparams,
                speculative=True, spec_k=SPEC_K, draft=cfg, **ROUTES[route])
            name = f"{route}/{draft}"
            check([r.tokens for r in reqs] == [r.tokens for r in plain[0]],
                  f"{name}: speculative tokens differ from plain decode's")
            for r, p in zip(reqs, plain[0]):
                for leaf, t in engine.rows[r.id].items():
                    check(torch.equal(t, plain[5].rows[p.id][leaf]),
                          f"{name}: request {r.id}'s retire-time {leaf} rows differ from plain's")
            forwards = stats["decode_steps"] + stats["draft_steps"] + 2 * stats["prefill_batches"]
            check(launches["qgemm"] == per_forward(cfg) * forwards,
                  f"{name}: qgemm launched {launches['qgemm']} times, expected "
                  f"{per_forward(cfg)} x {forwards} forwards")
            check(launches["paged_decode_attention"] == 0, f"{name}: paged attention launched")
            within = stats["accepted_tokens"] / max(engine.spec_budget, 1)
            if draft == "good":
                check(within == 1.0, f"{name}: acceptance within budget {within}, not 1.0")
            else:
                check(stats["accepted_tokens"] < stats["proposed_tokens"],
                      f"{name}: the bad draft was accepted everywhere")
            census = None
            if ROUTES[route]["cache_backend"] == "paged":
                census = engine.store.debug_block_census()
                check(census["referenced"] == [] and census["free"]
                      == list(range(1, engine.store.n_blocks)), f"{name}: census {census}")
                census = {k: len(v) for k, v in census.items()}
            launches_all.append(launches)
            out[route][draft] = {
                "spec_rounds": stats["spec_rounds"], "draft_steps": stats["draft_steps"],
                "decode_steps": stats["decode_steps"],
                "proposed_tokens": stats["proposed_tokens"],
                "accepted_tokens": stats["accepted_tokens"],
                "acceptance_rate": stats["acceptance_rate"],
                "acceptance_within_budget": within, "accept_hist": stats["accept_hist"],
                "sustained_tok_s": stats["sustained_tok_s"], "wall_s": wall,
                "round_ms_median": 1e3 * float(np.median(round_s)),
                "qgemm_per_round": (launches["qgemm"] - 2 * per_forward(cfg)
                                    * stats["prefill_batches"]) / stats["spec_rounds"],
                "census_after_drain": census, "launches": launches}
    return {k: sum(l[k] for l in launches_all) for k in launches_all[0]}, {
        "spec_k": SPEC_K, "tokens_and_rows_bitwise_plain": True, **out}


# ------------------------------------------------------------ the fleet

FLEET_DRAIN_AT = 6               # fleet steps before host 0 drains (--drain-at)
SWEEP_CUTS = (1, 8, 16, 24, 31)  # continuation cut points W of one request


def fleet_ecfg(args, **kw):
    """The serve phase's engine config, as ``drive`` builds it."""
    from repro_torch.serving.engine import EngineConfig
    return EngineConfig(**{
        "max_slots": args.slots, "max_queue": args.max_queue,
        "max_seq_len": args.prompt_len + args.gen, "block_size": args.block_size,
        **ROUTES["native_kernel"], **kw})


def run_fleet(router, prompts, args, drain_at=None):
    """serve.run's traffic through a Router: request i in session i % 2, a
    request every ``--stagger-steps`` fleet steps; with ``drain_at`` host 0
    drains after that many fleet steps. Returns the requests, the router's
    stats and the wall time."""
    t0 = time.perf_counter()
    steps = 0
    reqs = []

    def tick():
        nonlocal steps
        router.step()
        steps += 1
        if drain_at is not None and steps == drain_at:
            router.drain(0)
    for i, p in enumerate(prompts):
        reqs.append(router.submit(p, args.gen, session=str(i % 2), strict=True))
        for _ in range(args.stagger_steps):
            tick()
    while router.has_work():
        tick()
    return reqs, router.stats(), time.perf_counter() - t0


def fleet_summary(name, reqs, stats, wall, baseline):
    """Tokens bitwise the serve phase's, and the fleet's rates."""
    diff = [(i, next((j for j, (x, y) in enumerate(zip(r.tokens, b.tokens)) if x != y),
                     min(len(r.tokens), len(b.tokens))))
            for i, (r, b) in enumerate(zip(reqs, baseline)) if list(r.tokens) != list(b.tokens)]
    check(not diff, f"fleet/{name}: tokens differ from the serve phase's (request, first "
          f"index): {diff}")
    r = stats["router"]
    return {"sustained_tok_s": stats["fleet"]["sustained_tok_s"], "wall_s": wall,
            "mean_ttft_ms": 1e3 * sum(q.token_ts[0] - q.arrival_s for q in reqs) / len(reqs),
            "placed": r["placed"], "affinity_hits": r["affinity_hits"],
            "spills": r["spills"], "hosts": [q.hosts for q in reqs]}


def sweep_continuations(engine_factory, prompt, gen, cuts):
    """Cut one greedy stream at each W of ``cuts`` and re-admit ``prompt +
    tokens[:W]`` with budget ``gen - W`` on a fresh engine (the router's
    re-prefill continuation): clean cut points (the stitched stream is the
    uninterrupted one) and divergent ones with the first differing index."""
    import numpy as np

    def stream(p, g):
        eng = engine_factory()
        try:
            req = eng.submit(p, g, strict=True)
            eng.run_until_complete()
        finally:
            eng.close()
        return list(req.tokens)
    base = stream(prompt, gen)
    clean, divergent = [], []
    for w in cuts:
        stitched = base[:w] + stream(np.concatenate([prompt, np.asarray(base[:w], np.int32)]),
                                     gen - w)
        if stitched == base:
            clean.append(w)
        else:
            divergent.append([w, next(i for i, (x, y) in enumerate(zip(stitched, base))
                                      if x != y)])
    return {"cuts": list(cuts), "clean": clean, "divergent": divergent}


def census_drained(name, store):
    census = store.debug_block_census()
    check(census["referenced"] == [] and sorted(census["free"] + census["cached_unreferenced"])
          == list(range(1, store.n_blocks)), f"fleet/{name}: census after draining {census}")
    return {k: len(v) for k, v in census.items()}


def fleet_forwards(stats):
    """The fleet's forwards, decode steps and prefill batches over every
    host, in check_route_launches' form."""
    hosts = stats["per_host"]
    return {"decode_steps": sum(h["decode_steps"] for h in hosts),
            "prefill_batches": sum(h["prefill_batches"] for h in hosts)}


def check_fleet(serve_reqs, serve_stats, contiguous_tokens):
    """The serving fleet at full width on the serve traffic (the serve
    phase's tokens are the baseline, bitwise): (1) a Router over two
    in-process engines, sessions i % 2; (2) prefill:1,decode:1
    disaggregation in process: ships and no fallback, no prefill on the
    decode host, every block free or cached unreferenced after draining,
    each ship's export, frame and import time and bytes; (3) host 0 drained
    at fleet step FLEET_DRAIN_AT with handoff_threshold 0, and every
    continuation cut point of request 0 at SWEEP_CUTS clean; (3b) the same
    drain and sweep on the contiguous store, the CLI's default route, whose
    prefill runs the plain one-query contraction: tokens bitwise the stores
    phase's contiguous run (``contiguous_tokens``); (4) two
    SubprocessTransport workers on the card, each warmed by one short
    request: boot time, RPC p50/p99, tok/s, pids, both exited after close;
    (5) serve_api over the engine: one completion, an SSE stream and a
    classify over HTTP. Launches are counted around each in-process fleet
    run of (1)-(3b), each held to its forwards over every host
    (check_route_launches), and summed; a worker process counts its own."""
    import http.client
    import numpy as np
    from repro_torch.serving.api import serve_api
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.router import Router, RouterConfig, parse_disaggregate
    from repro_torch.serving.transport import (
        SubprocessTransport, build_inproc_fleet, build_model_spec, decode_frame,
        encode_frame,
    )
    cfg, params, prompts, args = serve_setup()
    ecfg = fleet_ecfg(args)
    dev = args.device
    out = {"single_engine": {"sustained_tok_s": serve_stats["sustained_tok_s"],
                             "mean_ttft_ms": serve_stats["mean_ttft_ms"]}}
    counters = all_counters()
    run_launches = {}

    def zero():
        for c in counters.values():
            c.launches = 0

    def counted(name, stats, paged=True):
        run_launches[name] = {k: c.launches for k, c in counters.items()}
        check_route_launches(f"fleet/{name}", cfg, fleet_forwards(stats),
                             run_launches[name], paged)

    # (1) two in-process engines behind the Router
    zero()
    router = Router(cfg, params, ecfg, RouterConfig(n_hosts=2), device=dev)
    try:
        reqs, stats, wall = run_fleet(router, prompts, args)
    finally:
        router.close()
    counted("router", stats)
    out["router"] = fleet_summary("router", reqs, stats, wall, serve_reqs)
    check(stats["router"]["affinity_hits"] > 0, "fleet/router: no affinity hit")

    # (2) prefill:1,decode:1 with each ship's legs timed
    roles = parse_disaggregate("prefill:1,decode:1", 2)
    fleet = build_inproc_fleet(cfg, params, ecfg, 2, device=dev)
    src, dst = fleet[roles.index("prefill")], fleet[roles.index("decode")]
    ships = []
    ship, recv = src.ship_blocks, dst.recv_blocks

    def timed_ship(req_id):
        t = time.perf_counter()
        entry = ship(req_id)
        if entry is not None:
            t1 = time.perf_counter()
            frame = encode_frame(entry, "json")
            decode_frame(frame)
            ships.append({"export_ms": 1e3 * (t1 - t), "frame_ms": 1e3 * (time.perf_counter() - t1),
                          "frame_bytes": len(frame), "n_blocks": entry["payload"]["n_blocks"],
                          "payload_bytes": sum(a.nbytes for a in
                                               entry["payload"]["leaves"].values())})
        return entry

    def timed_recv(entry):
        t = time.perf_counter()
        got = recv(entry)
        if got is not None:
            ships[-1]["import_ms"] = 1e3 * (time.perf_counter() - t)
        return got
    src.ship_blocks, dst.recv_blocks = timed_ship, timed_recv
    zero()
    router = Router(transports=fleet, router_cfg=RouterConfig(roles=roles))
    try:
        reqs, stats, wall = run_fleet(router, prompts, args)
        dflags = dict(stats["per_host"][roles.index("decode")]["opq"]["flags"])
        census = {r: census_drained(f"disagg/{r}", t.engine.store)
                  for r, t in zip(roles, fleet)}
    finally:
        router.close()
    counted("disagg", stats)
    r = stats["router"]
    check(r["ships"] > 0 and r["ship_fallbacks"] == 0,
          f"fleet/disagg: {r['ships']} ships, {r['ship_fallbacks']} fallbacks")
    prefill_flags = {f: n for f, n in dflags.items() if f.startswith(("prefill", "draft_prefill"))}
    check(not prefill_flags, f"fleet/disagg: prefill on the decode host {prefill_flags}")
    pstats = stats["per_host"][roles.index("prefill")]
    out["disagg"] = {**fleet_summary("disagg", reqs, stats, wall, serve_reqs),
                     "ships": r["ships"], "shipped_blocks": r["shipped_blocks"],
                     "ship_fallbacks": r["ship_fallbacks"], "decode_host_flags": dflags,
                     "census_after_drain": census, "ship_legs": ships,
                     "ship_ms_median": float(np.median([s["export_ms"] + s["frame_ms"]
                                                        + s["import_ms"] for s in ships])),
                     "prefill_batch_wait_ms": 1e3 * pstats["prefill_wait_s"]
                     / max(pstats["prefill_batches"], 1)}

    # (3) drain host 0 mid-run, every long stream handed off, on the kernel
    # route and (3b) on the contiguous store, each with its continuation sweep
    for name, route_ecfg, baseline in (
            ("drain", ecfg, serve_reqs),
            ("drain_contiguous", fleet_ecfg(args, cache_backend="contiguous",
                                            paged_native=False, paged_kernel=False),
             [types.SimpleNamespace(tokens=t) for t in contiguous_tokens])):
        zero()
        router = Router(cfg, params, route_ecfg,
                        RouterConfig(n_hosts=2, handoff_threshold=0), device=dev)
        try:
            reqs, stats, wall = run_fleet(router, prompts, args, drain_at=FLEET_DRAIN_AT)
        finally:
            router.close()
        counted(name, stats, paged=route_ecfg.paged_kernel)
        check(stats["router"]["handoffs"] > 0, f"fleet/{name}: no handoff")
        out[name] = {**fleet_summary(name, reqs, stats, wall, baseline),
                     "drain_at": FLEET_DRAIN_AT, "handoffs": stats["router"]["handoffs"],
                     "requeued": stats["router"]["requeued"]}
        sweep = out[name]["sweep"] = sweep_continuations(
            lambda: Engine(cfg, params, route_ecfg, device=dev), prompts[0], args.gen,
            SWEEP_CUTS)
        check(not sweep["divergent"], f"fleet/{name}: continuations leave the stream "
              f"(cut, first differing index): {sweep['divergent']}")
    launches = {k: sum(r[k] for r in run_launches.values()) for k in counters}
    out["launches_by_run"] = run_launches

    # (4) two worker processes on the card
    spec = build_model_spec(args.arch, smoke=args.smoke, quantize=args.quantize,
                            seed=args.seed, device=dev)
    rpc_s = []
    workers, boot_s = [], []
    try:
        for _ in range(2):
            t = time.perf_counter()
            workers.append(SubprocessTransport(spec, ecfg, connect_timeout_s=300.0))
            boot_s.append(time.perf_counter() - t)
        for w in workers:
            # one short request per worker first: a fresh process's first
            # steps pay its lazy CUDA and library set-up, which the parent's
            # engines paid in the serve phase (batch invariance: no stream
            # of the timed run changes)
            eid = w.submit(prompts[0], 2)
            deadline = time.monotonic() + 300
            while not w.poll({eid: 0}).get(eid, {}).get("done"):
                check(time.monotonic() < deadline, "fleet/procs: the warm-up never finished")
                time.sleep(0.01)
            w.poll({}, drop=[eid])
            observe = w.metrics.observe

            def timed(dt, observe=observe):
                rpc_s.append(dt)
                observe(dt)
            w.metrics.observe = timed
        router = Router(transports=workers)
        reqs, stats, wall = run_fleet(router, prompts, args)
        router.close()
    finally:
        for w in workers:
            w.close()
    check(all(w.proc.poll() is not None for w in workers), "fleet/procs: a worker outlived close")
    out["procs"] = {**fleet_summary("procs", reqs, stats, wall, serve_reqs),
                    "boot_s": boot_s, "pids": [w.pid for w in workers],
                    "rpcs": len(rpc_s), "rpc_p50_ms": 1e3 * float(np.percentile(rpc_s, 50)),
                    "rpc_p99_ms": 1e3 * float(np.percentile(rpc_s, 99)),
                    "exited": [w.proc.returncode for w in workers]}

    # (5) the HTTP API over the full-width engine
    engine = Engine(cfg, params, ecfg, device=dev)
    srv = serve_api(engine, port=0)

    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)
        conn.request("POST", body.pop("path"), body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        return conn, conn.getresponse()
    try:
        prompt = [int(t) for t in prompts[0]]
        conn, resp = post({"path": "/v1/completions", "prompt": prompt,
                           "max_new_tokens": args.gen})
        body = json.loads(resp.read().decode())
        conn.close()
        check(resp.status == 200 and body["tokens"] == list(serve_reqs[0].tokens),
              "fleet/api: the HTTP completion differs from the serve phase's tokens")
        conn, resp = post({"path": "/v1/completions", "prompt": prompt,
                           "max_new_tokens": args.gen, "stream": True})
        events = []
        for raw in resp.fp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                if line == "data: [DONE]":
                    break
                events.append(json.loads(line[len("data: "):]))
        conn.close()
        *tok_events, done = events
        check([e["index"] for e in tok_events] == list(range(args.gen))
              and [e["token"] for e in tok_events] == body["tokens"]
              and done.get("done") and done.get("n_tokens") == args.gen,
              "fleet/api: the SSE stream is out of order or did not terminate")
        conn, resp = post({"path": "/v1/classify", "prompt": prompt, "classes": [3, 17, 99]})
        cls = json.loads(resp.read().decode())
        conn.close()
        check(resp.status == 200 and abs(sum(cls["probs"]) - 1.0) < 1e-6,
              f"fleet/api: classify probabilities {cls.get('probs')}")
    finally:
        srv.close()
        engine.close()
    out["api"] = {"completion_tokens": len(body["tokens"]), "sse_events": len(tok_events),
                  "classify_probs_sum": sum(cls["probs"])}
    return launches, out


# ------------------------------------------------------ the GPTPU path

APP_N = 1024   # the GEMM size of the paper's Fig. 7 (apps/gemm_app.py)
GEMM_N = 4096  # tpuGemm's size in both lowerings
# tests/test_apps_accuracy.py's limits (paper Table 4 with slack), percent
APP_MAPE_LIMITS = {"gemm": 1.0, "pagerank": 1.0, "hotspot3d": 1.0, "lud": 0.5,
                   "gaussian": 0.01, "backprop": 0.5, "blackscholes": 2.0}
APP_RMSE_LIMIT = 1.0
APP_FP_MAPE_LIMIT = 0.05       # tests/test_apps_accuracy.py::test_fp_paths_are_exact


def gptpu_counters():
    from repro_torch.kernels.qgemm import qgemm, qgemm_tile_scales
    from repro_torch.kernels.stencil3x3 import stencil3x3
    return {"qgemm": qgemm, "qgemm_tile_scales": qgemm_tile_scales, "stencil3x3": stencil3x3}


def all_counters():
    """Every kernel wrapper of the port, by name (its ``launches`` count)."""
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.qdot_serve import qgemv
    return {**gptpu_counters(), "paged_decode_attention": paged_decode_attention,
            "qgemv": qgemv}


def read_launches(fn):
    """Run ``fn()`` and return (its result, each kernel's launches during it)."""
    counters = gptpu_counters()
    before = {k: c.launches for k, c in counters.items()}
    out = fn()
    return out, {k: c.launches - before[k] for k, c in counters.items()}


def expected_app_launches(name, lowering, n):
    """What each application's code fixes at size ``n``: tpuGemm calls go to
    the tile-scales kernel (fully_connected) or qgemm (conv2d)."""
    from repro_torch.apps import hotspot3d, lud, pagerank

    def lud_gemms(m):                    # one Schur update per split above BLOCK
        return 0 if m <= lud.BLOCK else 1 + lud_gemms(m // 2) + lud_gemms(m - m // 2)

    def gemms(k):
        fc = lowering == "fully_connected"
        return {"qgemm": 0 if fc else k, "qgemm_tile_scales": k if fc else 0,
                "stencil3x3": 0}
    if name == "gemm":
        return gemms(1)
    if name == "lud":
        return gemms(lud_gemms(n))
    if name == "backprop":               # 3 FullyConnected (qgemm) + 2 tpuGemm
        return dict(gemms(2), qgemm=3 + gemms(2)["qgemm"])
    if name == "pagerank":               # one FullyConnected per iteration
        return {"qgemm": pagerank.ITERS, "qgemm_tile_scales": 0, "stencil3x3": 0}
    if name == "hotspot3d":              # every layer every iteration + the mass
        return {"qgemm": 0, "qgemm_tile_scales": 0,
                "stencil3x3": hotspot3d.ITERS * hotspot3d.NZ + 1}
    return {"qgemm": 0, "qgemm_tile_scales": 0, "stencil3x3": 0}   # gaussian, blackscholes


@contextlib.contextmanager
def pinned_lowering(lowering):
    """tpuGemm(lowering=None) takes ``lowering`` on every device meanwhile."""
    from repro_torch.core import instr_select
    measured = instr_select.best_gemm_lowering
    instr_select.best_gemm_lowering = lambda device=None: lowering
    try:
        yield
    finally:
        instr_select.best_gemm_lowering = measured


def check_gptpu(dev):
    """The GPTPU path through its entry points: the card's instruction table
    (measured now), tpuGemm at 4096^3 in both lowerings, the seven
    applications at n = APP_N, the three that call tpuGemm again in the
    lowering the table did not pick, and hotspot3d's fp path. Every kernel's
    count is set to 0 after the table is measured and read at the end."""
    import numpy as np
    import torch
    from repro_torch.apps import ALL, run_app
    from repro_torch.core import instr_select
    from repro_torch.core.gemm import tpu_gemm
    table = instr_select.get_table(dev, refresh=True)
    lowering = instr_select.best_gemm_lowering(dev)
    for c in all_counters().values():
        c.launches = 0
    out = {"instr_table": table, "lowering": lowering, "tpu_gemm": {}, "apps": {}}

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0, 16, (GEMM_N, GEMM_N)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(0, 16, (GEMM_N, GEMM_N)).astype(np.float32)).to(dev)
    exact = a.double() @ b.double()
    for low, kernel in (("fully_connected", "qgemm_tile_scales"), ("conv2d", "qgemm")):
        t0 = time.perf_counter()
        c, launches = read_launches(lambda: tpu_gemm(a, b, lowering=low))
        torch.cuda.synchronize()
        rel = float((c.double() - exact).abs().max() / exact.abs().max())
        check(bool(torch.isfinite(c).all()) and rel < 0.02,
              f"tpu_gemm {low} at {GEMM_N}: relative max error {rel}")
        check(launches[kernel] == 1 and sum(launches.values()) == 1,
              f"tpu_gemm {low} launched {launches}")
        out["tpu_gemm"][low] = {"rel_max_err": rel, "launches": launches,
                                "wall_s": time.perf_counter() - t0}
    del a, b, exact

    def run_checked(label, name, low, quantized=True):
        r, launches = read_launches(lambda: run_app(name, n=APP_N, quantized=quantized,
                                                    device=dev))
        mape_limit = APP_MAPE_LIMITS[name] if quantized else APP_FP_MAPE_LIMIT
        check(r.mape_pct <= mape_limit and r.rmse_pct <= APP_RMSE_LIMIT,
              f"{label} at n={APP_N}: MAPE {r.mape_pct}%, RMSE {r.rmse_pct}%")
        expect = expected_app_launches(name, low, APP_N)
        check(launches == expect, f"{label} launched {launches}, expected {expect}")
        out["apps"][label] = {"mape_pct": r.mape_pct, "rmse_pct": r.rmse_pct,
                              "wall_s": r.t_gptpu_s, "launches": launches}

    for name in sorted(ALL):
        run_checked(name, name, lowering)
    other = "conv2d" if lowering == "fully_connected" else "fully_connected"
    with pinned_lowering(other):
        for name in ("backprop", "gemm", "lud"):
            run_checked(f"{name}_{other}", name, other)
    run_checked("hotspot3d_fp", "hotspot3d", lowering, quantized=False)
    path = {k: c.launches for k, c in all_counters().items()}
    check(all(path[k] for k in gptpu_counters()),
          f"a kernel of the GPTPU path never launched: {path}")
    out["launches"] = path
    return out


def profile_gptpu(dev, lowering):
    """Where each application's time goes on the card (quantized, n = APP_N,
    tpuGemm's lowering the card's): host wall time of a synchronised run
    after a warm one, beside the device time torch.profiler sees in a third,
    and its top kernels. Wall time includes making the inputs with numpy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.apps import ALL
    out = {}
    with pinned_lowering(lowering):
        for name in sorted(ALL):
            def run():
                ALL[name](APP_N, quantized=True, device=dev)
                torch.cuda.synchronize()
            run()
            t0 = time.perf_counter()
            run()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
            busy_ms, top = device_time(prof, 1, 3)
            out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                         "idle_share": 1 - busy_ms / wall_ms, "top_kernels_ms": top}
    return out


def check_gptpu_reference(dev, lowering):
    """Each application on the card (kernels) against the same application
    on the CPU (plain versions), tpuGemm's lowering pinned to the same
    choice on both: the card's, and for the three apps that call tpuGemm
    also the other one. Bitwise where the arithmetic is integer or the same
    IEEE operations in the same order: gaussian (its integer path), gemm and
    lud (the tile codes and scales, the exact int32 partials, the kernels'
    epilogues); hotspot3d's fp path within 1e-4 of the range; the other
    quantized apps within 1e-2 of the range, since a last-bit difference
    upstream of an int8 quantization (a mean, an exp, a sum taken in
    another order) moves a code by one step."""
    import numpy as np
    from repro_torch.apps import ALL
    other = "conv2d" if lowering == "fully_connected" else "fully_connected"
    cases = ([(n, True, lowering) for n in sorted(ALL)] + [("hotspot3d", False, lowering)]
             + [(n, True, other) for n in ("backprop", "gemm", "lud")])
    out = {}
    for name, quantized, low in cases:
        with pinned_lowering(low):
            g, ref_fn = ALL[name](APP_N, quantized=quantized, device=dev)
            c, _ = ALL[name](APP_N, quantized=quantized, device="cpu")
        g, c, ref = (np.asarray(v, np.float64) for v in (g, c, ref_fn()))
        rel = float(np.abs(g - c).max()) / float(ref.max() - ref.min())
        label = (name if quantized else f"{name}_fp") + ("" if low == lowering else f"_{low}")
        limit = 0.0 if name in ("gaussian", "gemm", "lud") else (1e-2 if quantized else 1e-4)
        check(bool(np.isfinite(g).all()) and rel <= limit,
              f"{label}: card vs CPU differ by {rel} of the range (limit {limit})")
        out[label] = {"max_diff_over_range": rel, "bitwise": bool(np.array_equal(g, c))}
    return out


# ------------------------------------------------ the public kernel entries

def check_ops(dev):
    """The port's five public kernel entries (repro_torch.kernels.ops) with
    CUDA tensors, at one shape each of tests/test_kernels.py, against the
    same entry on CPU copies of the same tensors (the plain versions):
    bitwise for the four whose kernels are bitwise equal to their plain
    versions, qgemv within rtol 2e-4 / atol 1e-4. Every count is set to 0
    before the phase and read after it; each entry must launch its own
    kernel exactly once and no other."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(14)

    def i8(*shape):
        return rng.integers(-127, 128, shape).astype(np.int8)

    def f32(*shape):
        return rng.uniform(1e-3, 1e-2, shape).astype(np.float32)

    def grid(a, rb, cb):
        return np.ascontiguousarray(a.reshape(rb, TILE, cb, TILE).swapaxes(1, 2))

    cases = {
        "qgemm_f32": ("qgemm", (i8(128, 512), i8(512, 128), f32(128))),
        "qgemm_i32": ("qgemm", (i8(128, 512), i8(512, 128))),
        "qgemm_tiles": ("qgemm_tile_scales", (grid(i8(256, 512), 2, 4), f32(2, 4),
                                              grid(i8(512, 256), 4, 2), f32(4, 2))),
        "stencil": ("stencil3x3", (rng.normal(size=(100, 300)).astype(np.float32),
                                   rng.normal(size=(3, 3)).astype(np.float32))),
        "qgemv": ("qgemv", (rng.normal(size=(8, 384)).astype(np.float32), i8(384, 512),
                            f32(512))),
    }
    counters = all_counters()
    for c in counters.values():
        c.launches = 0
    out = {}
    for entry, (kernel, args) in cases.items():
        fn = getattr(ops, entry)
        cpu = fn(*[torch.from_numpy(a) for a in args])
        before = {k: c.launches for k, c in counters.items()}
        card = fn(*[torch.from_numpy(a).to(dev) for a in args])
        torch.cuda.synchronize()
        moved = {k: c.launches - before[k] for k, c in counters.items()}
        check(moved == {k: int(k == kernel) for k in counters},
              f"ops.{entry} launched {moved}, expected one {kernel}")
        card = card.cpu()
        check(card.shape == cpu.shape and card.dtype == cpu.dtype,
              f"ops.{entry}: card gave {card.dtype} {tuple(card.shape)}, CPU "
              f"{cpu.dtype} {tuple(cpu.shape)}")
        err = float((card - cpu).abs().max())
        if entry == "qgemv":
            check(torch.allclose(card, cpu, rtol=2e-4, atol=1e-4),
                  f"ops.qgemv card vs CPU: max abs {err}")
        else:
            check(torch.equal(card, cpu), f"ops.{entry} card vs CPU not bitwise: {err}")
        out[entry] = {"kernel": kernel, "shape": list(card.shape), "max_abs_err": err,
                      "bitwise": bool(torch.equal(card, cpu))}
    return {k: c.launches for k, c in counters.items()}, out


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.to("cpu")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("[chip_smoke] run from the root of a checkout: src/repro_torch "
              "not found next to chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA card available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    print(card, flush=True)
    phase("card", nvidia_smi=card, name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    try:
        from repro_torch.kernels import _build
        seconds = _build.build_all()
        phase("build", seconds=seconds, libraries=sorted(_build.SIGNATURES), ptxas={
            k: [l for l in v.splitlines() if "registers" in l or "spill" in l]
            for k, v in _build.build_logs.items()})
        q_check = check_qgemm(dev)
        p_check = check_paged(dev)
        t_check = check_tile_scales(dev)
        s_check = check_stencil(dev)
        v_check = check_qgemv(dev)
        phase("kernels_vs_plain", qgemm=q_check, paged_decode_attention=p_check,
              qgemm_tile_scales=t_check, stencil3x3=s_check, qgemv=v_check)
        q_rows = time_qgemm(dev)
        p_rows = time_paged(dev)
        t_rows = time_tile_scales(dev)
        s_rows = time_stencil(dev)
        g_rows = time_qgemm_gptpu(dev)
        v_rows = time_qgemv(dev, q_rows)
        phase("kernel_times", card=card, qgemm=q_rows, paged_decode_attention=p_rows,
              qgemm_tile_scales=t_rows, stencil3x3=s_rows, qgemm_gptpu=g_rows,
              qgemv=v_rows)
        ops_launches, ops_out = check_ops(dev)
        phase("ops", launches=ops_launches, **ops_out)
        reqs, launches, serve_stats = check_serve()
        phase("serve", card=card, **serve_stats)
        phase("batch_invariance", **check_batch_invariance(reqs))
        phase("reference", **check_reference())
        phase("decode_profile", card=card, **profile_decode())
        stores, contiguous_tokens = check_stores()
        phase("stores", card=card, **stores)
        int8_kv = check_int8_kv()
        phase("int8_kv", card=card, **int8_kv)
        chunked = check_chunked()
        phase("chunked", card=card, **chunked)
        prefix = check_prefix_cache()
        phase("prefix_cache", card=card, **prefix)
        sampling_launches, sampling = check_sampling(reqs, serve_stats)
        phase("sampling", card=card, **sampling)
        spec_launches, spec = check_speculative()
        phase("speculative", card=card, **spec)
        fleet_launches, fleet = check_fleet(reqs, serve_stats, contiguous_tokens)
        phase("fleet", card=card, launches_note="in-process fleet runs only (router, "
              "disagg, drain, drain_contiguous); worker processes count their own",
              launches=fleet_launches, **fleet)
        gptpu = check_gptpu(dev)
        phase("gptpu", card=card, **gptpu)
        phase("gptpu_reference", lowering=gptpu["lowering"],
              **check_gptpu_reference(dev, gptpu["lowering"]))
        phase("gptpu_profile", card=card, lowering=gptpu["lowering"],
              **profile_gptpu(dev, gptpu["lowering"]))
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    decode = next(r for r in q_rows if (r["M"], r["K"], r["N"]) == (8, 2048, 5632))
    gemv = next(r for r in v_rows if (r["B"], r["K"], r["N"]) == (8, 2048, 5632))
    def summed(*runs):
        return {k: sum(r["launches"][k] for r in runs) for k in launches}
    by_path = {"serve": launches,
               "stores": summed(*(v for k, v in stores.items() if k in ROUTES)),
               "int8_kv": summed(*(v for k, v in int8_kv.items() if k in ROUTES)),
               "chunked": summed(chunked["fused"], chunked["chunked"],
                                 chunked["fused_contiguous"]),
               "prefix_cache": prefix["launches"], "sampling": sampling_launches,
               "speculative": spec_launches, "fleet": fleet_launches,
               "gptpu": gptpu["launches"], "ops": ops_launches}
    tile, sten = t_rows[-1], s_rows[0]          # 4096^3; the apps' 1024^2 field
    paged = p_rows[0]                           # the serving shape

    def counted(name):
        per = {p: c[name] for p, c in by_path.items()}
        return {"launches": sum(per.values()), "launches_by_path": per}

    kernels = [
        {"name": "qgemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qgemm.cu",
         "replaces": "src/repro/kernels/qgemm.py:60", **counted("qgemm"),
         "max_abs_err": q_check["max_abs_err"],
         "ms": decode["graph_ms"], "plain_ms": decode["plain_ms"],
         "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
         "library_ms": decode["library_ms"]},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:98",
         **counted("paged_decode_attention"),
         "max_abs_err": p_check["max_abs_err"],
         "ms": paged["graph_ms"], "plain_ms": paged["plain_ms"],
         "bound_ms": paged["bound_ms"], "bound_by": paged["bound_by"],
         "library_ms": paged["library_graph_ms"]},
        {"name": "qgemm_tile_scales", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qgemm_tile_scales.cu",
         "replaces": "src/repro/kernels/qgemm.py:117", **counted("qgemm_tile_scales"),
         "max_abs_err": t_check["max_abs_err"],
         "ms": tile["graph_ms"], "plain_ms": tile["plain_ms"],
         "bound_ms": tile["bound_ms"], "bound_by": tile["bound_by"],
         "library_ms": tile["library_graph_ms"]},
        {"name": "stencil3x3", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/stencil3x3.cu",
         "replaces": "src/repro/kernels/stencil3x3.py:42", **counted("stencil3x3"),
         "max_abs_err": s_check["max_abs_err"],
         "ms": sten["graph_ms"], "plain_ms": sten["plain_ms"],
         "bound_ms": sten["bound_ms"], "bound_by": sten["bound_by"],
         "library_ms": sten["library_graph_ms"]},
        {"name": "qgemv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qgemv.cu",
         "replaces": "src/repro/kernels/qdot_serve.py:36", **counted("qgemv"),
         "max_abs_err": v_check["max_abs_err"],
         "ms": gemv["ms"], "plain_ms": gemv["plain_ms"],
         "bound_ms": gemv["bound_ms"], "bound_by": gemv["bound_by"],
         "library_ms": gemv["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
