#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one JSON line each (with the
seconds since the previous line):

  1. card     — name and power limit (nvidia-smi), device count
  2. build    — nvcc builds of every kernel under src/repro_torch/kernels/csrc,
                with ptxas' registers and spills
  3. kernels  — each kernel against its plain PyTorch version on the card at
                its paths' shapes (qgemm: int32-exact and the bf16 pdot
                epilogue bitwise, in both regimes of its plan and both split
                paths, ragged shapes and -128 operands included, and at
                every projection of the other served configs; paged
                attention: their hd-128 head layouts (qwen2-vl's 12/2 too),
                partial leases, horizons on split boundaries, at
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
                traffic (tinyllama at full width and 11 of its 22 layers),
                contiguous, gather bridge and block-native plain,
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
 19. moe      — deepseek-moe-16b at full width and 7 of its 28 layers
                (streamed W8A8 build: its seconds and peak device memory) on the serve
                traffic: the kernel route twice (tokens equal), each
                request alone on a one-slot engine, contiguous, bridge and
                block-native plain bitwise in tokens and valid cache
                entries, the kernel route held to plain at f32, launches
                held to the forwards (qgemm 50 per forward), int8 KV,
                speculative decode with the target as its own draft
                (bitwise plain decode's, acceptance 1.0), Engine.embed, a
                decode step's profile (the routed experts' device time
                beside qgemm's), and the card against the CPU at 2 layers
 20. dense_configs — qwen3-14b (qk_norm), starcoder2-15b (LayerNorm, GeLU)
                and granite-20b (MQA) in turn at full width and a quarter
                of their depth (10, 10 and 13 layers) on
                the kernel route: the serve traffic, request 0 alone,
                launches held to each config's count, build seconds and
                peak memory, tok/s, TTFT, a decode step's profile, and the
                card against the CPU at 2 layers
 21. hybrid   — zamba2-7b at full width and 13 of its 81 layers (2 groups
                of a shared attention block with its LoRA W_q and 6 Mamba2
                layers, then 1) on the recurrent state store, streamed
                W8A8 build (seconds, peak memory, weight bytes): the row
                probes (the float W_q product, the ssm readout and the
                gated norm at 1, 3, 8 and 64 rows, the port's forms
                bitwise); 8 requests of 16 + 16 tokens 2 steps apart
                twice (tokens equal, qgemm 65 launches a position:
                admission replays the decode body over the bucket);
                requests 0 and 7 alone; Engine.embed; a decode step's
                profile (qgemm, the state update and readout, the W_q
                merge, the rest); tinyllama-1.1b with a 13-layer zamba2
                draft (tokens and rows bitwise plain decode's, the draft's
                index in lockstep); the card against the CPU at 13 layers:
                each layer on the CPU's input and one decode body within
                check_reference's fixed rule, the admission and 3 steps
                within twice the CPU's own one-ulp spread (that spread
                capped), two planted Mamba2 faults failing all three
 22. xlstm    — xlstm-125m at full width and depth (12 layers: 6
                mLSTM/sLSTM pairs, d_model 768, 4 heads of 192) on the
                recurrent store, streamed W8A8 build: the decode body's
                row probes (readout and normalizer trees, the fixed-row
                recurrent and up/down products at 1, 3, 8 and 64 rows,
                bitwise); 8 requests of 128 + 32 tokens 2 steps apart
                twice (tokens equal, qgemm 67 launches a position);
                requests 0 and 7 alone; Engine.embed; a decode step's
                profile (qgemm, the mLSTM and sLSTM steps); tinyllama-1.1b
                with a full-depth xlstm draft (vocab 32000: tokens and rows
                bitwise plain decode's, in lockstep); the card against the
                CPU at full depth by the hybrid's three scopes, two planted
                mLSTM faults failing all three and an sLSTM one reported
 23. vlm      — qwen2-vl-2b at full width and depth (28 layers, 12/2
                heads of hd 128, M-RoPE), streamed W8A8 build: 8 rows of
                256 patch embeddings with (t, h, w) positions prefilled
                into a contiguous store and block-native paged stores
                without and with the kernel, 32 text decode steps on each
                (contiguous and paged-plain bitwise in tokens and valid
                cache entries; qgemm 197 a forward, paged attention 28 a
                forward on the kernel route only); the kernel route held to
                plain at f32; apply_mrope card against CPU; a decode
                step's profile; the card against the CPU at 2 layers
 24. encdec   — seamless-m4t-medium at full width and depth (12 + 12
                layers, vocab 256206 padded to 256208), streamed W8A8
                build: the forward over 8 rows of 256 tokens and 64 frames
                (qgemm 193, the padded columns below -1e29 and never an
                argmax), the chunked attention against the plain one, 32
                decode steps (qgemm 97 a step), a decode step's profile,
                the card against the CPU at 2 + 2 layers
 25. train    — the training path (repro_torch.launch.train): tinyllama-1.1b
                at full width and depth (batch 8, seq 128, bf16 compute, f32
                master weights, remat) takes 8 AdamW steps through the CLI,
                twice: losses finite and below 2 ln V, step 0 (lr 0)
                leaving every parameter bitwise unchanged and step 1
                changing every leaf, the second run's losses bitwise the
                first's; one step's loss and grads with remat on and off
                bitwise equal, each step's peak device memory; the median
                step's wall time and tok/s, the params' and moments'
                bytes, one step profiled in forward, backward and
                optimizer parts beside the step's bound, the embedding's
                backward two ways; the card against the CPU at 2 layers in
                f32 (logits, loss, every grad leaf, one AdamW update on
                identical grads) and for every other family at its smoke
                config (MoE's aux too); the crash drill through the CLI
                twice (exit 42, "resumed from checkpoint step 6", "done: 8
                steps", the resumed losses bitwise equal); the 2-layer
                state's checkpoint round trip, bitwise (snapshot, write and
                load times); no kernel launched
 26. dryrun   — the pod-scale accounting (repro_torch.launch.dryrun): the
                CLI at full width on meta for tinyllama-1.1b, every shape,
                quantize off and serve; then three tinyllama-1.1b cells at
                full width and depth built on the card from the dry run's
                meta arguments (train 8 x 128; W8A8 decode of 8 rows over a
                2048-token cache; W8A8 prefill of 1 x 2048), each run once
                under the accounting context: contraction FLOPs equal to
                the meta count, qgemm's launches equal to its meta records,
                argument bytes equal to the allocator's requested bytes,
                the reckoned peak within 5% of max_memory_allocated; each
                cell's wall and device busy time beside its bound; every
                production cell's argument bytes against the card's memory
 27. distgemm — core.distributed_gemm at 16384^3, quantized (one qgemm
                launch; its int32 sums torch._int_mm's, bitwise) and float;
                qgemm at 16384^3 under a CUDA graph beside _int_mm's time
                and its bound

then the ``{"kernels": [...]}`` line (all five kernels, each with its
launches on each path: serve, stores, int8_kv, chunked, prefix_cache,
sampling, speculative, fleet (its in-process runs), gptpu, ops, moe,
dense_configs, hybrid, xlstm, vlm, encdec, train (0 each), dryrun and
distgemm (qgemm only); ``ms`` and
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


_PHASE_T0 = [time.perf_counter()]


def phase(label, **fields):
    """One phase's JSON line, with the seconds since the previous one."""
    now = time.perf_counter()
    fields["seconds_since_last_phase"] = now - _PHASE_T0[0]
    _PHASE_T0[0] = now
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


# (K, N) of every W8A8 projection of the other served configs: deepseek-moe-16b
# (attention 2048 x 2048, shared experts 2048 <-> 2816, lm_head 102400),
# qwen3-14b (q and o 5120 x 5120, k and v 5120 x 1024, MLP 5120 <-> 17408,
# lm_head 151936), starcoder2-15b (k and v 6144 x 512, MLP 6144 <-> 24576,
# lm_head 49152) and granite-20b (k and v 6144 x 128); q and o of the last
# two are 6144 x 6144; zamba2-7b (HYBRID_PAIRS); and the last three families
# (LAST_FAMILY_PAIRS)
# zamba2-7b: a mamba layer's wz 3584 x 7168, wxbc 3584 x 7296, wdt 3584 x 112
# and wo 7168 x 3584; the shared block's k, v and o 3584 x 3584 and MLP
# 3584 <-> 14336; the lm_head 3584 x 32000
HYBRID_PAIRS = ((3584, 7168), (3584, 7296), (3584, 112), (7168, 3584), (3584, 3584),
                (3584, 14336), (14336, 3584), (3584, 32000))
# xlstm-125m: the mLSTM's q, k, v, o-gate and o and the sLSTM's gates 768 x
# 768, the mLSTM's per-head input and forget gates 768 x 4, the lm_head
# 768 x 50304; qwen2-vl-2b: q and o 1536 x 1536, k and v 1536 x 256, the
# MLP 1536 <-> 8960, the lm_head 1536 x 151936; seamless-m4t-medium:
# attention 1024 x 1024, the MLP 1024 <-> 4096, the lm_head 1024 x 256208
LAST_FAMILY_PAIRS = ((768, 768), (768, 4), (768, 50304), (1536, 1536), (1536, 256),
                     (1536, 8960), (8960, 1536), (1536, 151936), (1024, 1024),
                     (1024, 4096), (4096, 1024), (1024, 256208))
MODEL_PAIRS = ((2048, 2816), (2816, 2048), (2048, 102400), (5120, 5120), (5120, 1024),
               (5120, 17408), (17408, 5120), (5120, 151936), (6144, 6144), (6144, 512),
               (6144, 128), (6144, 24576), (24576, 6144), (6144, 49152)) + HYBRID_PAIRS \
    + LAST_FAMILY_PAIRS


def check_qgemm(dev):
    """Bitwise against the plain version (and the int32 sums against an fp64
    product) in both regimes of the kernel's plan and both split paths: M in
    {1, 8, 16} (decode) and {17, 40, 128, 1024} at the five projection pairs,
    ragged and unaligned shapes (the kernel's staged path), decode shapes
    whose tiles fill the card unsplit, every operand
    holding int8's -128 in a row of A and a column of B; and M in {1, 8,
    40, 1024} (one slot, the decode batch, the speculative verify window,
    the serve batch's admission) at every projection of the other served
    configs (MODEL_PAIRS)."""
    import torch
    from repro_torch.kernels.qgemm import _sm_count, plan, qgemm, qgemm_plain
    gen = torch.Generator(device=dev).manual_seed(1)
    pairs = [(2048, 256), (2048, 2048), (2048, 5632), (5632, 2048), (2048, 32000)]
    # M = 40: the verify window of speculative decode (8 slots x 5 positions)
    cases = [(M, K, N) for M in (1, 8, 16, 17, 40, 128, 1024) for K, N in pairs]
    cases += [(37, 130, 257), (7, 5632, 33), (13, 130, 257), (20, 32, 64), (3, 32, 4096),
              (16, 1024, 40960)]
    cases += [(M, K, N) for M in (1, 8, 40, 1024) for K, N in MODEL_PAIRS]
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
        del a, b, exact, acc, out, ref, out32
    check(max_err == 0.0, f"qgemm f32 output differs from plain by {max_err}")
    check(len(paths) == 4, f"qgemm cases took only the plan paths {sorted(paths)}")
    torch.cuda.synchronize()
    return {"cases": len(cases), "model_pairs": len(MODEL_PAIRS),
            "plan_paths": sorted("/".join(x) for x in paths), "max_abs_err": max_err}


def time_qgemm(dev):
    """Kernel, plain and library times at every main-path projection shape:
    decode (M = 8 slots), the speculative verify window (M = 40 = 8 slots x
    5 positions) and one admission (M = 128 = one 128-token bucket), and at
    decode the other served configs' projections (MODEL_PAIRS), with the
    weight operand cold (``cold_copies``). ``ms``, ``plain_ms`` and
    ``library_ms`` are eager means (``time_ms``), which at these sizes count
    the host's time per call; ``graph_ms`` and ``library_graph_ms`` are
    device times (``graph_ms``). ``plan`` is the kernel's launch plan."""
    import itertools
    import torch
    from repro_torch.kernels.qgemm import _sm_count, plan, qgemm, qgemm_plain
    gen = torch.Generator(device=dev).manual_seed(2)
    sms = _sm_count(torch.device(dev).index or 0)
    rows = []
    tiny = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000))
    shapes = [(M, K, N) for M in (8, 40, 128) for K, N in tiny]
    for M, K, N in shapes + [(8, K, N) for K, N in MODEL_PAIRS]:
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


# the query / KV head layouts at hd 128 of the other served configs
HD128 = {"hd128_deepseek": (16, 16), "hd128_qwen3": (40, 8), "hd128_starcoder2": (48, 4),
         "hd128_granite": (48, 1), "hd128_qwen2vl": (12, 2)}


def split_edges(H, KV, MB=10, bs=16):
    """Eight horizons for a serving-shape table (MB entries of bs): 0, on and
    beside the first two split boundaries of the layout's own plan, the
    table's last cell, past it (an idle slot) and one inside."""
    from repro_torch.kernels.paged_attention import plan
    per = plan(MB, bs, H, KV).per * bs                       # positions per split
    S = MB * bs
    return [0, per - 1, per, 2 * per - 1, 2 * per, S - 1, S - 1 + 37, 100]


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
    one split; the other served configs' head layouts at hd 128 (HD128:
    16/16 MHA, 40/8, 48/4, 48/1 MQA) at the serving shape, and at it with
    horizons on and beside each layout's own split boundaries. Prefill
    cases, the main path's prefill shapes: the serve traffic's batch (8
    rows x 128 queries, horizons 0..127, tables of decode's 10 blocks) at
    tinyllama's layout and at each HD128 layout, and the chunked phase's
    last 256-query piece of two 2048-position rows (MB = 128, horizons
    1792..2047)."""
    import torch
    from repro_torch.kernels.paged_attention import paged_decode_attention, plan
    prefill = {
        "prefill_serving": prefill_rows_case(dev, 8, 128, 160),
        "prefill_chunked": prefill_rows_case(dev, 2, CHUNK_W, CHUNK_SEQ,
                                             start=CHUNK_SEQ - CHUNK_W, seed=10),
        **{f"prefill_{name}": prefill_rows_case(dev, 8, 128, 160, seed=50 + i, H=H, KV=KV,
                                                hd=128)
           for i, (name, (H, KV)) in enumerate(HD128.items())},
    }
    cases = {
        "serving": paged_case(dev),
        "serving_edges": paged_full_case(dev, split_edges(32, 4), 10),
        "long_full": paged_full_case(dev, [2047] * 8, 128, seed=6),
        "long_edges": paged_full_case(
            dev, [0, 127, 128, 1023, 1024, 2047, 2047 + 500, 5], 128, seed=7),
        "mha_f32": [t.float() if t.dtype == torch.bfloat16 else t for t in
                    paged_case(dev, B=3, H=4, KV=4, hd=16, bs=8, MB=3, seed=4)],
        **{name: paged_case(dev, H=H, KV=KV, hd=128, seed=20 + i)
           for i, (name, (H, KV)) in enumerate(HD128.items())},
        **{f"{name}_edges": paged_full_case(dev, split_edges(H, KV), 10, H=H, KV=KV, hd=128,
                                            seed=40 + i)
           for i, (name, (H, KV)) in enumerate(HD128.items())},
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
    """Kernel, plain and library times at the serving shape, at the
    long-context shape (8 slots, MB = 128: tinyllama's 2048-token context,
    every lease full, every horizon at the last cell), and at the serving
    shape with the other served configs' hd-128 head layouts (HD128), pools
    cold. ``ms``,
    ``plain_ms`` and ``library_ms`` are eager means (``time_ms``);
    ``graph_ms`` and ``library_graph_ms`` device times (``graph_ms``)."""
    import itertools
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain, plan)
    rows = []
    cases = [("serving", paged_case(dev)),
             ("long", paged_full_case(dev, [2047] * 8, 128, seed=8))]
    cases += [(name, paged_case(dev, H=H, KV=KV, hd=128, seed=30 + i))
              for i, (name, (H, KV)) in enumerate(HD128.items())]
    for name, case in cases:
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
        rows.append({"shape": name, "B": B, "MB": tables.shape[1], "H": H,
                     "KV": k.shape[2], "hd": hd,
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
    # on this route every forward, decode step or prefill batch, attends
    # through the paged-attention kernel once per layer
    forwards = steps + stats["prefill_batches"]
    check(launches["paged_decode_attention"] == forwards * cfg.n_layers,
          f"paged attention launched {launches['paged_decode_attention']} times, "
          f"expected {forwards} forwards x {cfg.n_layers} layers")
    check(launches["qgemm"] == per_forward(cfg) * forwards,
          f"qgemm launched {launches['qgemm']} times, expected {per_forward(cfg)} x "
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


def check_batch_invariance(reqs, setup=None):
    """Each request of the ``serve`` traffic served alone, by an engine of
    one slot built as ``serve.run`` builds its own (same weights, same
    prompt), must get the tokens it got in the batched run: there every
    decode step ran the 8 slots (qgemm at M = 8), here 1 (M = 1).
    ``setup``: another arch's (cfg, params, prompts, args)."""
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, params, _, args = setup or serve_setup()
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
    active = torch.ones(B, dtype=torch.bool, device=dev)
    steps, fed = [], []
    for i in range(n_steps):
        if feed is not None:
            toks = feed[i].to(dev)
        fed.append(toks.cpu())
        out, cache = SV.decode_paged(params, cfg, store.decode_cache(), toks,
                                     use_kernel=use_kernel, active=active)
        store.swap(cache)
        steps.append(out[:, -1])
        toks = out[:, -1].float().argmax(-1).to(torch.int32)[:, None]
    return logits, steps, fed


def check_reference(arch="tinyllama-1.1b", n_layers=None):
    """The full-width model on the card (kernels) against the same model on
    the CPU (plain versions), same weights and inputs, in the f32 compute
    dtype: a 16-token prefill of 2 prompts, as the kernel route's engine
    runs it (every query through the paged-attention kernel, its plain
    version on the CPU), and 3 block-native decode steps. ``arch`` at
    ``n_layers`` (None: its full depth).

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
    from repro_torch.launch.serve import quant_predicate
    from repro_torch.models import attention as A, serve as SV
    from repro_torch.models.model import init_model_quantized
    cfg = get_config(arch).replace(quantize="serve", dtype="float32")
    cfg = cfg.replace(n_layers=n_layers or cfg.n_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model_quantized(cfg, gen, quant_predicate, device="cuda")
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
        out[name] = hold_card_to_cpu(name, g, c)
    out["arch"], out["n_layers"] = arch, cfg.n_layers
    return out


def hold_card_to_cpu(name, g, c):
    """check_reference's rule on one set of logits, card ``g`` against CPU
    ``c``: finite, RMS difference <= 1.5% and max <= 6% of the CPU logits'
    absolute max, the same greedy token wherever the CPU's top-2 margin
    exceeds 0.3."""
    import torch
    g, c = g.float().cpu(), c.float()
    check(bool(torch.isfinite(g).all()), f"non-finite {name} logits on the card")
    d = (g - c).abs()
    scale, rms = float(c.abs().max()), float(d.pow(2).mean().sqrt())
    check(float(d.max()) <= FIXED_RULE[0] * scale and rms <= FIXED_RULE[1] * scale,
          f"card vs CPU {name} logits: max {float(d.max())}, rms {rms}, scale {scale}")
    top2 = c.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > CLEAR_MARGIN
    check(torch.equal(g.argmax(-1)[clear], c.argmax(-1)[clear]),
          f"card and CPU pick different clear greedy tokens ({name})")
    return {"max_abs_diff": float(d.max()), "rms_diff": rms, "abs_max": scale,
            "clear_tokens_compared": int(clear.sum())}


def decode_stepper(cfg, params, B=8, P=128, seed=6):
    """A served decode step of ``cfg`` at full width: 8 slots of 128-token
    prompts in a paged store, admitted by the kernel route's prefill, each
    step block-native through the kernels with every slot active. Returns
    ``step()``, which runs one step and feeds its greedy tokens back."""
    import torch
    from repro_torch.models import attention as A, serve as SV
    from repro_torch.serving.store import PagedKVStore
    tokens = torch.randint(0, cfg.vocab, (B, P), generator=torch.Generator().manual_seed(seed))
    store = PagedKVStore(cfg, B, P + 32, block_size=16, native=True, device="cuda")
    for b in range(B):
        store.lease(b, P, 32)
    _, kv = SV.prefill_with_cache(params, cfg, tokens.cuda(), A.DecodeRows(P + 32, 16))
    store.write_slots(list(range(B)), kv, [P] * B)
    state = {"toks": torch.zeros((B, 1), dtype=torch.int32, device="cuda")}
    active = torch.ones(B, dtype=torch.bool, device="cuda")

    def step():
        logits, cache = SV.decode_paged(params, cfg, store.decode_cache(), state["toks"],
                                        active=active)
        store.swap(cache)
        state["toks"] = logits[:, -1].float().argmax(-1).to(torch.int32)[:, None]
    return step


def measure_steps(step, n, ranges=()):
    """Host wall ms per ``step()`` (synchronised) over ``n`` steps, then the
    same ``n`` steps under torch.profiler; ``ranges``: (module, function
    name) pairs wrapped in a profiler range of that name while profiled.
    The profile records the device's activity, and the host's ops only
    where ``ranges`` are named (a range's device-side span needs them):
    a served step issues thousands of host ops, and parsing their events
    took longer than the steps themselves. Returns (wall ms, the
    profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    saved = [(m, f, getattr(m, f)) for m, f in ranges]

    def ranged(fn, label):
        def call(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return call
    try:
        for m, f, fn in saved:
            setattr(m, f, ranged(fn, f))
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
        with profile(activities=acts) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
    finally:
        for m, f, fn in saved:
            setattr(m, f, fn)
    return wall_ms, prof


def range_device_ms(prof, n, label):
    """Device ms per run of the kernels launched inside the profiler range
    ``label`` (``measure_steps``' ``ranges``): the host-side range's device
    time, not the device-side span, which also counts the gaps."""
    from torch.autograd import DeviceType
    ev = [e for e in prof.key_averages() if e.key == label
          and e.device_type == DeviceType.CPU]
    if not ev:
        return None
    e = ev[0]
    return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) / 1e3 / n


def profile_decode():
    """Where a served decode step's time goes: the bf16 W8A8 model at full
    width, 8 slots of 128-token prompts, block-native decode. Host wall time
    per step (synchronised) over 8 steps, then the same 8 steps under
    torch.profiler for the device busy time and the kernels that fill it.

    Then the RMSNorm two ways, in turns (fused, tree, tree, fused), each
    8 steps timed and 8 profiled: the model's
    ``F.rms_norm`` (one launch) and :func:`tree_norm`, the same norm with
    its row sums by a fixed tree of halving adds."""
    from repro_torch.models import layers as L
    cfg, params, _, _ = serve_setup()
    n = 8
    step = decode_stepper(cfg, params)
    for _ in range(2):
        step()
    wall_ms, prof = measure_steps(step, n)
    busy_ms, top = device_time(prof, n, 8)
    check(busy_ms > 0, "decode_profile: the profile holds no device time")
    fused, norm_ab = L.apply_norm, []
    try:
        for name in ("fused", "tree", "tree", "fused"):
            L.apply_norm = fused if name == "fused" else tree_norm
            step()
            w, pr = measure_steps(step, n)
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


def device_time(prof, n, k, name="", ranges=()):
    """Device busy ms per run (of ``n`` profiled runs) and the ``k`` kernels
    that fill most of it, from device-side events only (the kernels and
    copies themselves: the operator events above them carry the same time
    again, and so does the device-side span of a profiler range named in
    ``ranges``); with ``name``, of the kernels whose name holds it only."""
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and name in e.key and e.key not in ranges]

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
FIXED_RULE = (0.06, 0.015)  # check_reference's max and RMS difference over the CPU's absolute max


def serve_setup(arch=None, argv=None, **replace):
    """The serve phase's model, weights and prompts, as serve.run builds
    them from SERVE_ARGS (``argv``: other CLI arguments; ``arch``: another
    ``--arch``; ``replace``: config fields to change): the streamed W8A8
    build."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import init_model_quantized
    argv = list(argv or SERVE_ARGS)
    if arch is not None:
        argv[argv.index("--arch") + 1] = arch
    args = serve.build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    cfg = (cfg.smoke() if args.smoke else cfg).replace(quantize=args.quantize, **replace)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_model_quantized(cfg, gen, serve.quant_predicate, device=args.device)
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
        view = clone_tree(engine.store.gather_view())
        engine.run_until_complete()
    finally:
        engine.close()
    wall = time.perf_counter() - t0
    stats = dict(engine.stats(), device_peak_bytes=torch.cuda.max_memory_allocated() - before)
    return (reqs, stats, {k: c.launches for k, c in counters.items()},
            wall, view, engine, decode_s)


def per_forward(cfg):
    """qgemm launches per forward of one token position block: q, k, v, o
    in every layer, the MLP's projections (wi, wg, wo with SwiGLU; wi, wo
    with GeLU) or a MoE layer's shared experts' (its routed experts
    contract in the compute dtype, outside qgemm), plus the lm_head."""
    mlp = 3 if cfg.act == "swiglu" else 2
    if cfg.family == "moe" and not cfg.n_shared_experts:
        mlp = 0
    return (4 + mlp) * cfg.n_layers + 1


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
    """Greedy speculative decode (spec_k = 4) on the serve traffic, at
    SPEC_LAYERS of tinyllama's layers, through
    the contiguous store, the paged gather bridge and block-native plain,
    with a good draft (the target's weights) and a bad one (generator seed
    --seed + 1): tokens and every request's retire-time cache rows bitwise
    those of plain decode on the same route, the good draft's acceptance
    within the length budget exactly 1.0, qgemm launches held to the
    forwards (k + 1 draft steps and one verify per round), and every block
    back in the free list after draining."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.model import init_model_quantized
    cfg, params, prompts, args = serve_setup(n_layers=SPEC_LAYERS)
    gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)
    bad = init_model_quantized(cfg, gen, serve.quant_predicate, device=args.device)
    out, launches_all = {}, []
    for route in ("contiguous", "bridge", "native_plain"):
        out[route], launches = speculative_route(cfg, params, prompts, args, route,
                                                 {"good": params, "bad": bad})
        launches_all += launches
    return {k: sum(l[k] for l in launches_all) for k in launches_all[0]}, {
        "spec_k": SPEC_K, "tokens_and_rows_bitwise_plain": True, **out}


def speculative_route(cfg, params, prompts, args, route, drafts):
    """Plain decode and speculative decode with each draft of ``drafts``
    (name -> weights; "good" is the target's own, whose acceptance within
    the length budget must be exactly 1.0; any other must be refused
    somewhere) on ``route``: tokens and every retire-time cache row
    bitwise plain decode's, launches held to the forwards, the census after
    draining. Returns the route's summary and the speculative runs'
    launches."""
    import numpy as np
    import torch
    snap = snapshot_engine_cls()
    plain = drive(cfg, params, prompts, args, engine_cls=snap, **ROUTES[route])
    out = {"plain": {"sustained_tok_s": plain[1]["sustained_tok_s"],
                     "decode_steps": plain[1]["decode_steps"], "wall_s": plain[3]}}
    launches_all = []
    for draft, dparams in drafts.items():
        reqs, stats, launches, wall, _, engine, round_s = drive(
            cfg, params, prompts, args, engine_cls=snap, draft_params=dparams,
            speculative=True, spec_k=SPEC_K, draft=cfg, **ROUTES[route])
        name = f"{cfg.name} {route}/{draft}"
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
        out[draft] = {
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
    return out, launches_all


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


# ------------------------------------------- the other families and configs

MOE_ARCH = "deepseek-moe-16b"
DENSE_ARCHS = ("qwen3-14b", "starcoder2-15b", "granite-20b")
REFERENCE_LAYERS = 2   # depth of the card-vs-CPU reference of the other configs
# Depth cuts of earlier slices' paths, so that the whole script, with this
# slice's three families at full width and depth, stays inside the 1200 s a
# run may take on a slow host too (a run whose host took 1043 s to reach
# the hybrid phase, against 926 s for a whole run before): every width and
# every check stays, the stack is shorter
SPEC_LAYERS = 11       # tinyllama in the speculative phase, of 22
MOE_LAYERS = 7         # deepseek-moe-16b, of 28
DENSE_LAYERS = {"qwen3-14b": 10, "starcoder2-15b": 10, "granite-20b": 13}  # of 40, 40, 52
HYBRID_LAYERS = 13     # zamba2-7b, of 81: two groups of the shared block and 6
                       # mamba layers, and one tail layer


def build_arch(arch, argv=None, **replace):
    """``serve_setup(arch, argv)`` timed, with the peak of allocated device
    memory over the streamed build (above what was allocated before it) and
    the weights' bytes."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup = serve_setup(arch, argv, **replace)
    torch.cuda.synchronize()
    build = {"seconds": time.perf_counter() - t0,
             "device_peak_bytes": torch.cuda.max_memory_allocated() - before,
             "weight_bytes": torch.cuda.memory_allocated() - before}
    return setup, build


def free_device():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def lap_clock():
    """``lap(name)`` records the seconds since the previous lap under
    ``name`` in the returned dict."""
    laps, last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now
    return laps, lap


def served_summary(run):
    """tok/s, TTFT and step medians of a ``drive`` run."""
    import numpy as np
    reqs, stats, launches, wall, _, _, decode_s = run
    return {"decode_steps": stats["decode_steps"], "prefill_batches": stats["prefill_batches"],
            "sustained_tok_s": stats["sustained_tok_s"], "wall_s": wall,
            "mean_ttft_ms": 1e3 * float(np.mean([r.metrics.ttft_s for r in reqs])),
            "decode_step_ms_median": 1e3 * float(np.median(decode_s)),
            "device_peak_bytes": stats["device_peak_bytes"], "launches": launches}


def profile_arch(cfg, params, n=2):
    """A served decode step of ``cfg`` (``decode_stepper``): host wall ms,
    device busy ms, its top kernels, qgemm's and paged attention's device
    ms, and the device ms under the MoE block's routed-expert products
    (``moe.expert_outputs``: dequantizing the experts and the batched
    products) and under its router and dispatch."""
    from repro_torch.models import moe as MOE
    step = decode_stepper(cfg, params)
    for _ in range(2):
        step()
    ranges = ((MOE, "expert_outputs"), (MOE, "dispatch"), (MOE, "router_scores"))
    ranges = ranges if cfg.family == "moe" else ()
    wall_ms, prof = measure_steps(step, n, ranges)
    busy_ms, top = device_time(prof, n, 8, ranges=[f for _, f in ranges])
    check(busy_ms > 0, f"{cfg.name}: the decode profile holds no device time")
    out = {"decode_step_wall_ms": wall_ms, "device_busy_ms_per_step": busy_ms,
           "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "qgemm_ms_per_step": device_time(prof, n, 0, "qgemm")[0],
           "paged_attention_ms_per_step": device_time(prof, n, 0, "paged_attention")[0],
           "top_kernels_ms_per_step": top}
    if cfg.family == "moe":
        out.update({f"{f}_ms_per_step": range_device_ms(prof, n, f) for _, f in ranges})
    return out


def dequant_times(cfg, params):
    """Device ms to dequantize one layer's routed ``wi`` (E, D, F) to bf16,
    two ways: the model's one pass (``moe._dequant``: int8 times the f32
    scale, stored as bf16) and an f32 copy scaled then cast; with the
    bound of the one pass (int8 read, bf16 written)."""
    import torch
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import layer_params
    w = layer_params(params["layers"], 0)["moe"]["wi"]
    one = time_ms(lambda: MOE._dequant(w, torch.bfloat16), 10)
    two = time_ms(lambda: (w.q.to(torch.float32) * w.scale).to(torch.bfloat16), 10)
    check(torch.equal(MOE._dequant(w, torch.bfloat16),
                      (w.q.to(torch.float32) * w.scale).to(torch.bfloat16)),
          "the one-pass dequant differs from the f32 one")
    return {"shape": list(w.q.shape), "one_pass_ms": one, "f32_then_cast_ms": two,
            "bound_ms": 1e3 * 3 * w.q.numel() / HBM_BYTES_PER_S}


def check_moe():
    """deepseek-moe-16b at full width and MOE_LAYERS layers behind the Engine, built by
    the streamed build, on the serve traffic (SERVE_ARGS with its --arch):
    the kernel route twice (tokens equal); each request alone on a one-slot
    engine (the batched tokens); contiguous, gather bridge and block-native
    plain bitwise equal in tokens and valid cache entries, and the kernel
    route held to block-native plain by check_reference's rule at f32
    (``kernel_vs_plain_route``: the kernel is the plain contraction's
    function to 1e-5, not its bits); launches held to the forwards on
    every route (qgemm 7 a layer and 1 per forward: 4 attention and 3
    shared-expert projections a layer and the lm_head); the int8 KV cache on the kernel
    route; greedy speculative decode with the target as its own draft on
    the contiguous store (tokens and retire-time rows bitwise plain
    decode's, acceptance within the budget 1.0); ``Engine.embed``; a decode
    step's profile; then the card against the CPU at full width and
    REFERENCE_LAYERS layers (check_reference). Returns the summary and the
    launches of every served run."""
    import numpy as np
    from repro_torch.serving.engine import Engine, EngineConfig
    laps, lap = lap_clock()
    (cfg, params, prompts, args), build = build_arch(MOE_ARCH, n_layers=MOE_LAYERS)
    check(per_forward(cfg) == 7 * MOE_LAYERS + 1,
          f"{MOE_ARCH}: {per_forward(cfg)} qgemm launches a forward")
    runs, launches = {}, []
    lap("build")
    first = drive(cfg, params, prompts, args, **ROUTES["native_kernel"])
    again = drive(cfg, params, prompts, args, **ROUTES["native_kernel"])
    for run in (first, again):
        check(all(r.done and len(r.tokens) == args.gen for r in run[0]),
              f"{MOE_ARCH}: a request did not finish")
        check(all(0 <= t < cfg.vocab for r in run[0] for t in r.tokens),
              f"{MOE_ARCH}: token out of vocab")
        check_route_launches(f"{MOE_ARCH} native_kernel", cfg, run[1], run[2], True)
        launches.append(run[2])
    check([r.tokens for r in first[0]] == [r.tokens for r in again[0]],
          f"{MOE_ARCH}: a second run of the kernel route gave other tokens")
    runs["native_kernel"] = served_summary(first)
    lap("kernel_route_twice")
    alone = check_batch_invariance(first[0], (cfg, params, prompts, args))
    lap("batch_invariance")
    routes, _ = serve_routes(cfg, params, prompts, args,
                             ["contiguous", "bridge", "native_plain"])
    launches += [routes[r]["launches"] for r in routes]
    lap("routes")
    kernel_vs_plain = kernel_vs_plain_route(cfg, params, prompts, args)
    lap("kernel_vs_plain")
    cfg8 = cfg.replace(kv_cache_dtype="int8")
    int8, _ = serve_routes(cfg8, params, prompts, args, ["native_kernel"])
    launches.append(int8["native_kernel"]["launches"])
    lap("int8_kv")
    spec, spec_launches = speculative_route(cfg, params, prompts, args, "contiguous",
                                            {"good": params})
    launches += spec_launches
    lap("speculative")
    engine = Engine(cfg, params, EngineConfig(max_slots=1, max_seq_len=args.prompt_len
                                              + args.gen), device=args.device)
    t0 = time.perf_counter()
    emb = engine.embed(prompts[0])
    embed_s = time.perf_counter() - t0
    engine.close()
    check(emb["embedding"].shape == (cfg.d_model,) and emb["logits"].shape == (cfg.vocab,)
          and np.isfinite(emb["embedding"]).all() and np.isfinite(emb["logits"]).all(),
          f"{MOE_ARCH}: Engine.embed gave a bad row")
    profile = profile_arch(cfg, params)
    profile["dequant_one_expert_matrix_set"] = dequant_times(cfg, params)
    lap("embed_and_profile")
    del params
    free_device()
    reference = check_reference(MOE_ARCH, REFERENCE_LAYERS)
    free_device()
    lap("reference")
    total = {k: sum(l[k] for l in launches) for k in launches[0]}
    return total, {"seconds": laps,
        "arch": MOE_ARCH, "n_layers": cfg.n_layers, "build": build, "serve": runs,
        "batch_invariance": alone, "routes": routes, "kernel_vs_plain": kernel_vs_plain,
        "int8_kv": int8, "speculative": spec,
        "embed": {"seconds": embed_s, "argmax": int(np.argmax(emb["logits"]))},
        "decode_profile": profile, "reference": reference,
        "qgemm_per_forward": per_forward(cfg), "launches": total}


def check_dense_configs():
    """qwen3-14b (qk_norm), starcoder2-15b (LayerNorm, GeLU) and granite-20b
    (MQA), each at full width and DENSE_LAYERS layers behind the Engine on the kernel
    route, built by the streamed build, one at a time (each freed before
    the next): the serve traffic once, request 0 alone on a one-slot engine
    (the same tokens), launches held to the config's count, the build's
    time and peak device memory, tok/s, TTFT and a decode step's profile;
    then the card against the CPU at REFERENCE_LAYERS layers."""
    from repro_torch.serving.engine import Engine, EngineConfig
    out, launches = {}, []
    for arch in DENSE_ARCHS:
        laps, lap = lap_clock()
        (cfg, params, prompts, args), build = build_arch(arch, n_layers=DENSE_LAYERS[arch])
        lap("build")
        run = drive(cfg, params, prompts, args, **ROUTES["native_kernel"])
        reqs = run[0]
        check(all(r.done and len(r.tokens) == args.gen for r in reqs),
              f"{arch}: a request did not finish")
        check(all(0 <= t < cfg.vocab for r in reqs for t in r.tokens),
              f"{arch}: token out of vocab")
        check_route_launches(f"{arch} native_kernel", cfg, run[1], run[2], True)
        launches.append(run[2])
        served = served_summary(run)
        engine = Engine(cfg, params, EngineConfig(
            max_slots=1, max_seq_len=args.prompt_len + args.gen,
            **ROUTES["native_kernel"], block_size=args.block_size), device=args.device)
        alone = engine.submit(reqs[0].prompt, args.gen, strict=True)
        engine.run_until_complete()
        engine.close()
        check(alone.tokens == reqs[0].tokens,
              f"{arch}: request 0 alone gave other tokens than in the batch")
        lap("serve_and_alone")
        profile = profile_arch(cfg, params)
        lap("profile")
        del params, run, engine
        free_device()
        out[arch] = {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
                     "kv_heads": cfg.n_kv, "hd": cfg.hd, "build": build, "serve": served,
                     "qgemm_per_forward": per_forward(cfg), "alone_same_tokens": True,
                     "decode_profile": profile,
                     "reference": check_reference(arch, REFERENCE_LAYERS)}
        free_device()
        lap("reference")
        out[arch]["seconds"] = laps
    total = {k: sum(l[k] for l in launches) for k in launches[0]}
    return total, {"launches": total, **out}


# ------------------------------------------------------------ the hybrid

HYBRID_ARCH = "zamba2-7b"
HYBRID_ARGS = ["--arch", HYBRID_ARCH, "--quantize", "serve", "--cache-backend", "recurrent",
               "--slots", "8", "--requests", "8", "--prompt-len", "16", "--gen", "16",
               "--stagger-steps", "2", "--device", "cuda"]
HYBRID_ALONE = (0, 7)          # the requests served again alone
HYBRID_EMBED_TOKENS = 32       # Engine.embed's prompt: one 32-position SSD chunk
HYBRID_DRAFT_LAYERS = 13       # one period of the layer pattern: 2 groups and 1 tail layer
HYBRID_REFERENCE_LAYERS = 13
PROBE_ROWS = (1, 3, 8, 64)


def hybrid_per_forward(cfg):
    """qgemm launches per hybrid forward of one position: wz, wxbc, wdt and
    wo in every mamba layer, k, v, o and the MLP's wi, wg, wo in every
    shared-block application (its LoRA-merged W_q is a float product, not
    a qgemm), and the lm_head."""
    return 4 * cfg.n_layers + 6 * (cfg.n_layers // cfg.attn_every) + 1


def scan_forwards(stats, flag):
    """Forwards of the admissions flagged ``flag/<bucket>``: the masked scan
    runs the decode body once per position of its bucket."""
    return sum(int(k.split("/")[1]) * v for k, v in stats["opq"]["flags"].items()
               if k.startswith(flag + "/"))


def rows_invariant(fn, n_rows):
    """Whether row 0 of ``fn(n)`` (a call on the first n rows of one input)
    keeps its bits at every n of ``n_rows``, against n = 1."""
    import torch
    one = fn(1)[0]
    return {n: bool(torch.equal(fn(n)[0], one)) for n in n_rows}


def hybrid_row_probes(cfg):
    """The three candidates for row bits that follow the row count, probed
    at PROBE_ROWS rows: (a) the shared block's float W_q product, bf16, the
    port's ``torch.matmul`` (layers.pdot's float branch); (b) the ssm
    readout over N, f32
    (``einsum("bhn,bhpn->bhp")`` against ssm.readout's tree); (c) the
    gated RMSNorm over d_inner, f32 (``torch.mean`` of squares against
    ``F.rms_norm``). The port's forms must keep a row's bits."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import ssm as SSM
    g = torch.Generator(device="cuda").manual_seed(21)
    R = max(PROBE_ROWS)
    D, HQ = cfg.d_model, cfg.n_heads * cfg.hd
    H, P, N, di = SSM.n_ssm_heads(cfg), cfg.ssm_headdim, cfg.ssm_state, SSM.d_inner(cfg)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    x, w = randn(R, D, dtype=torch.bfloat16), (randn(D, HQ) * D ** -0.5).to(torch.bfloat16)
    c, h = randn(R, H, N), randn(R, H, P, N)
    y, scale = randn(R, di), randn(di)
    out = {"rows": list(PROBE_ROWS), "wq_product": {
        "torch_matmul": rows_invariant(lambda n: torch.matmul(x[:n], w), PROBE_ROWS)},
        "ssm_readout": {
        "einsum": rows_invariant(lambda n: torch.einsum("bhn,bhpn->bhp", c[:n], h[:n]),
                                 PROBE_ROWS),
        "tree": rows_invariant(lambda n: SSM.readout(c[:n], h[:n]), PROBE_ROWS)},
        "gated_norm": {
        "torch_mean": rows_invariant(lambda n: y[:n] * torch.rsqrt(
            torch.mean(y[:n] * y[:n], -1, keepdim=True) + 1e-6) * scale, PROBE_ROWS),
        "rms_norm": rows_invariant(lambda n: F.rms_norm(y[:n], (di,), scale, 1e-6),
                                   PROBE_ROWS)}}
    for probe, form in (("wq_product", "torch_matmul"), ("ssm_readout", "tree"),
                        ("gated_norm", "rms_norm")):
        check(all(out[probe][form].values()),
              f"{probe}: the port's {form} form changes a row's bits with the row count")
    return out


def check_recurrent_launches(name, stats, launches, per):
    """qgemm launched ``per`` times a forward of one position (each decode
    step, and each position of each admission's masked scan), paged
    attention never."""
    forwards = stats["decode_steps"] + scan_forwards(stats, "prefill")
    check(launches["qgemm"] == per * forwards,
          f"{name}: qgemm launched {launches['qgemm']} times, expected "
          f"{per} x {forwards} forwards")
    check(launches["paged_decode_attention"] == 0, f"{name}: paged attention launched")
    return forwards


def recurrent_stepper(cfg, params, B=8, P=32, S=48):
    """A served decode step of a recurrent model at full width: 8 slots at
    position P of S-position rows on the recurrent store, every slot
    active, greedy tokens fed back. The rows start pristine (no
    admission): a step's work does not depend on the state's values."""
    import torch
    from repro_torch.models import serve as SV
    from repro_torch.serving.store import RecurrentStateStore
    store = RecurrentStateStore(cfg, B, S, device="cuda")
    store.cache = dict(store.cache, index=torch.full((B,), P, dtype=torch.int32,
                                                     device="cuda"))
    state = {"toks": torch.zeros((B, 1), dtype=torch.int32, device="cuda")}

    def step():
        logits, cache = SV.decode(params, cfg, store.decode_cache(), state["toks"])
        store.swap(cache)
        state["toks"] = logits[:, -1].float().argmax(-1).to(torch.int32)[:, None]
    return step


def profile_recurrent(cfg, params, ranges, n=1):
    """A served recurrent decode step (``recurrent_stepper``): host wall ms,
    device busy ms, its top kernels, and the device ms under qgemm and
    under each of ``ranges``, (module, function, label) triples reported as
    ``<label>_ms_per_step``, and the rest."""
    step = recurrent_stepper(cfg, params)
    for _ in range(2):
        step()
    wall_ms, prof = measure_steps(step, n, [(m, f) for m, f, _ in ranges])
    busy_ms, top = device_time(prof, n, 8, ranges=[f for _, f, _ in ranges])
    check(busy_ms > 0, f"{cfg.name}: the decode profile holds no device time")
    qgemm_ms = device_time(prof, n, 0, "qgemm")[0]
    out = {"decode_step_wall_ms": wall_ms, "device_busy_ms_per_step": busy_ms,
           "idle_share": 1 - busy_ms / wall_ms, "qgemm_ms_per_step": qgemm_ms}
    rest = busy_ms - qgemm_ms
    for _, f, label in ranges:
        out[f"{label}_ms_per_step"] = ms = range_device_ms(prof, n, f)
        rest -= ms or 0
    return dict(out, rest_ms_per_step=rest, top_kernels_ms_per_step=top)


def profile_hybrid(cfg, params, n=1):
    """A served hybrid decode step: the device ms under qgemm, the SSM state
    update and readout (``ssm.ssm_step``) and the shared W_q's
    dequantization and LoRA merge (``model.shared_attn_params``)."""
    from repro_torch.models import model as M, ssm as SSM
    return profile_recurrent(cfg, params, (
        (SSM, "ssm_step", "ssm_update_and_readout"),
        (M, "shared_attn_params", "wq_dequant_and_lora")), n)


def recurrent_draft_speculative(prompts, args, dcfg, draft_per_forward):
    """Greedy speculative decode of tinyllama-1.1b (full width) with the
    recurrent draft ``dcfg`` (its weights from ``args.seed``), on the
    contiguous store, over ``prompts`` with ``args``' traffic: tokens and
    every request's retire-time cache rows bitwise plain decode's; after
    every engine step each active slot's draft index equals the target's;
    qgemm launches held to the target's forwards (155 each) and the
    draft's (``draft_per_forward`` for each of its decode steps and each
    position of each admission's scan)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.model import init_model_quantized
    cfg, params, _, _ = serve_setup()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    dparams = init_model_quantized(dcfg, gen, serve.quant_predicate, device="cuda")
    snap = snapshot_engine_cls()

    class Lockstep(snap):
        lockstep_checks = 0

        def step(self):
            super().step()
            for slot in self.scheduler.active:
                check(self.draft_store.slot_index(slot) == self.store.slot_index(slot),
                      f"slot {slot}: the draft's index left the target's")
                self.lockstep_checks += 1
    plain = drive(cfg, params, prompts, args, engine_cls=snap, cache_backend="contiguous")
    reqs, stats, launches, wall, _, engine, round_s = drive(
        cfg, params, prompts, args, engine_cls=Lockstep, draft_params=dparams,
        speculative=True, spec_k=SPEC_K, draft=dcfg, cache_backend="contiguous")
    name = f"{cfg.name} with a {dcfg.n_layers}-layer {dcfg.name} draft"
    check(engine.draft_store.kind == "recurrent", f"{name}: the draft store is not recurrent")
    check([r.tokens for r in reqs] == [r.tokens for r in plain[0]],
          f"{name}: speculative tokens differ from plain decode's")
    for r, p in zip(reqs, plain[0]):
        for leaf, t in engine.rows[r.id].items():
            check(torch.equal(t, plain[5].rows[p.id][leaf]),
                  f"{name}: request {r.id}'s retire-time {leaf} rows differ from plain's")
    check(engine.lockstep_checks > 0, f"{name}: no lockstep check ran")
    target_forwards = stats["decode_steps"] + stats["prefill_batches"]
    draft_forwards = stats["draft_steps"] + scan_forwards(stats, "draft_prefill")
    want = per_forward(cfg) * target_forwards + draft_per_forward * draft_forwards
    check(launches["qgemm"] == want,
          f"{name}: qgemm launched {launches['qgemm']} times, expected {want}")
    snapshot_bytes = engine.draft_store.nbytes()
    out = {"target": cfg.name, "draft": dcfg.name, "draft_layers": dcfg.n_layers,
           "draft_vocab": dcfg.vocab, "prompt_len": args.prompt_len, "gen": args.gen,
           "spec_k": SPEC_K, "tokens_and_rows_bitwise_plain": True,
           "lockstep_checks": engine.lockstep_checks,
           "spec_rounds": stats["spec_rounds"], "draft_steps": stats["draft_steps"],
           "proposed_tokens": stats["proposed_tokens"],
           "accepted_tokens": stats["accepted_tokens"],
           "acceptance_rate": stats["acceptance_rate"],
           "acceptance_within_budget": stats["accepted_tokens"] / max(engine.spec_budget, 1),
           "accept_hist": stats["accept_hist"],
           "sustained_tok_s": stats["sustained_tok_s"], "wall_s": wall,
           "round_ms_median": 1e3 * float(np.median(round_s)),
           "plain": {"sustained_tok_s": plain[1]["sustained_tok_s"], "wall_s": plain[3]},
           "draft_store_bytes": snapshot_bytes,
           "snapshot_bytes_per_round": (SPEC_K + 1) * snapshot_bytes,
           "device_peak_bytes": stats["device_peak_bytes"],
           "qgemm_per_forward": {"target": per_forward(cfg), "draft": draft_per_forward},
           "launches": launches}
    del params, dparams, engine, plain
    free_device()
    return out, launches


def hybrid_draft_speculative(prompts, hargs):
    """tinyllama-1.1b with a zamba2-7b draft of HYBRID_DRAFT_LAYERS layers
    over the hybrid traffic (``recurrent_draft_speculative``)."""
    from repro_torch.configs import get_config
    dcfg = get_config(HYBRID_ARCH).replace(n_layers=HYBRID_DRAFT_LAYERS, quantize="serve")
    return recurrent_draft_speculative(prompts, hargs, dcfg, hybrid_per_forward(dcfg))


SENSITIVITY_FACTOR = 2.0       # card vs CPU over the run: at most this times the CPU's one-ulp spread
SENSITIVITY_CAP = (0.15, 0.03)  # that spread's max and RMS over the logits' absolute max, at most


def rule_fractions(g, c):
    """(max, RMS) of |g - c| over the absolute max of c, the CPU's, on the
    host."""
    g, c = g.float().cpu(), c.float().cpu()
    d = (g - c).abs()
    scale = float(c.abs().max())
    return float(d.max()) / scale, float(d.pow(2).mean().sqrt()) / scale


def within_fixed_rule(fractions):
    return fractions[0] <= FIXED_RULE[0] and fractions[1] <= FIXED_RULE[1]


def cache_rows(cache, rows):
    """A copy of rows ``rows`` of a recurrent decode cache (batch axis 0 of
    the index, 1 of every other leaf; nested dicts and None kept)."""
    def take(name, t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {n: take(n, u) for n, u in t.items()}
        return (t[rows] if name == "index" else t[:, rows]).clone()
    return {n: take(n, t) for n, t in cache.items()}


@contextlib.contextmanager
def layer_taps(wrapped, feed=None):
    """Records every call of the model functions ``wrapped`` (name in
    models/model.py -> (kind, the position of its x argument, fn(result) ->
    (output x, new states tuple or None))) that a decode body makes, in
    call order: (kind, input x, output x, states). With ``feed`` (an earlier
    recording) each call's input x is replaced by that call's recorded
    input, on this call's device: every layer then runs on the recording's
    input, whatever the layers before it gave."""
    from repro_torch.models import model as M
    saved, taps = {name: getattr(M, name) for name in wrapped}, []

    def tapped(name):
        kind, at, split = wrapped[name]
        fn = saved[name]

        def call(*a, **kw):
            a = list(a)
            if feed is not None:
                a[at] = feed[len(taps)][1].to(a[at].device)
            result = fn(*a, **kw)
            taps.append((kind, a[at]) + split(result))
            return result
        return call
    for name in wrapped:
        setattr(M, name, tapped(name))
    try:
        yield taps
    finally:
        for name, fn in saved.items():
            setattr(M, name, fn)


def hybrid_layer_taps(feed=None):
    """``layer_taps`` of the hybrid decode body: each shared-block
    application (no states) and mamba layer (new conv and ssm states)."""
    return layer_taps({"mamba_layer": ("mamba", 1, lambda r: (r[0], tuple(r[1]))),
                       "shared_block": ("shared", 2, lambda r: (r, None))}, feed)


def xlstm_pair_taps(feed=None):
    """``layer_taps`` of the xlstm decode body: each mLSTM/sLSTM pair, with
    its new mLSTM (C, n, m) and sLSTM (c, n, h, m) states."""
    return layer_taps({"xlstm_pair": ("pair", 1, lambda r: (r[0], tuple(r[1][0]) +
                                                             tuple(r[1][1])))}, feed)


def layer_fractions(card, cpu, state_names):
    """Each layer's fixed-rule fractions, card against CPU on the same
    input: its output's change to the residual stream, and each of its new
    states (``state_names``)."""
    out = []
    for (kind, x, o, s), (_, xc, oc, sc) in zip(card, cpu):
        row = {"kind": kind, "delta": rule_fractions(o - x, oc - xc)}
        if s is not None:
            row.update({n: rule_fractions(a, b) for n, a, b in zip(state_names, s, sc)})
        out.append(row)
    return out


def layer_holds(row):
    return all(within_fixed_rule(v) for k, v in row.items() if k != "kind")


def hybrid_fault(fault):
    """A copy of hybrid params with one Mamba2 piece broken in every layer:
    ``dskip_dropped`` drops the readout's D x skip term (Dskip 0),
    ``conv_tap_dropped`` the conv's oldest tap (conv_w[0] 0)."""
    import torch

    def apply(params):
        hp = params["hybrid"]

        def broken(part):
            if part is None:
                return None
            m = dict(part["mamba"])
            if fault == "dskip_dropped":
                m["Dskip"] = torch.zeros_like(m["Dskip"])
            else:
                m["conv_w"] = m["conv_w"].clone()
                m["conv_w"][..., 0, :] = 0
            return dict(part, mamba=m)
        return dict(params, hybrid=dict(hp, groups=broken(hp["groups"]),
                                        tail=broken(hp["tail"])))
    return apply


XLSTM_FAULTS = {"forget_bias_dropped": ("mlstm", "b_f"),
                "output_gate_dropped": ("mlstm", "wo_gate"),
                "slstm_recurrence_dropped": ("slstm", ("rz", "ri", "rf", "ro"))}


def xlstm_fault(fault):
    """A copy of xlstm params with one piece broken in every pair
    (XLSTM_FAULTS): ``forget_bias_dropped`` sets the mLSTM's forget-gate
    bias b_f to 0 (it is 3); ``output_gate_dropped`` zeroes the mLSTM's
    output-gate projection (its int8 codes), so the gate reads
    sigmoid(0) = 1/2; ``slstm_recurrence_dropped`` zeroes the sLSTM's
    recurrent weights R, so h_{t-1} no longer feeds its gates."""
    block, leaves = XLSTM_FAULTS[fault]
    leaves = (leaves,) if isinstance(leaves, str) else leaves

    def zero(t):
        import torch
        from repro_torch.core import tensorizer as tz
        if isinstance(t, tz.QTensor):
            return tz.QTensor(torch.zeros_like(t.q), t.scale, tuple(t.q.shape))
        return torch.zeros_like(t)

    def apply(params):
        pairs = params["xlstm"]["pairs"]
        part = dict(pairs[block], **{n: zero(pairs[block][n]) for n in leaves})
        return dict(params, xlstm={"pairs": dict(pairs, **{block: part})})
    return apply


HYBRID_REFERENCE = {"taps": hybrid_layer_taps, "state_names": ("conv", "ssm"),
                    "stateful": "mamba", "kinds": ("mamba", "shared"),
                    "faults": {f: hybrid_fault(f) for f in ("dskip_dropped",
                                                            "conv_tap_dropped")}}
XLSTM_REFERENCE = {"taps": xlstm_pair_taps,
                   "state_names": ("mlstm_C", "mlstm_n", "mlstm_m", "slstm_c", "slstm_n",
                                   "slstm_h", "slstm_m"),
                   "stateful": "pair", "kinds": ("pair",),
                   "faults": {f: xlstm_fault(f) for f in ("forget_bias_dropped",
                                                          "output_gate_dropped")},
                   # caught by the layer and run scopes, but one decode body
                   # moves less than the fixed rule: reported, not required
                   "reported_faults": {"slstm_recurrence_dropped":
                                       xlstm_fault("slstm_recurrence_dropped")}}


def check_reference_recurrent(arch, n_layers, spec, P=16, n_steps=3):
    """A recurrent model (``arch`` at full width and ``n_layers`` layers) on
    the card against the same model on the CPU (plain versions), same
    weights and inputs, in the f32 compute dtype, at three scopes. ``spec``
    (HYBRID_REFERENCE, XLSTM_REFERENCE) names the layer taps, the state
    names, the stateful layer kind and the planted faults.

    Each layer alone: one decode position from the CPU's post-admission
    state, every layer fed the CPU's input to it (``layer_taps``): its
    output's change to the residual stream and its new states within
    check_reference's fixed rule (FIXED_RULE) of the CPU's.

    One decode body: the same position, the card's layers feeding each
    other: the logits within the fixed rule (``hold_card_to_cpu``), before
    the recurrence has carried a difference across positions.

    The run: the masked-scan admission (prefill_recurrent) of 2 prompts of
    P tokens, then ``n_steps`` decode steps fed the CPU's greedy tokens.
    The bound is relative: at most SENSITIVITY_FACTOR times the CPU's own
    spread when every embedding entry moves by one f32 ulp (two more rows
    of the CPU's batch that read a nudged copy of the table; rows are
    independent), with the same greedy token wherever the CPU's top-2
    margin is clear. zamba2 moves as far under that nudge as the card
    moves from the CPU (12.7% max and 2.2% RMS of the logits' absolute
    max at 13 layers and 16 positions): a one-ulp change flips int8
    activation codes and the recurrence carries each flip into every later
    position. The spread itself must stay within SENSITIVITY_CAP of the
    scale, so a more chaotic config fails here rather than widening the
    bound; whether the fixed rule held is reported.

    Planted faults (a piece broken in the card's weights) must fail all
    three: every stateful layer alone, the decode body and the run's
    relative bound. ``reported_faults`` are run the same way and what they
    fail is reported, not required."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import quant_predicate
    from repro_torch.models import serve as SV
    from repro_torch.models.model import init_model_quantized
    cfg = get_config(arch).replace(quantize="serve", dtype="float32", n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model_quantized(cfg, gen, quant_predicate, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, P), generator=torch.Generator().manual_seed(5))
    V = cfg.vocab_padded
    taps_of, names = spec["taps"], spec["state_names"]

    def run(p, toks, pick):
        """The admission, then n_steps decode steps fed ``pick(step,
        logits)``: every output's logits on the host, and a copy of the
        post-admission cache."""
        dev = toks.device
        last = torch.full((toks.shape[0],), P - 1, dtype=torch.int32, device=dev)
        row, cache = SV.prefill_recurrent(p, cfg, toks, last, P + n_steps + 1)
        admitted = clone_tree(cache)
        outs = [row]
        for i in range(n_steps):
            logits, cache = SV.decode(p, cfg, cache, pick(i, outs[-1]).to(dev))
            outs.append(logits[:, -1])
        return [o.float().cpu() for o in outs], admitted
    cpu_params = _to_cpu(params)
    embed = cpu_params["embed"]
    both = dict(cpu_params, embed=torch.cat(
        [embed, torch.nextafter(embed, torch.full_like(embed, float("inf")))]))
    fed = []

    def greedy_twice(i, logits):
        t = logits[:2].argmax(-1).to(torch.int32)[:, None]
        fed.append(t)
        return torch.cat([t, t + V])
    cpu_both, admitted = run(both, torch.cat([tokens, tokens + V]), greedy_twice)
    state, tok = cache_rows(admitted, [0, 1]), fed[0]

    # one decode position from the CPU's post-admission state: the CPU's
    # plain rows, and two rows that read the nudged table
    with taps_of() as taps:
        c_step = SV.decode(both, cfg, cache_rows(admitted, [0, 1, 0, 1]),
                           torch.cat([tok, tok + V]))[0][:, -1].float()
    feed = [(k, x[:2], o[:2], s and tuple(t[:2] for t in s)) for k, x, o, s in taps]

    def card_step(p, feed=None):
        with taps_of(feed) as taps:
            logits = SV.decode(p, cfg, tree_to(state, "cuda"), tok.cuda())[0]
        return logits[:, -1].float().cpu(), layer_fractions(taps, feed or [], names)

    def worst(rows, kind):
        picked = [v for r in rows if r["kind"] == kind for k, v in r.items() if k != "kind"]
        return {"max": max(f[0] for f in picked), "rms": max(f[1] for f in picked)}
    layers = card_step(params, feed)[1]
    check(all(layer_holds(r) for r in layers),
          f"card vs CPU, each layer on the same input: a layer outside the fixed rule "
          f"{[r for r in layers if not layer_holds(r)][:2]}")
    out = {"arch": arch, "n_layers": n_layers, "prompt_tokens": P,
           "fixed_rule": list(FIXED_RULE), "sensitivity_factor": SENSITIVITY_FACTOR,
           "sensitivity_cap": list(SENSITIVITY_CAP),
           "layers_alone": {"layers": len(layers),
                            **{f"worst_{k}": worst(layers, k) for k in spec["kinds"]}}}
    g_step = card_step(params)[0]
    out["decode_body"] = dict(hold_card_to_cpu("one decode body", g_step, c_step[:2]),
                              cpu_one_ulp_embed_fractions=rule_fractions(c_step[2:],
                                                                         c_step[:2]))

    def relative(g, cn):
        c, n = cn[:2], cn[2:]
        got = {"max_abs_diff": float((g - c).abs().max()),
               "rms_diff": float((g - c).pow(2).mean().sqrt())}
        sens = {"max_abs_diff": float((n - c).abs().max()),
                "rms_diff": float((n - c).pow(2).mean().sqrt())}
        return got, sens, all(got[k] <= SENSITIVITY_FACTOR * sens[k] for k in got)
    g_outs = run(params, tokens.cuda(), lambda i, logits: fed[i])[0]
    labels = ["prefill_recurrent"] + [f"decode{i}" for i in range(n_steps)]
    for name, g, cn in zip(labels, g_outs, cpu_both):
        c = cn[:2]
        check(bool(torch.isfinite(g).all()), f"non-finite {name} logits on the card")
        got, sens, holds = relative(g, cn)
        scale = float(c.abs().max())
        check(sens["max_abs_diff"] <= SENSITIVITY_CAP[0] * scale
              and sens["rms_diff"] <= SENSITIVITY_CAP[1] * scale,
              f"{name}: the CPU's one-ulp spread {sens} exceeds {SENSITIVITY_CAP} of the "
              f"logits' absolute max {scale}: too chaotic for a relative bound")
        check(holds, f"card vs CPU {name} logits: {got} above {SENSITIVITY_FACTOR} x the "
              f"CPU's one-ulp spread {sens}")
        top2 = c.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > CLEAR_MARGIN
        check(torch.equal(g.argmax(-1)[clear], c.argmax(-1)[clear]),
              f"card and CPU pick different clear greedy tokens ({name})")
        out[name] = {**got, "abs_max": scale, "clear_tokens_compared": int(clear.sum()),
                     "cpu_one_ulp_embed_sensitivity": sens,
                     "fixed_rule_holds": within_fixed_rule(rule_fractions(g, c))}

    out["planted_faults"], out["reported_faults"] = {}, {}
    stateful = spec["stateful"]
    faults = [(f, b, True) for f, b in spec["faults"].items()]
    faults += [(f, b, False) for f, b in spec.get("reported_faults", {}).items()]
    for fault, breaks, required in faults:
        broken = breaks(params)
        rows = card_step(broken, feed)[1]
        body = rule_fractions(card_step(broken)[0], c_step[:2])
        run_holds = [relative(g, cn)[2] for g, cn in zip(
            run(broken, tokens.cuda(), lambda i, logits: fed[i])[0], cpu_both)]
        hit = [r for r in rows if r["kind"] == stateful]
        flagged = sum(not layer_holds(r) for r in hit)
        check(not required or (flagged == len(hit) and not within_fixed_rule(body)
                               and not any(run_holds)),
              f"planted fault {fault} passed a card-vs-CPU rule: {flagged} of "
              f"{len(hit)} {stateful} layers flagged, decode body {body}, run "
              f"outputs within the relative bound {run_holds}")
        out["planted_faults" if required else "reported_faults"][fault] = {
            f"{stateful}_layers_flagged": flagged,
            "least_layer_max_fraction": min(max(v[0] for k, v in r.items() if k != "kind")
                                            for r in hit),
            "decode_body_fractions": body,
            "run_outputs_within_relative_bound": sum(run_holds)}
        del broken
    del params
    free_device()
    return out


def check_hybrid():
    """zamba2-7b at full width and HYBRID_LAYERS layers behind the Engine on
    the recurrent store, built by the streamed build: the three
    row-invariance probes; the hybrid traffic (8 slots; 8 requests of 16 +
    16 tokens, 2 steps apart: admission replays the decode body once per
    prompt position, and 32-token prompts took the phase past 300 s) twice,
    tokens equal and in the vocabulary, qgemm launches held to the
    forwards (65 a position at 13 layers); requests 0 and 7 alone on a one-slot engine
    (the batch's tokens); ``Engine.embed`` on a 32-token prompt (the
    chunked SSD form); a decode step's profile; greedy
    speculative decode of tinyllama-1.1b with a 13-layer zamba2 draft; the
    card against the CPU at 13 layers. Returns the launches of the served
    runs and the summary."""
    import numpy as np
    from repro_torch.serving.engine import Engine, EngineConfig
    laps, lap = lap_clock()
    (cfg, params, prompts, args), build = build_arch(HYBRID_ARCH, argv=HYBRID_ARGS,
                                                     n_layers=HYBRID_LAYERS)
    check(hybrid_per_forward(cfg) == 65,
          f"{HYBRID_ARCH}: {hybrid_per_forward(cfg)} qgemm launches a position")
    lap("build")
    probes = hybrid_row_probes(cfg)
    lap("row_probes")
    runs, launches = [], []
    for _ in range(2):
        run = drive(cfg, params, prompts, args, cache_backend="recurrent")
        reqs, stats = run[0], run[1]
        check(all(r.done and len(r.tokens) == args.gen for r in reqs),
              f"{HYBRID_ARCH}: a request did not finish")
        check(all(0 <= t < cfg.vocab for r in reqs for t in r.tokens),
              f"{HYBRID_ARCH}: token out of vocab")
        check(stats["cache"]["backend"] == "recurrent", f"{HYBRID_ARCH}: not on the "
              f"recurrent store")
        check_recurrent_launches(f"{HYBRID_ARCH} recurrent", stats, run[2],
                                 hybrid_per_forward(cfg))
        runs.append(run)
        launches.append(run[2])
    check([r.tokens for r in runs[0][0]] == [r.tokens for r in runs[1][0]],
          f"{HYBRID_ARCH}: a second run of the same traffic gave other tokens")
    served = served_summary(runs[0])
    served.update(prefill_wait_s=runs[0][1]["prefill_wait_s"],
                  admission_s_per_request=runs[0][1]["prefill_wait_s"] / len(prompts),
                  scan_positions=scan_forwards(runs[0][1], "prefill"),
                  cache_bytes=runs[0][1]["cache"]["bytes"],
                  second_run_tok_s=runs[1][1]["sustained_tok_s"])
    lap("serve_twice")
    alone = check_batch_invariance([runs[0][0][i] for i in HYBRID_ALONE],
                                   (cfg, params, prompts, args))
    alone["requests_alone"] = list(HYBRID_ALONE)
    lap("batch_invariance")
    engine = Engine(cfg, params, EngineConfig(max_slots=1, max_seq_len=args.prompt_len
                                              + args.gen), device=args.device)
    embed_prompt = np.concatenate([prompts[0], prompts[1]])[:HYBRID_EMBED_TOKENS]
    t0 = time.perf_counter()
    emb = engine.embed(embed_prompt)
    embed_s = time.perf_counter() - t0
    engine.close()
    check(emb["embedding"].shape == (cfg.d_model,) and emb["logits"].shape == (cfg.vocab,)
          and np.isfinite(emb["embedding"]).all() and np.isfinite(emb["logits"]).all(),
          f"{HYBRID_ARCH}: Engine.embed gave a bad row")
    profile = profile_hybrid(cfg, params)
    lap("embed_and_profile")
    del params, runs, engine
    free_device()
    spec, spec_launches = hybrid_draft_speculative(prompts, args)
    launches.append(spec_launches)
    lap("speculative")
    reference = check_reference_recurrent(HYBRID_ARCH, HYBRID_REFERENCE_LAYERS,
                                          HYBRID_REFERENCE)
    lap("reference")
    total = {k: sum(l[k] for l in launches) for k in launches[0]}
    return total, {"seconds": laps, "arch": HYBRID_ARCH, "n_layers": cfg.n_layers,
                   "d_model": cfg.d_model, "build": build, "row_probes": probes,
                   "serve": served, "batch_invariance": alone,
                   "embed": {"seconds": embed_s, "prompt_tokens": len(embed_prompt),
                             "argmax": int(np.argmax(emb["logits"]))},
                   "decode_profile": profile, "speculative": spec,
                   "reference": reference, "qgemm_per_forward": hybrid_per_forward(cfg),
                   "launches": total}


# ------------------------------------------------------------ the xlstm

XLSTM_ARCH = "xlstm-125m"
XLSTM_ARGS = ["--arch", XLSTM_ARCH, "--quantize", "serve", "--cache-backend", "recurrent",
              "--slots", "8", "--requests", "8", "--prompt-len", "128", "--gen", "32",
              "--stagger-steps", "2", "--device", "cuda"]
XLSTM_ALONE = (0, 7)            # the requests served again alone
XLSTM_DRAFT_VOCAB = 32000       # tinyllama's: the draft proposes target token ids
# the draft's traffic: the hybrid's shape (8 requests of 16 + 16 tokens) on
# tinyllama, for the same reason (each admission replays the draft's decode
# body over the prompt)
XLSTM_DRAFT_ARGS = ["--arch", "tinyllama-1.1b", "--quantize", "serve", "--slots", "8",
                    "--requests", "8", "--prompt-len", "16", "--gen", "16",
                    "--stagger-steps", "2", "--device", "cuda"]
XLSTM_REFERENCE_LAYERS = 12     # the full depth


def xlstm_per_forward(cfg):
    """qgemm launches per xlstm forward of one position: the mLSTM's wq,
    wk, wv, wi, wf, wo_gate and wo and the sLSTM's wz, wi, wf and wo in
    every pair (wup, wdown and the recurrent R stay float, as the serve
    predicate leaves them), and the lm_head."""
    return 11 * (cfg.n_layers // 2) + 1


def xlstm_row_probes(cfg):
    """The contractions of the xlstm decode body, probed at PROBE_ROWS rows,
    torch's plain forms beside the port's: the mLSTM readout
    (``einsum("bhpn,bhn->bhp")`` against ssm.readout's tree) and normalizer
    (``einsum("bhn,bhn->bh")`` against the tree), f32 over hd = 192; the
    sLSTM's block-diagonal recurrent product, f32 (``einsum("bhp,hpn->bhn")``
    against a ``matmul_fixed_rows`` call per head, the four gates side by
    side); the block's float up and down projections, bf16 (``torch.matmul``
    against ``xlstm.fdot``). The port's forms must keep a row's bits."""
    import torch
    from repro_torch.models import layers as L, ssm as SSM, xlstm as XL
    g = torch.Generator(device="cuda").manual_seed(23)
    R = max(PROBE_ROWS)
    H, hd = XL.heads(cfg)
    D = cfg.d_model
    bcfg = cfg.replace(dtype="bfloat16")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    q, C, n, hh = randn(R, H, hd), randn(R, H, hd, hd), randn(R, H, hd), randn(R, H, hd)
    Rw = randn(H, hd, 4 * hd) * hd ** -0.5
    x = randn(R, D, dtype=torch.bfloat16)
    wup, wdown = randn(D, 2 * D) * D ** -0.5, randn(D, D) * D ** -0.5

    def fixed_rec(k):
        return torch.stack([L.matmul_fixed_rows(hh[:k, j], Rw[j], XL.FIXED_ROWS)
                            for j in range(H)], dim=1)
    out = {"rows": list(PROBE_ROWS), "readout": {
        "einsum": rows_invariant(lambda k: torch.einsum("bhpn,bhn->bhp", C[:k], q[:k]),
                                 PROBE_ROWS),
        "tree": rows_invariant(lambda k: SSM.readout(q[:k], C[:k]), PROBE_ROWS)},
        "normalizer": {
        "einsum": rows_invariant(lambda k: torch.einsum("bhn,bhn->bh", n[:k], q[:k]),
                                 PROBE_ROWS),
        "tree": rows_invariant(lambda k: SSM.readout(q[:k], n[:k, :, None, :])[..., 0],
                               PROBE_ROWS)},
        "recurrent_product": {
        "einsum": rows_invariant(lambda k: torch.einsum("bhp,hpn->bhn", hh[:k], Rw),
                                 PROBE_ROWS),
        "fixed_rows": rows_invariant(fixed_rec, PROBE_ROWS)},
        "up_projection": {
        "torch_matmul": rows_invariant(lambda k: torch.matmul(x[:k], wup.to(x.dtype)),
                                       PROBE_ROWS),
        "fixed_rows": rows_invariant(lambda k: XL.fdot(x[:k], wup, bcfg), PROBE_ROWS)},
        "down_projection": {
        "torch_matmul": rows_invariant(lambda k: torch.matmul(x[:k], wdown.to(x.dtype)),
                                       PROBE_ROWS),
        "fixed_rows": rows_invariant(lambda k: XL.fdot(x[:k], wdown, bcfg), PROBE_ROWS)}}
    check(torch.allclose(fixed_rec(R), torch.einsum("bhp,hpn->bhn", hh, Rw), rtol=1e-4,
                         atol=1e-4), "the fixed-row recurrent product is not the einsum's")
    for probe, form in (("readout", "tree"), ("normalizer", "tree"),
                        ("recurrent_product", "fixed_rows"), ("up_projection", "fixed_rows"),
                        ("down_projection", "fixed_rows")):
        check(all(out[probe][form].values()),
              f"{probe}: the port's {form} form changes a row's bits with the row count")
    return out


def tinyllama_traffic(argv):
    """The prompts and arguments of the CLI arguments ``argv`` (prompts
    drawn as serve_setup draws them, over the arch's vocab), without a
    build."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(argv)
    prompts = np.random.default_rng(args.seed).integers(
        0, get_config(args.arch).vocab, (args.requests, args.prompt_len), dtype=np.int32)
    return prompts, args


def check_xlstm():
    """xlstm-125m at full width and depth (12 layers: 6 mLSTM/sLSTM pairs)
    behind the Engine on the recurrent store, built by the streamed build:
    the decode body's row probes; the xlstm traffic (8 slots; 8 requests of
    128 + 32 tokens, 2 steps apart: admission replays the decode body once
    per prompt position) twice, tokens equal and in the vocabulary, qgemm
    launches held to the forwards (67 a position); requests 0 and 7 alone
    on a one-slot engine (the batch's tokens); ``Engine.embed`` on request
    0's prompt (the full-sequence forms); a decode step's profile (qgemm,
    the mLSTM and sLSTM steps, the rest); greedy speculative decode of
    tinyllama-1.1b (8 requests of 16 + 16 tokens) with a full-depth xlstm
    draft whose vocab is tinyllama's; the card against the CPU at full depth
    (``check_reference_recurrent``, with planted xlstm faults). Returns the
    launches of the served runs and the summary."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm as XL
    from repro_torch.serving.engine import Engine, EngineConfig
    laps, lap = lap_clock()
    (cfg, params, prompts, args), build = build_arch(XLSTM_ARCH, argv=XLSTM_ARGS)
    check(xlstm_per_forward(cfg) == 67,
          f"{XLSTM_ARCH}: {xlstm_per_forward(cfg)} qgemm launches a position")
    lap("build")
    probes = xlstm_row_probes(cfg)
    lap("row_probes")
    runs, launches = [], []
    for _ in range(2):
        run = drive(cfg, params, prompts, args, cache_backend="recurrent")
        reqs, stats = run[0], run[1]
        check(all(r.done and len(r.tokens) == args.gen for r in reqs),
              f"{XLSTM_ARCH}: a request did not finish")
        check(all(0 <= t < cfg.vocab for r in reqs for t in r.tokens),
              f"{XLSTM_ARCH}: token out of vocab")
        check(stats["cache"]["backend"] == "recurrent", f"{XLSTM_ARCH}: not on the "
              f"recurrent store")
        check_recurrent_launches(f"{XLSTM_ARCH} recurrent", stats, run[2],
                                 xlstm_per_forward(cfg))
        runs.append(run)
        launches.append(run[2])
    check([r.tokens for r in runs[0][0]] == [r.tokens for r in runs[1][0]],
          f"{XLSTM_ARCH}: a second run of the same traffic gave other tokens")
    served = served_summary(runs[0])
    served.update(prefill_wait_s=runs[0][1]["prefill_wait_s"],
                  admission_s_per_request=runs[0][1]["prefill_wait_s"] / len(prompts),
                  scan_positions=scan_forwards(runs[0][1], "prefill"),
                  cache_bytes=runs[0][1]["cache"]["bytes"],
                  second_run_tok_s=runs[1][1]["sustained_tok_s"])
    lap("serve_twice")
    alone = check_batch_invariance([runs[0][0][i] for i in XLSTM_ALONE],
                                   (cfg, params, prompts, args))
    alone["requests_alone"] = list(XLSTM_ALONE)
    lap("batch_invariance")
    engine = Engine(cfg, params, EngineConfig(max_slots=1, max_seq_len=args.prompt_len
                                              + args.gen), device=args.device)
    t0 = time.perf_counter()
    emb = engine.embed(prompts[0])
    embed_s = time.perf_counter() - t0
    engine.close()
    check(emb["embedding"].shape == (cfg.d_model,) and emb["logits"].shape == (cfg.vocab,)
          and np.isfinite(emb["embedding"]).all() and np.isfinite(emb["logits"]).all(),
          f"{XLSTM_ARCH}: Engine.embed gave a bad row")
    profile = profile_recurrent(cfg, params, (
        (XL, "mlstm_step", "mlstm_update_and_readout"),
        (XL, "slstm_step", "slstm_recurrence_and_update")), n=2)
    lap("embed_and_profile")
    del params, runs, engine
    free_device()
    dcfg = get_config(XLSTM_ARCH).replace(vocab=XLSTM_DRAFT_VOCAB, quantize="serve")
    tprompts, targs = tinyllama_traffic(XLSTM_DRAFT_ARGS)
    spec, spec_launches = recurrent_draft_speculative(tprompts, targs, dcfg,
                                                      xlstm_per_forward(dcfg))
    launches.append(spec_launches)
    lap("speculative")
    reference = check_reference_recurrent(XLSTM_ARCH, XLSTM_REFERENCE_LAYERS,
                                          XLSTM_REFERENCE)
    lap("reference")
    total = {k: sum(l[k] for l in launches) for k in launches[0]}
    return total, {"seconds": laps, "arch": XLSTM_ARCH, "n_layers": cfg.n_layers,
                   "d_model": cfg.d_model, "heads": cfg.n_heads, "build": build,
                   "row_probes": probes, "serve": served, "batch_invariance": alone,
                   "embed": {"seconds": embed_s, "prompt_tokens": len(prompts[0]),
                             "argmax": int(np.argmax(emb["logits"]))},
                   "decode_profile": profile, "speculative": spec,
                   "reference": reference, "qgemm_per_forward": xlstm_per_forward(cfg),
                   "launches": total}


# ------------------------------------------------------------- the vlm

VLM_ARCH = "qwen2-vl-2b"
VLM_ROWS = 8
VLM_GRID = 16                  # a 16 x 16 patch grid: 256 patch embeddings a row
VLM_STEPS = 32                 # text decode steps after the image
VLM_F32_STEPS = 8              # the kernel route held to plain at f32
VLM_ROUTES = ("contiguous", "native_plain", "native_kernel")


def vlm_inputs(cfg, rows, grid, seed):
    """``rows`` rows of grid x grid patch embeddings N(0, 1) and their
    (t, h, w) M-RoPE position ids: t a seeded frame index per row, h and w
    the patch's place in the grid; on the card, from a CPU generator."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    P = grid * grid
    embeds = torch.randn((rows, P, cfg.d_model), generator=gen)
    t = torch.randint(0, 4, (rows, 1), generator=gen).expand(rows, P)
    i = torch.arange(P)
    p3 = torch.stack([t, (i // grid).expand(rows, P), (i % grid).expand(rows, P)])
    return embeds.cuda(), p3.to(torch.int32).cuda()


def vlm_run(params, cfg, embeds, p3, n_steps, route, feed=None):
    """One vlm request batch on a store route (VLM_ROUTES): the fused
    prefill over the patch embeddings as that route's engine would run it
    (each query a one-query decode row of the store's length; through the
    paged-attention kernel on the kernel route), the K/V written into the
    leased slots, then ``n_steps`` text decode steps (contiguous, or
    block-native plain or through the kernel), each fed its greedy tokens
    or ``feed[i]``, M-RoPE positions the index on all three sections.
    Every kernel's launches counted from 0. Returns a dict: the prefill's
    last-position logits, each step's logits, the fed tokens, the cache
    view, the launches, the prefill and step host times, and ``step``,
    which runs one more decode step (the store keeps room for 16). On CPU
    tensors the kernel route runs the kernels' plain versions."""
    import torch
    from repro_torch.models import attention as A, serve as SV
    from repro_torch.serving.store import ContiguousKVStore, PagedKVStore
    B, P = embeds.shape[:2]
    dev = embeds.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    length = _store_length(P, n_steps)
    if route == "contiguous":
        store = ContiguousKVStore(cfg, B, length, device=dev)
    else:
        store = PagedKVStore(cfg, B, length, block_size=16, native=True, device=dev)
    for b in range(B):
        check(store.lease(b, P, n_steps + 1), f"vlm {route}: lease refused")
    kernel = route == "native_kernel"
    counters = all_counters()
    for c in counters.values():
        c.launches = 0
    sync()
    t0 = time.perf_counter()
    logits, kv = SV.prefill_with_cache(params, cfg, None,
                                       A.DecodeRows(length, 16 if kernel else None),
                                       embeds=embeds, positions3=p3)
    sync()
    prefill_s = time.perf_counter() - t0
    store.write_slots(list(range(B)), kv, [P] * B)
    del kv
    state = {"toks": logits[:, -1].float().argmax(-1).to(torch.int32)[:, None]}
    active = torch.ones(B, dtype=torch.bool, device=dev)

    def step():
        if route == "contiguous":
            out, cache = SV.decode(params, cfg, store.decode_cache(), state["toks"])
        else:
            out, cache = SV.decode_paged(params, cfg, store.decode_cache(), state["toks"],
                                         use_kernel=kernel, active=active)
        store.swap(cache)
        state["toks"] = out[:, -1].float().argmax(-1).to(torch.int32)[:, None]
        return out[:, -1]
    steps, fed, step_s = [], [], []
    for i in range(n_steps):
        if feed is not None:
            state["toks"] = feed[i].to(dev)
        fed.append(state["toks"].cpu())
        t0 = time.perf_counter()
        steps.append(step())
        sync()
        step_s.append(time.perf_counter() - t0)
    return {"prefill": logits[:, -1], "steps": steps, "fed": fed,
            "view": clone_tree(store.gather_view()),
            "launches": {k: c.launches for k, c in counters.items()},
            "prefill_s": prefill_s, "step_s": step_s, "step": step}


def check_vlm():
    """qwen2-vl-2b at full width and depth (28 layers, 12/2 heads of hd 128,
    M-RoPE sections (16, 24, 24)), streamed W8A8 build: 8 rows of 256 patch
    embeddings over a 16 x 16 grid (``vlm_inputs``) prefilled with their
    (t, h, w) positions into a contiguous store, a block-native paged store
    without the kernel and one with the kernel, then 32 text decode steps
    on each (``vlm_run``): contiguous and paged-plain bitwise in tokens and
    in every valid cache entry; qgemm 197 launches per forward (7 a layer
    and the lm_head) and paged attention 28 per forward on the kernel route
    only; the kernel route held to paged-plain in the f32 compute dtype
    (prefill and VLM_F32_STEPS steps fed plain's tokens): the prefill by
    check_reference's rule, each decode step by ``hold_relative`` against
    paged-plain with its input embeddings moved one ulp (28 W8A8 layers
    over 256 cached positions carry a moved int8 code on, so a decode step
    can leave the fixed rule where the prefill held it); ``apply_mrope`` card against CPU; a decode step's profile on
    the kernel route; the card against the CPU at REFERENCE_LAYERS layers
    (the kernel route, prefill and 3 steps)."""
    import numpy as np
    import torch
    from repro_torch.models import layers as L
    laps, lap = lap_clock()
    (cfg, params, _, _), build = build_arch(VLM_ARCH)
    check(per_forward(cfg) == 197, f"{VLM_ARCH}: {per_forward(cfg)} qgemm launches a forward")
    embeds, p3 = vlm_inputs(cfg, VLM_ROWS, VLM_GRID, seed=31)
    lap("build")
    runs, out, launches = {}, {}, []
    for route in VLM_ROUTES:
        r = vlm_run(params, cfg, embeds, p3, VLM_STEPS, route)
        forwards = 1 + VLM_STEPS
        check(r["launches"]["qgemm"] == per_forward(cfg) * forwards,
              f"vlm {route}: qgemm launched {r['launches']['qgemm']} times, expected "
              f"{per_forward(cfg)} x {forwards}")
        want = forwards * cfg.n_layers if route == "native_kernel" else 0
        check(r["launches"]["paged_decode_attention"] == want,
              f"vlm {route}: paged attention launched "
              f"{r['launches']['paged_decode_attention']} times, expected {want}")
        toks = torch.cat(r["fed"] + [r["steps"][-1].float().argmax(-1).to(
            torch.int32)[:, None].cpu()], dim=1)
        check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), f"vlm {route}: token out of "
              f"vocab")
        check(all(bool(torch.isfinite(s.float()).all()) for s in r["steps"]),
              f"vlm {route}: non-finite logits")
        runs[route] = (toks, r["view"])
        out[route] = {"prefill_s": r["prefill_s"],
                      "decode_step_ms_median": 1e3 * float(np.median(r["step_s"])),
                      "launches": r["launches"]}
        launches.append(r["launches"])
        if route == "native_kernel":
            for _ in range(2):
                r["step"]()
            wall_ms, prof = measure_steps(r["step"], 2)
            busy_ms, top = device_time(prof, 2, 8)
            check(busy_ms > 0, "vlm: the decode profile holds no device time")
            out["decode_profile"] = {
                "decode_step_wall_ms": wall_ms, "device_busy_ms_per_step": busy_ms,
                "idle_share": 1 - busy_ms / wall_ms,
                "qgemm_ms_per_step": device_time(prof, 2, 0, "qgemm")[0],
                "paged_attention_ms_per_step": device_time(prof, 2, 0, "paged_attention")[0],
                "top_kernels_ms_per_step": top}
        del r
    check(torch.equal(runs["contiguous"][0], runs["native_plain"][0]),
          "vlm: paged-plain gave other tokens than contiguous")
    same_valid_entries("vlm native_plain vs contiguous", runs["native_plain"][1],
                       runs["contiguous"][1], runs["contiguous"][1]["index"])
    out["contiguous_native_plain_bitwise"] = True
    lap("routes")
    f32 = cfg.replace(dtype="float32")
    plain = vlm_run(params, f32, embeds, p3, VLM_F32_STEPS, "native_plain")
    kern = vlm_run(params, f32, embeds, p3, VLM_F32_STEPS, "native_kernel",
                   feed=plain["fed"])
    nudged = vlm_run(params, f32, torch.nextafter(embeds, torch.full_like(
        embeds, float("inf"))), p3, VLM_F32_STEPS, "native_plain", feed=plain["fed"])
    out["kernel_vs_plain"] = {"dtype": "float32", "prefill": hold_card_to_cpu(
        "vlm kernel vs plain prefill", kern["prefill"], plain["prefill"].cpu())}
    for i, (k, p, n) in enumerate(zip(kern["steps"], plain["steps"], nudged["steps"])):
        out["kernel_vs_plain"][f"decode{i}"] = hold_relative(
            f"vlm kernel vs plain decode{i}", k, p, n)
    del plain, kern, nudged
    lap("kernel_vs_plain")
    x = torch.randn((VLM_ROWS, VLM_GRID ** 2, cfg.n_heads, cfg.hd), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    mrope = {}
    for dt in (torch.float32, torch.bfloat16):
        g = L.apply_mrope(x.to(dt), p3, cfg.rope_theta, cfg.mrope_sections).float().cpu()
        c = L.apply_mrope(x.to(dt).cpu(), p3.cpu(), cfg.rope_theta,
                          cfg.mrope_sections).float()
        d = (g - c).abs()
        # f32: within 16 f32 ulps of the largest value (cos and sin differ
        # in their last bits, then a product and a sum); bf16: within one
        # bf16 ulp of each value (a rounding moved by that f32 difference)
        if dt == torch.float32:
            holds = float(d.max()) <= 16 * 2 ** -23 * float(c.abs().max())
        else:
            holds = bool((d <= 2 ** -7 * c.abs() + 1e-5).all())
        check(holds, f"apply_mrope {dt} card vs CPU: max diff {float(d.max())}")
        mrope[str(dt).split(".")[1]] = {"max_abs_diff": float(d.max()),
                                        "abs_max": float(c.abs().max())}
    lap("mrope")
    profile = out.pop("decode_profile")
    del params
    free_device()
    reference = check_reference_vlm(REFERENCE_LAYERS)
    lap("reference")
    total = {k: sum(l[k] for l in launches) for k in launches[0]}
    return total, {"seconds": laps, "arch": VLM_ARCH, "n_layers": cfg.n_layers,
                   "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv,
                   "hd": cfg.hd, "rows": VLM_ROWS, "patches": VLM_GRID ** 2,
                   "decode_steps": VLM_STEPS, "build": build, "routes": out,
                   "decode_profile": profile, "mrope_card_vs_cpu": mrope,
                   "reference": reference, "qgemm_per_forward": per_forward(cfg),
                   "launches": total}


def hold_relative(name, g, c, n):
    """The relative rule of ``check_reference_recurrent``'s run on one set
    of logits: ``g`` against ``c`` at most SENSITIVITY_FACTOR times the
    spread of ``n`` (``c``'s computation with every input entry moved by
    one f32 ulp) in max and RMS difference, that spread within
    SENSITIVITY_CAP of ``c``'s absolute max, and the same greedy token
    wherever ``c``'s top-2 margin exceeds CLEAR_MARGIN. Whether the fixed
    rule held is reported."""
    import torch
    g, c, n = (t.float().cpu() for t in (g, c, n))
    check(bool(torch.isfinite(g).all()), f"non-finite {name} logits")
    scale = float(c.abs().max())
    got = {"max_abs_diff": float((g - c).abs().max()),
           "rms_diff": float((g - c).pow(2).mean().sqrt())}
    sens = {"max_abs_diff": float((n - c).abs().max()),
            "rms_diff": float((n - c).pow(2).mean().sqrt())}
    check(sens["max_abs_diff"] <= SENSITIVITY_CAP[0] * scale
          and sens["rms_diff"] <= SENSITIVITY_CAP[1] * scale,
          f"{name}: the one-ulp spread {sens} exceeds {SENSITIVITY_CAP} of the logits' "
          f"absolute max {scale}: too chaotic for a relative bound")
    check(all(got[k] <= SENSITIVITY_FACTOR * sens[k] for k in got),
          f"{name}: {got} above {SENSITIVITY_FACTOR} x the one-ulp spread {sens}")
    top2 = c.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > CLEAR_MARGIN
    check(torch.equal(g.argmax(-1)[clear], c.argmax(-1)[clear]),
          f"{name}: different clear greedy tokens")
    return {**got, "abs_max": scale, "clear_tokens_compared": int(clear.sum()),
            "one_ulp_input_sensitivity": sens,
            "fixed_rule_holds": within_fixed_rule(rule_fractions(g, c))}


def check_reference_vlm(n_layers, grid=8, n_steps=3):
    """qwen2-vl-2b at full width and ``n_layers`` layers on the card (the
    kernel route) against the same model on the CPU (the kernels' plain
    versions), same weights and inputs, f32 compute dtype: 2 rows of grid x
    grid patch embeddings prefilled, then ``n_steps`` decode steps fed the
    CPU's greedy tokens, each held by check_reference's rule."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import quant_predicate
    from repro_torch.models.model import init_model_quantized
    cfg = get_config(VLM_ARCH).replace(quantize="serve", dtype="float32", n_layers=n_layers)
    params = init_model_quantized(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  quant_predicate, device="cuda")
    embeds, p3 = vlm_inputs(cfg, 2, grid, seed=33)
    cpu = vlm_run(_to_cpu(params), cfg, embeds.cpu(), p3.cpu(), n_steps, "native_kernel")
    card = vlm_run(params, cfg, embeds, p3, n_steps, "native_kernel", feed=cpu["fed"])
    out = {"arch": VLM_ARCH, "n_layers": n_layers, "patches": grid * grid,
           "prefill": hold_card_to_cpu("vlm prefill", card["prefill"], cpu["prefill"])}
    for i, (g, c) in enumerate(zip(card["steps"], cpu["steps"])):
        out[f"decode{i}"] = hold_card_to_cpu(f"vlm decode{i}", g, c)
    del params, card
    free_device()
    return out


# ---------------------------------------------------------- the encdec

ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_ROWS = 8
ENCDEC_TOKENS = 256            # decoder tokens; the encoder reads tokens / 4 frames
ENCDEC_STEPS = 32


def encdec_per_forward(cfg):
    """qgemm launches per encdec forward: q, k, v, o and the GeLU MLP's wi,
    wo in every encoder layer (6); the self-attention's four, the cross
    attention's q, o and its K/V projections of the encoder's output, and
    the MLP's two in every decoder layer (10); the lm_head."""
    return 6 * cfg.n_enc_layers + 10 * cfg.n_layers + 1


def encdec_per_step(cfg):
    """qgemm launches per encdec decode step: the self-attention's four,
    the cross attention's q and o (its K/V are the cross cache's) and the
    MLP's two in every decoder layer, and the lm_head."""
    return 8 * cfg.n_layers + 1


def encdec_inputs(cfg, rows, n_tokens, seed):
    """``rows`` rows of ``n_tokens`` decoder tokens and n_tokens /
    enc_len_ratio frame embeddings N(0, 1), on the card, from a CPU
    generator."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (rows, n_tokens), generator=gen, dtype=torch.int32)
    frames = torch.randn((rows, n_tokens // cfg.enc_len_ratio, cfg.d_model), generator=gen)
    return tokens.cuda(), frames.cuda()


def check_padded_vocab(name, cfg, logits):
    """The padded vocab columns read below -1e29 and never win an argmax;
    the real columns are finite."""
    import torch
    check(bool(torch.isfinite(logits[..., :cfg.vocab].float()).all()),
          f"{name}: non-finite logits")
    check(bool((logits[..., cfg.vocab:].float() < -1e29).all()),
          f"{name}: a padded vocab column reads above -1e29")
    check(bool((logits.float().argmax(-1) < cfg.vocab).all()),
          f"{name}: a padded vocab column won an argmax")


def encdec_decode(params, cfg, tokens, n_steps, feed=None):
    """``n_steps`` decode steps of the encdec from a fresh scalar-index
    cache of ``tokens.shape[1] + n_steps`` positions, the first fed
    ``tokens[:, :1]``, each later one its greedy tokens (or ``feed[i]``).
    The cross cache stays as ``init_cache`` makes it, zero, as in the
    reference. Returns each step's logits, the fed tokens, the step host
    times and ``step`` (one more decode step)."""
    import torch
    from repro_torch.models import serve as SV
    B = tokens.shape[0]
    state = {"cache": SV.init_cache(cfg, B, tokens.shape[1] + n_steps + 8,
                                    device=tokens.device),
             "toks": tokens[:, :1]}

    def step():
        out, state["cache"] = SV.decode(params, cfg, state["cache"], state["toks"])
        state["toks"] = out[:, -1].float().argmax(-1).to(torch.int32)[:, None]
        return out[:, -1]
    steps, fed, step_s = [], [], []
    for i in range(n_steps):
        if feed is not None:
            state["toks"] = feed[i].to(tokens.device)
        fed.append(state["toks"].cpu())
        t0 = time.perf_counter()
        steps.append(step())
        if tokens.is_cuda:
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return steps, fed, step_s, step


def check_encdec():
    """seamless-m4t-medium at full width and depth (12 encoder and 12
    decoder layers, d_model 1024, 16 heads, LayerNorm, GeLU, vocab 256206
    padded to 256208), streamed W8A8 build: ``forward`` over 8 rows of 256
    decoder tokens and 64 frame embeddings (qgemm 193 launches: 6 an
    encoder layer, 10 a decoder layer, the lm_head), the two padded vocab
    columns below -1e29 and never an argmax; the encoder's first attention
    in the online-softmax form (chunks of 16 and 48) against the plain
    form in f32; 32 decode steps on the encdec cache (qgemm 97 a step, no
    paged attention); a decode step's profile; the card against the CPU at
    REFERENCE_LAYERS encoder and decoder layers."""
    import numpy as np
    import torch
    from repro_torch.models import attention as A, layers as L, model as M
    laps, lap = lap_clock()
    (cfg, params, _, _), build = build_arch(ENCDEC_ARCH)
    check(encdec_per_forward(cfg) == 193 and cfg.vocab_padded == cfg.vocab + 2,
          f"{ENCDEC_ARCH}: {encdec_per_forward(cfg)} qgemm launches a forward, vocab "
          f"{cfg.vocab} padded to {cfg.vocab_padded}")
    tokens, frames = encdec_inputs(cfg, ENCDEC_ROWS, ENCDEC_TOKENS, seed=41)
    lap("build")
    counters = all_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = M.forward(params, cfg, tokens, embeds=frames)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    fwd_launches = {k: c.launches for k, c in counters.items()}
    check(fwd_launches["qgemm"] == encdec_per_forward(cfg)
          and fwd_launches["paged_decode_attention"] == 0,
          f"{ENCDEC_ARCH}: forward launches {fwd_launches}")
    check(tuple(logits.shape) == (ENCDEC_ROWS, ENCDEC_TOKENS, cfg.vocab_padded),
          f"{ENCDEC_ARCH}: forward logits {tuple(logits.shape)}")
    check_padded_vocab(f"{ENCDEC_ARCH} forward", cfg, logits)
    padded = {"padded_columns": cfg.vocab_padded - cfg.vocab,
              "padded_max": float(logits[..., cfg.vocab:].float().max()),
              "real_min": float(logits[..., :cfg.vocab].float().min())}
    del logits
    lap("forward")
    f32 = cfg.replace(dtype="float32")
    lp = M.layer_params(params["encoder"], 0)
    Se = frames.shape[1]
    pos = torch.arange(Se, dtype=torch.int32, device="cuda").expand(ENCDEC_ROWS, Se)
    q, k, v = A._project_qkv(lp["attn"], L.apply_norm(lp["ln1"], frames, f32), f32, pos)
    plain = A._plain_attention(q, k, v, causal=False)
    chunked = {}
    for chunk in (16, 48):
        d = float((A._chunked_attention(q, k, v, False, chunk) - plain).abs().max())
        chunked[chunk] = d
        check(d <= 1e-5 * float(plain.abs().max()) + 1e-6,
              f"{ENCDEC_ARCH}: chunked attention (chunk {chunk}) differs from plain by {d}")
    lap("attention_forms")
    counters = all_counters()
    for c in counters.values():
        c.launches = 0
    steps, fed, step_s, step = encdec_decode(params, cfg, tokens, ENCDEC_STEPS)
    dec_launches = {k: c.launches for k, c in counters.items()}
    check(dec_launches["qgemm"] == encdec_per_step(cfg) * ENCDEC_STEPS
          and dec_launches["paged_decode_attention"] == 0,
          f"{ENCDEC_ARCH}: decode launches {dec_launches}, expected qgemm "
          f"{encdec_per_step(cfg)} x {ENCDEC_STEPS}")
    for i, s in enumerate(steps):
        check_padded_vocab(f"{ENCDEC_ARCH} decode{i}", cfg, s)
    for _ in range(2):
        step()
    wall_ms, prof = measure_steps(step, 2)
    busy_ms, top = device_time(prof, 2, 8)
    check(busy_ms > 0, "encdec: the decode profile holds no device time")
    profile = {"decode_step_wall_ms": wall_ms, "device_busy_ms_per_step": busy_ms,
               "idle_share": 1 - busy_ms / wall_ms,
               "qgemm_ms_per_step": device_time(prof, 2, 0, "qgemm")[0],
               "top_kernels_ms_per_step": top}
    lap("decode_and_profile")
    del params, steps, step
    free_device()
    reference = check_reference_encdec(REFERENCE_LAYERS)
    lap("reference")
    launches = {k: fwd_launches[k] + dec_launches[k] for k in fwd_launches}
    return launches, {
        "seconds": laps, "arch": ENCDEC_ARCH, "n_enc_layers": cfg.n_enc_layers,
        "n_layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
        "rows": ENCDEC_ROWS, "tokens": ENCDEC_TOKENS, "frames": ENCDEC_TOKENS // 4,
        "build": build, "forward_s": forward_s, "forward_launches": fwd_launches,
        "padded_vocab": padded, "chunked_vs_plain_max_abs_diff": chunked,
        "decode": {"steps": ENCDEC_STEPS,
                   "decode_step_ms_median": 1e3 * float(np.median(step_s)),
                   "launches": dec_launches},
        "decode_profile": profile, "reference": reference,
        "qgemm_per_forward": encdec_per_forward(cfg),
        "qgemm_per_step": encdec_per_step(cfg), "launches": launches}


def check_reference_encdec(n_layers, n_tokens=64, n_steps=3):
    """seamless-m4t-medium at full width with ``n_layers`` encoder and
    decoder layers on the card against the same model on the CPU (plain
    versions), same weights and inputs, f32 compute dtype: the forward over
    2 rows of ``n_tokens`` tokens and their frames, then ``n_steps`` decode
    steps fed the CPU's greedy tokens, each held by check_reference's rule
    over the real vocab columns (the padded two read -1e30)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import quant_predicate
    from repro_torch.models import model as M
    from repro_torch.models.model import init_model_quantized
    cfg = get_config(ENCDEC_ARCH).replace(quantize="serve", dtype="float32",
                                          n_layers=n_layers, n_enc_layers=n_layers)
    params = init_model_quantized(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  quant_predicate, device="cuda")
    tokens, frames = encdec_inputs(cfg, 2, n_tokens, seed=43)
    cpu_params = _to_cpu(params)
    V = cfg.vocab
    c_fwd = M.forward(cpu_params, cfg, tokens.cpu(), embeds=frames.cpu())[0][..., :V]
    g_fwd = M.forward(params, cfg, tokens, embeds=frames)[0][..., :V]
    out = {"arch": ENCDEC_ARCH, "n_layers": n_layers, "n_enc_layers": n_layers,
           "forward": hold_card_to_cpu("encdec forward", g_fwd, c_fwd)}
    del c_fwd, g_fwd
    c_steps, fed, _, _ = encdec_decode(cpu_params, cfg, tokens.cpu(), n_steps)
    g_steps = encdec_decode(params, cfg, tokens, n_steps, feed=fed)[0]
    for i, (g, c) in enumerate(zip(g_steps, c_steps)):
        out[f"decode{i}"] = hold_card_to_cpu(f"encdec decode{i}", g[..., :V], c[..., :V])
    del params
    free_device()
    return out


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


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return None if tree is None else tree.to(device)


def _to_cpu(tree):
    return tree_to(tree, "cpu")


def clone_tree(tree):
    """A copy of a (nested) cache dict that owns its storage; None stays."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


# ------------------------------------------------------------- training

TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_STEPS = 8
TRAIN_BATCH, TRAIN_SEQ = 8, 128          # the reference CLI's defaults
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ), "--log-every", "1", "--device", "cuda"]
TRAIN_REFERENCE_LAYERS = 2
TRAIN_REFERENCE_SHAPE = (2, 64)          # batch, seq of the card-vs-CPU step
TRAIN_FAMILIES = ("deepseek-moe-16b", "zamba2-7b", "xlstm-125m", "seamless-m4t-medium",
                  "qwen2-vl-2b")
# the f32 rule of tests/test_torch_train*.py: logits within this share of
# the reference's absolute max, the loss within this rtol, each grad leaf
# within this relative L2 norm, a leaf's norm floored at LEAF_FLOOR of the
# whole gradient's (a leaf whose true gradient is 0, as the sLSTM's
# input-gate bias, holds only rounding noise)
F32_LOGITS, F32_LOSS, F32_LEAF, LEAF_FLOOR = 1e-4, 1e-5, 1e-4, 1e-6
DRILL_ARGS = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "8", "--batch", "2", "--seq", "16",
              "--ckpt-every", "3", "--log-every", "2", "--device", "cuda"]
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
OPT_BYTES_PER_PARAM = 28       # AdamW reads p, g, m, v (f32) and writes p, m, v


def run_train_cli(argv, on_step=None):
    """``repro_torch.launch.train.main(argv)`` with its stdout captured:
    (exit code, its lines, a record per step: loss, gnorm, lr, aux and the
    host wall ms since the previous step's end, ``on_step``'s own time
    left out)."""
    import io
    from repro_torch.launch import train as TR
    records, last = [], [time.perf_counter()]

    def hook(step, params, opt_state, metrics):
        now = time.perf_counter()
        records.append({"step": step, "wall_ms": 1e3 * (now - last[0]),
                        **{k: float(metrics[k]) for k in ("loss", "gnorm", "lr", "aux")}})
        if on_step is not None:
            on_step(step, params, opt_state, metrics)
        last[0] = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = TR.main(argv, on_step=hook)
    return rc, buf.getvalue().splitlines(), records


def rel_l2(g, c, floor=0.0):
    """||g - c|| / max(||c||, floor) in f64 (the difference's norm where
    both are 0)."""
    import torch
    g, c = (t.detach().to("cpu", torch.float64) for t in (g, c))
    den = max(float(torch.linalg.vector_norm(c)), floor)
    num = float(torch.linalg.vector_norm(g - c))
    return num / den if den else num


def leaf_errors(got, ref):
    """Each grad leaf's :func:`rel_l2` against ``ref``, its norm floored
    at LEAF_FLOOR of the whole reference gradient's norm."""
    import torch
    total = sum(float(torch.linalg.vector_norm(c.detach().double())) ** 2 for c in ref) ** 0.5
    return [rel_l2(g, c, LEAF_FLOOR * total) for g, c in zip(got, ref)]


def hold_f32_rule(label, card, cpu):
    """Card against CPU by the f32 rule: (logits, loss, aux, grad leaves)
    of each side. Returns the measured fractions."""
    import torch
    lg, ll, la, lgr = card
    cl, cll, ca, cgr = cpu
    logits = float((lg.cpu() - cl).abs().max()) / float(cl.abs().max())
    loss = abs(float(ll) - float(cll)) / abs(float(cll))
    aux = abs(float(la) - float(ca)) / max(abs(float(ca)), 1e-30)
    leaves = leaf_errors(lgr, cgr)
    check(bool(torch.isfinite(lg).all()) and logits <= F32_LOGITS,
          f"{label}: logits differ by {logits} of the CPU's max (rule {F32_LOGITS})")
    check(loss <= F32_LOSS, f"{label}: loss {float(ll)} vs CPU {float(cll)}")
    check(aux <= F32_LOSS or float(ca) == 0 == float(la), f"{label}: aux {float(la)} vs "
          f"CPU {float(ca)}")
    check(max(leaves) <= F32_LEAF, f"{label}: a grad leaf differs by {max(leaves)} in "
          f"relative L2 (rule {F32_LEAF})")
    return {"logits_of_max": logits, "loss_rel": loss, "aux": float(la), "aux_rel": aux,
            "grad_leaf_rel_l2_max": max(leaves), "grad_leaves": len(leaves)}


def loss_and_grads(params, cfg, batch):
    """(logits, loss, aux, grads in JAX's leaf order) of one forward and
    backward, with no update."""
    import torch
    from repro_torch import tree as T
    from repro_torch.models import model as M
    from repro_torch.models import steps as ST
    with torch.no_grad():
        logits = M.train_forward(params, cfg, batch)[0]
    loss, metrics = ST.forward_for_grads(params, cfg, batch)
    grads = T.leaves(ST.grads_of(loss, params))
    return logits, loss.detach(), metrics["aux"], grads


def family_batch(cfg, B=2, S=16, seed=3):
    """A numpy-seeded batch of ``cfg``'s family: tokens, and the encdec's
    frames or the vlm's patch embeddings with (t, h, w) positions."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.family == "encdec":
        batch["embeds"] = rng.standard_normal((B, S // cfg.enc_len_ratio, cfg.d_model),
                                              dtype=np.float32)
    if cfg.family == "vlm":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
        side = int(S ** 0.5)
        grid = np.stack([np.zeros(S), np.arange(S) // side, np.arange(S) % side])
        batch["positions3"] = np.broadcast_to(grid[:, None], (3, B, S)).astype(np.int32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def train_bound_ms(cfg, B, S, remat=True):
    """The least time the card could take for one train step: the
    projections' and attention's multiply-adds at the dense bf16 peak
    (forward, backward at twice the forward, and with remat the layers'
    forward again), then AdamW's bytes at the memory rate."""
    from repro_torch import tree as T
    D, H, KV, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff
    per_layer = 2 * D * H * hd + 2 * D * KV * hd + 3 * D * F
    tokens = B * S
    layers = 2 * tokens * per_layer * cfg.n_layers + 4 * B * S * S * H * hd * cfg.n_layers
    head = 2 * tokens * D * cfg.vocab_padded
    flops = 3 * (layers + head) + (layers if remat else 0)
    n_params = sum(int(p.numel()) for p in T.leaves(init_shapes(cfg)))
    compute_ms = 1e3 * flops / BF16_OPS_PER_S
    opt_ms = 1e3 * n_params * OPT_BYTES_PER_PARAM / HBM_BYTES_PER_S
    return {"flops": flops, "compute_ms": compute_ms, "params": n_params,
            "optimizer_bytes": n_params * OPT_BYTES_PER_PARAM, "optimizer_ms": opt_ms,
            "bound_ms": compute_ms + opt_ms}


def init_shapes(cfg):
    """``cfg``'s param tree on the meta device (shapes only)."""
    import torch
    from repro_torch.models import init_model
    return init_model(cfg, torch.Generator(), device="meta")


def tree_bytes(tree):
    from repro_torch import tree as T
    return sum(t.numel() * t.element_size() for t in T.leaves(tree) if hasattr(t, "numel"))


def profile_train_step(params, opt_state, cfg, batch, step=5):
    """One train step profiled in three parts, each inside a
    ``record_function`` of its name and a profiler session of its own, the
    device synchronised between them (the backward's kernels are issued by
    autograd's device thread, outside any range of the caller's):
    forward (``forward_for_grads``), backward (``grads_of``, the layers'
    recompute under remat included) and optimizer (``apply_update``: the
    cast, the clip, the schedule, AdamW), the three functions that
    ``make_train_step`` runs. Returns each part's device busy ms and top
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import steps as ST
    parts = {}

    def part(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with record_function(name):
                out = fn()
            torch.cuda.synchronize()
        busy, top = device_time(prof, 1, 6)
        parts[name] = {"device_busy_ms": busy, "top_kernels_ms": top}
        return out, prof
    (loss, _), _ = part("forward", lambda: ST.forward_for_grads(params, cfg, batch))
    grads, bprof = part("backward", lambda: ST.grads_of(loss, params))
    part("optimizer", lambda: ST.apply_update(params, grads, opt_state, step, cfg))
    parts["backward"]["embedding_backward_ms"] = device_time(bprof, 1, 0, "embedding")[0]
    return parts


def embedding_backward_forms(cfg, B, S, reps=20):
    """The token table's backward at the train step's shape, two ways:
    ``F.embedding``'s (the port's) and the accumulating ``index_put_`` that
    ``table[tokens]`` takes. Each run twice on the same cotangent (bitwise
    equal or not) and timed (CUDA events, mean of ``reps``)."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (B * S,), generator=gen, device=dev)
    grad = torch.randn((B * S, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    V = cfg.vocab_padded

    def f_embedding():
        return torch.ops.aten.embedding_dense_backward(grad, tokens, V, -1, False)

    def index_put():
        return torch.zeros((V, cfg.d_model), dtype=grad.dtype, device=dev).index_put_(
            (tokens,), grad, accumulate=True)
    out = {}
    for name, fn in (("f_embedding", f_embedding), ("index_put_accumulate", index_put)):
        a, b = fn(), fn()
        out[name] = {"ms": time_ms(fn, reps), "repeat_bitwise": bool(torch.equal(a, b))}
    return out


def check_train():
    """The training path (repro_torch.launch.train): tinyllama-1.1b at full
    width and depth through the CLI, the card against the CPU at 2 layers
    and for every other family at its smoke config, the crash drill and a
    checkpoint round trip. Every kernel's launches are read around the
    phase: the path runs none."""
    import math
    import shutil
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.checkpoint import AsyncCheckpointer, load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as TR
    from repro_torch.models import init_model
    from repro_torch.models import steps as ST
    from repro_torch.optim import adamw_init
    dev = torch.device("cuda")
    counters = all_counters()
    for c in counters.values():
        c.launches = 0
    laps, lap = lap_clock()
    out = {}
    free_device()

    # a) full width and depth, through the CLI
    cfg = get_config(TRAIN_ARCH)
    init = T.leaves(TR.init_params(cfg, dev))
    seen = {}

    def watch(step, params, opt_state, metrics):
        now = T.leaves(params)
        if step == 0:
            seen["unchanged"] = sum(bool(torch.equal(a, b)) for a, b in zip(now, init))
        elif step == 1:
            seen["changed"] = sum(not torch.equal(a, b) for a, b in zip(now, init))
    torch.cuda.reset_peak_memory_stats()
    rc, lines, recs = run_train_cli(TRAIN_ARGS, watch)
    cli_peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"train: the CLI exited {rc}: {lines[-3:]}")
    n_leaves = len(init)
    del init
    losses = [r["loss"] for r in recs]
    check(len(recs) == TRAIN_STEPS and all(math.isfinite(x) and x < 2 * math.log(cfg.vocab)
                                           for x in losses), f"train: losses {losses}")
    check(recs[0]["lr"] == 0.0 and seen.get("unchanged") == n_leaves,
          f"train: step 0 (lr {recs[0]['lr']}) left {seen.get('unchanged')} of "
          f"{n_leaves} leaves unchanged")
    check(seen.get("changed") == n_leaves,
          f"train: step 1 changed {seen.get('changed')} of {n_leaves} leaves")
    lap("cli")
    free_device()
    rc2, _, recs2 = run_train_cli(TRAIN_ARGS)
    check(rc2 == 0 and [r["loss"] for r in recs2] == losses,
          f"train: a second run's losses {[r['loss'] for r in recs2]} != {losses}")
    lap("cli_again")
    walls = [r["wall_ms"] for r in recs[2:] + recs2[2:]]
    step_ms = float(np.median(walls))
    bound = train_bound_ms(cfg, TRAIN_BATCH, TRAIN_SEQ)
    out["full_width"] = {
        "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "batch": TRAIN_BATCH,
                   "seq": TRAIN_SEQ, "dtype": cfg.dtype, "remat": cfg.remat},
        "steps": [{k: r[k] for k in ("step", "loss", "gnorm", "lr", "wall_ms")} for r in recs],
        "log": [l for l in lines if l.startswith("[train]")],
        "second_run_bitwise": True, "step0_params_unchanged": True,
        "step1_changed_leaves": seen["changed"],
        "step_wall_ms_median": step_ms, "tok_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
        "cli_device_peak_bytes": cli_peak, "bound": bound}

    # remat on and off: one step's loss and grads, and each step's peak
    free_device()
    params = TR.init_params(cfg, dev)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(ds).items()}
    grads, peaks = {}, {}
    for remat in (True, False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, loss, _, g = loss_and_grads(params, cfg.replace(remat=remat), batch)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() - base
        grads[remat] = (loss, g)
        del g
    (l_on, g_on), (l_off, g_off) = grads[True], grads[False]
    remat_bitwise = bool(torch.equal(l_on, l_off)) and all(
        torch.equal(a, b) for a, b in zip(g_on, g_off))
    remat = {"bitwise": remat_bitwise, "loss": float(l_on),
             "fwd_bwd_peak_bytes_over_params": {"remat": peaks[True], "no_remat": peaks[False]}}
    if not remat_bitwise:
        worst = max(leaf_errors(g_on, g_off))
        check(abs(float(l_on) - float(l_off)) <= F32_LOSS * abs(float(l_off))
              and worst <= F32_LEAF, f"train: remat on/off differ beyond the f32 rule "
              f"(loss {float(l_on)} vs {float(l_off)}, a leaf {worst})")
        remat["grad_leaf_rel_l2_max"] = worst
    del grads, g_on, g_off
    free_device()
    opt_state = adamw_init(params)
    resident = {"params": tree_bytes(params), "moments": tree_bytes(opt_state.mu)
                + tree_bytes(opt_state.nu)}
    step_peaks = {}
    for remat_on in (True, False):
        step_fn = ST.make_train_step(cfg.replace(remat=remat_on))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params, opt_state, m = step_fn(params, opt_state, batch, 5)
        torch.cuda.synchronize()
        step_peaks["remat" if remat_on else "no_remat"] = torch.cuda.max_memory_allocated()
        check(math.isfinite(float(m["loss"])), "train: a step's loss is not finite")
    remat["step_device_peak_bytes"] = step_peaks
    out["full_width"]["remat"] = remat
    out["full_width"]["resident_bytes"] = resident
    lap("remat")

    # one profiled step: forward, backward, optimizer
    parts = profile_train_step(params, opt_state, cfg, batch)
    busy = sum(p["device_busy_ms"] for p in parts.values())
    check(busy > 0, "train: the profile holds no device time")
    out["full_width"]["profile"] = {
        "parts": parts, "device_busy_ms": busy, "step_wall_ms_median": step_ms,
        "idle_share": 1 - busy / step_ms, "host_ms": step_ms - busy,
        "embedding_backward_forms": embedding_backward_forms(cfg, TRAIN_BATCH, TRAIN_SEQ)}
    del params, opt_state, batch, m
    free_device()
    lap("profile")

    # b) card against CPU at 2 layers, f32
    cfg2 = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_REFERENCE_LAYERS, dtype="float32")
    B2, S2 = TRAIN_REFERENCE_SHAPE
    cpu_params = TR.init_params(cfg2, "cpu")
    card_params = tree_to(cpu_params, dev)
    ds2 = SyntheticLM(vocab=cfg2.vocab, seq_len=S2, global_batch=B2, seed=1)
    cpu_batch = {k: torch.from_numpy(v) for k, v in next(ds2).items()}
    card = loss_and_grads(card_params, cfg2, tree_to(cpu_batch, dev))
    cpu = loss_and_grads(cpu_params, cfg2, cpu_batch)
    ref = hold_f32_rule("train 2 layers", card, cpu)
    # one update (the train step's apply_update) on identical grads: the
    # CPU's, cast and clipped on each side
    cpu_grads = list(cpu[3])
    del card, cpu
    states = {}
    for name, p, d in (("card", card_params, dev), ("cpu", cpu_params, torch.device("cpu"))):
        spec = T.flatten(p)[1]
        g = T.unflatten(spec, [t.to(d) for t in cpu_grads])
        opt = adamw_init(p)
        before = [t.detach().clone() for t in T.leaves(p)]
        _, opt, upd = ST.apply_update(p, g, opt, 5, cfg2)
        states[name] = (upd["gnorm"], opt,
                        [a.detach() - b for a, b in zip(T.leaves(p), before)])
    gn_rel = abs(float(states["card"][0]) - float(states["cpu"][0])) / float(states["cpu"][0])
    upd = max(leaf_errors(states["card"][2], states["cpu"][2]))
    check(gn_rel <= F32_LOSS and upd <= F32_LEAF,
          f"train: AdamW on identical grads: gnorm {gn_rel}, an update {upd} (rule {F32_LEAF})")
    ref.update({"gnorm_rel": gn_rel, "adamw_update_rel_l2_max": upd,
                "layers": TRAIN_REFERENCE_LAYERS, "batch": B2, "seq": S2})
    out["reference"] = ref
    card_state = {"params": card_params, "opt": states["card"][1], "data": ds2.state()}
    del cpu_params, cpu_grads, states
    lap("reference")

    # c) every other family at its smoke config, one step, card against CPU
    families = {}
    for arch in TRAIN_FAMILIES:
        fcfg = get_config(arch).smoke().replace(dtype="float32")
        gen = torch.Generator()
        gen.manual_seed(0)
        fp_cpu = init_model(fcfg, gen, device="cpu")
        fp_card = tree_to(fp_cpu, dev)
        fb = family_batch(fcfg)
        row = hold_f32_rule(f"train {arch}", loss_and_grads(fp_card, fcfg, tree_to(fb, dev)),
                            loss_and_grads(fp_cpu, fcfg, fb))
        step_fn = ST.make_train_step(fcfg)
        mc = step_fn(fp_card, adamw_init(fp_card), tree_to(fb, dev), 5)[2]
        mp = step_fn(fp_cpu, adamw_init(fp_cpu), fb, 5)[2]
        check(abs(float(mc["loss"]) - float(mp["loss"])) <= F32_LOSS * abs(float(mp["loss"])),
              f"train {arch}: the step's loss {float(mc['loss'])} vs CPU {float(mp['loss'])}")
        row["step_loss"] = float(mc["loss"])
        if fcfg.family == "moe":
            check(row["aux"] > 0, f"train {arch}: MoE aux {row['aux']}")
        families[arch] = row
    out["families"] = families
    lap("families")

    # d) the crash drill through the CLI, twice; a checkpoint round trip
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    resumed = []
    for i in range(2):
        d = str(root / f"drill{i}")
        rc, lines, _ = run_train_cli(DRILL_ARGS + ["--ckpt-dir", d, "--fail-at-step", "7"])
        check(rc == 42 and any("SIMULATED FAILURE at step 7" in l for l in lines),
              f"train drill: the crash run exited {rc}: {lines[-2:]}")
        rc, lines, recs = run_train_cli(DRILL_ARGS + ["--ckpt-dir", d])
        text = "\n".join(lines)
        check(rc == 0 and "resumed from checkpoint step 6" in text
              and "done: 8 steps" in text, f"train drill: the resumed run: {lines}")
        resumed.append([r["loss"] for r in recs])
    check(resumed[0] == resumed[1], f"train drill: resumed losses differ: {resumed}")
    ck = AsyncCheckpointer(root / "state")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(1, card_state)
    t1 = time.perf_counter()
    ck.wait()
    t2 = time.perf_counter()
    loaded = load_checkpoint(root / "state", 1, card_state)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    a, b = T.leaves(card_state), T.leaves(loaded)
    same = len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else bool(np.array_equal(x, y))
        for x, y in zip(a, b))
    check(same, "train: the checkpoint round trip is not bitwise")
    out["checkpoint"] = {"drill_resumed_losses": resumed[0], "drills_bitwise": True,
                         "state_bytes": tree_bytes(card_state), "leaves": len(a),
                         "snapshot_ms": 1e3 * (t1 - t0), "write_s": t2 - t1,
                         "load_s": t3 - t2, "round_trip_bitwise": True}
    shutil.rmtree(root, ignore_errors=True)
    del card_state, loaded, a, b
    free_device()
    lap("checkpoint")
    launches = {k: c.launches for k, c in counters.items()}
    check(not any(launches.values()), f"train: the path launched kernels: {launches}")
    out["launches"] = launches
    out["seconds"] = laps
    return launches, out


# ------------------------------------------------------ the dry run

DRYRUN_ARCH = "tinyllama-1.1b"
ALLOC_BLOCK = 512              # the caching allocator's rounding of a block
PEAK_TOLERANCE = 0.05          # the reckoned peak against max_memory_allocated


def dryrun_card_cells():
    """The card's dry-run cells at full width and depth, sized to fit one
    card: the train CLI's default step (8 x 128), W8A8 decode of 8 rows over a
    2048-token contiguous cache, W8A8 prefill of 1 x 2048."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    cfg = get_config(DRYRUN_ARCH)
    w8a8 = cfg.replace(quantize="serve")
    return [("train", cfg, ShapeCfg("card_train_8x128", 128, 8, "train")),
            ("decode", w8a8, ShapeCfg("card_decode_8x2048", 2048, 8, "decode")),
            ("prefill", w8a8, ShapeCfg("card_prefill_1x2048", 2048, 1, "prefill"))]


def on_card(tree, vocab, gen, cache_index):
    """A meta tree of the dry run's arguments, allocated on the card leaf by
    leaf (``torch.empty``, so each allocation is the leaf's own bytes) and
    filled in place: float leaves N(0, 0.02^2), int8 codes uniform, f32
    scales in [1e-4, 1e-3], token ids below the vocab, the AdamW moments and
    step 0, a cache index at ``cache_index``."""
    import torch
    from repro_torch.core import tensorizer as tz

    def leaf(t, name):
        x = torch.empty(tuple(t.shape), dtype=t.dtype, device="cuda")
        if name == "index":
            return x.fill_(cache_index)
        if name in ("mu", "nu", "step"):
            return x.zero_()
        if t.dtype == torch.int8:
            return x.random_(-127, 128, generator=gen)
        if t.dtype in (torch.int32, torch.int64):
            return x.random_(0, vocab, generator=gen)
        if name == "scale":
            return x.uniform_(1e-4, 1e-3, generator=gen)
        return x.normal_(0.0, 0.02, generator=gen)

    def walk(t, name=""):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, k if name not in ("mu", "nu") else name) for k, v in t.items()}
        if isinstance(t, tz.QTensor):
            return tz.QTensor(walk(t.q, "q"), walk(t.scale, "scale"), t.meta_shape)
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(getattr(t, f), f) for f in t._fields))
        if isinstance(t, tuple):
            return tuple(walk(v, name) for v in t)
        return leaf(t, name)
    return walk(tree)


def leaf_tensors(tree):
    from repro_torch import tree as T
    from repro_torch.core import tensorizer as tz
    out = []
    for t in T.leaves(tree):
        out += [t.q, t.scale] if isinstance(t, tz.QTensor) else [t]
    return [t for t in out if hasattr(t, "untyped_storage")]


def cell_bound(flops_by_type, moved_bytes):
    """(least ms, "bytes" or "operations"): the int8 kernel FLOPs at the
    int8 peak, bf16 contractions at the bf16 peak, f32 ones at the f32 peak
    outside the tensor cores; the arguments read and outputs written once."""
    rates = {"int8": INT8_OPS_PER_S, "bfloat16": BF16_OPS_PER_S,
             "float32": F32_OPS_PER_S}
    t_ops = sum(f / rates[k] for k, f in flops_by_type.items())
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations")


def grid_fit(total_memory):
    """Each cell of the reference's production grid (every arch x shape,
    quantize off) on meta: its argument bytes on one device and whether they
    fit this card's memory."""
    import torch
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun as D
    from repro_torch.models import steps as ST
    rows = {}
    with shd.use_mesh(shd.Mesh((1,), ("data",), torch.device("meta"))):
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            params, pspecs = ST.param_sds(cfg)
            p_bytes = D.tree_bytes(params)
            o_bytes = D.tree_bytes(ST.opt_sds(cfg, params, pspecs)[0])
            for shape in SHAPES:
                if shape.name == "long_500k" and not cfg.sub_quadratic:
                    rows[f"{arch}/{shape.name}"] = {"skipped": D.LONG_SKIP}
                    continue
                n = p_bytes + D.tree_bytes(ST.batch_specs(cfg, shape)[0])
                if shape.kind == "train":
                    n += o_bytes
                if shape.kind == "decode":
                    n += D.tree_bytes(ST.cache_specs(cfg, shape)[0])
                rows[f"{arch}/{shape.name}"] = {"argument_bytes": n,
                                                "fits": n <= total_memory}
    return rows


def check_dryrun():
    """The pod-scale accounting on one card. The dry-run CLI at full width
    on meta (tinyllama-1.1b, every shape, quantize off and serve); then
    three cells built on the card from the dry run's own meta arguments and
    run once under the accounting context: contraction FLOPs equal to the
    meta count, qgemm's records equal to its launches, argument bytes equal
    to the allocator's requested bytes, the reckoned peak within 5% of
    max_memory_allocated; each cell's wall and device time beside its bound.
    Then every production cell's argument bytes against this card's memory."""
    import contextlib
    import io
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.accounting import Accounting
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun as D
    out = {}
    laps, lap = lap_clock()
    cli = {}
    for quantize in ("off", "serve"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = D.main(["--arch", DRYRUN_ARCH, "--shape", "all", "--quantize", quantize,
                         "--out", str(ROOT / "build" / "dryrun_torch")])
        check(rc == 0, f"dryrun CLI (quantize {quantize}) exited {rc}: {buf.getvalue()}")
        cli[quantize] = buf.getvalue().splitlines()
        for line in cli[quantize]:
            print(line, flush=True)
    out["cli"] = cli
    lap("cli")
    counters = all_counters()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    launches = {k: 0 for k in counters}
    cells = {}
    for name, cfg, shape in dryrun_card_cells():
        with shd.use_mesh(shd.Mesh((1,), ("data",), torch.device("meta"))):
            meta = D.count_step(cfg, shape)
            fn, args, _ = D.build_cell(cfg, shape)
        free_device()
        torch.cuda.synchronize()
        stats0 = torch.cuda.memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        card_args = on_card(args, cfg.vocab, gen, shape.seq_len - 1)
        torch.cuda.synchronize()
        requested = (torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
                     - stats0["requested_bytes.all.current"])
        allocated = torch.cuda.memory_allocated(dev) - base
        leaves = leaf_tensors(card_args)
        rounded = sum(-(-t.untyped_storage().nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
                      for t in {id(t.untyped_storage()): t for t in leaves}.values())
        arg_bytes = meta["memory"]["argument_size_in_bytes"]
        check(requested == arg_bytes,
              f"dryrun {name}: the card's requested argument bytes {requested} != the "
              f"meta count {arg_bytes}")
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters.values():
            c.launches = 0
        with shd.use_mesh(shd.Mesh((1,), ("data",), dev)):
            with Accounting() as acc:
                res = fn(*card_args)
            torch.cuda.synchronize()
        counted = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev) - base
        q_records = meta["kernels"].get("qgemm", {}).get("calls", 0)
        check(acc.flops == meta["flops"],
              f"dryrun {name}: card FLOPs {acc.flops} != meta FLOPs {meta['flops']}")
        check(counted["qgemm"] == q_records == acc.kernel_calls("qgemm"),
              f"dryrun {name}: qgemm launched {counted['qgemm']} times, meta recorded "
              f"{q_records}")
        check(all(v == 0 for k, v in counted.items() if k != "qgemm"),
              f"dryrun {name}: another kernel launched: {counted}")
        reckoned = meta["memory"]["peak_bytes"]
        rel = abs(reckoned - peak) / peak
        check(rel <= PEAK_TOLERANCE,
              f"dryrun {name}: reckoned peak {reckoned} vs measured {peak} ({rel:.3%})")
        finite = all(bool(torch.isfinite(t.float()).all()) for t in leaf_tensors(res)
                     if t.is_floating_point())
        check(finite, f"dryrun {name}: non-finite outputs")
        del res
        # timed without the accounting context: wall and device busy time
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn(*card_args)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        busy_ms, top = device_time(prof, 1, 5)
        for k, c in counters.items():
            launches[k] += counted[k] + c.launches
        by_type = {k: v for k, v in acc.flops_by_dtype.items()}
        for k, rec in acc.kernels.items():
            by_type["int8"] = by_type.get("int8", 0) + rec["flops"]
        moved = arg_bytes + meta["memory"]["output_size_in_bytes"]
        bound_ms, bound_by = cell_bound(by_type, moved)
        cells[name] = {
            "shape": [shape.global_batch, shape.seq_len], "quantize": cfg.quantize,
            "flops_card": acc.flops, "flops_meta": meta["flops"], "flops_equal": True,
            "flops_by_type": by_type, "kernels": acc.kernels,
            "qgemm_launches": counted["qgemm"], "qgemm_records_meta": q_records,
            "bytes_accessed_meta": meta["bytes_accessed"],
            "bytes_accessed_card": acc.bytes_accessed,
            "argument_bytes": arg_bytes, "requested_delta": requested,
            "allocated_delta": allocated, "allocated_rounded_sum": rounded,
            "peak_reckoned": reckoned, "peak_measured": peak, "peak_rel_diff": rel,
            "peak_tracked_on_card": arg_bytes + acc.peak_bytes,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms, "top_kernels_ms": top,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "eager_bytes_ms": 1e3 * meta["bytes_accessed"] / HBM_BYTES_PER_S,
            "wall_over_bound": wall_ms / bound_ms}
        del res, card_args, leaves, fn, args
        free_device()
        lap(name)
    out["cells"] = cells
    total = torch.cuda.get_device_properties(dev).total_memory
    out["grid_fit"] = {"total_memory": total, "cells": grid_fit(total)}
    lap("grid_fit")
    out["launches"] = launches
    out["seconds"] = laps
    return launches, out


DISTGEMM_N = 16384
EXACT_K = 1024                 # K * 127^2 < 2^24: the f32 of each int32 sum is exact


def check_distgemm(dev):
    """``core.distributed_gemm`` at 16384^3 on the card, quantized (one
    qgemm launch) and float (``a @ b``). The quantized result's int32
    accumulation is ``torch._int_mm``'s on the same int8 operands: the
    whole-K f32 of qgemm's sums bitwise the cast of _int_mm's, the result
    bitwise the reference's dequant of _int_mm's sums, and at K = 1024 (where
    the f32 of every sum is exact) qgemm's sums bitwise _int_mm's int32.
    Then qgemm at 16384^3 timed with CUDA graphs beside _int_mm's and its
    bound."""
    import torch
    from repro_torch.core import distributed_gemm as DG
    from repro_torch.core import tensorizer as tz
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import qgemm as tq
    from repro_torch.launch.mesh import make_smoke_mesh
    n = DISTGEMM_N
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    a = torch.randn((n, n), generator=gen, device=dev)
    b = torch.randn((n, n), generator=gen, device=dev) * 0.1
    counters = all_counters()
    for c in counters.values():
        c.launches = 0
    with shd.use_mesh(make_smoke_mesh(1, dev)):
        quant = DG.distributed_gemm(a, b, quantized=True)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        flt = DG.distributed_gemm(a, b, quantized=False)
    check(launches["qgemm"] == 1 and sum(launches.values()) == 1,
          f"distgemm: launches {launches}")
    qa, qb = tz.quantize(a), tz.quantize(b, axis=(0,))
    ones = torch.ones(n, device=dev)
    acc_i = torch._int_mm(qa.q, qb.q)
    acc_k = tq.qgemm(qa.q, qb.q, ones)
    whole = bool(torch.equal(acc_k, acc_i.to(torch.float32)))
    check(whole, "distgemm: qgemm's f32 sums differ from torch._int_mm's cast")
    ref = acc_i.to(torch.float32) * qa.scale * qb.scale.reshape(-1)
    check(torch.equal(quant, ref), "distgemm: the quantized result is not the "
          "reference's dequant of torch._int_mm's sums")
    a_k, b_k = qa.q[:, :EXACT_K].contiguous(), qb.q[:EXACT_K].contiguous()
    exact_i = torch._int_mm(a_k, b_k)
    exact_k = tq.qgemm(a_k, b_k, ones)
    exact = bool(torch.equal(exact_k.to(torch.int32), exact_i)
                 and exact_i.abs().max().item() < 2 ** 24)
    check(exact, "distgemm: qgemm's int32 sums differ from torch._int_mm's at K = 1024")
    quant_err = ((quant - flt).abs().max() / flt.abs().max()).item()
    finite = bool(torch.isfinite(quant).all() and torch.isfinite(flt).all())
    check(finite, "distgemm: non-finite results")
    del quant, flt, ref, acc_i, acc_k, exact_i, exact_k
    graph_k = graph_ms(lambda: tq.qgemm(qa.q, qb.q, ones), 3)
    graph_lib = graph_ms(lambda: torch._int_mm(qa.q, qb.q), 3)
    eager_k = time_ms(lambda: tq.qgemm(qa.q, qb.q, ones), 3)
    plain_ms = time_ms(lambda: tq.qgemm_plain(qa.q, qb.q, ones), 1)
    bound_ms, bound_by = qgemm_bound(n, n, n, out_bytes=4)
    del a, b, qa, qb
    free_device()
    for c in counters.values():
        c.launches = 0
    return launches, {
        "shape": [n, n, n], "launches": launches, "whole_k_f32_bitwise_int_mm": whole,
        "dequant_bitwise": True, "k1024_int32_bitwise_int_mm": exact,
        "w8a8_rel_max_err_vs_float": quant_err,
        "qgemm_graph_ms": graph_k, "qgemm_eager_ms": eager_k, "plain_ms": plain_ms,
        "int_mm_graph_ms": graph_lib, "qgemm_over_int_mm": graph_k / graph_lib,
        "bound_ms": bound_ms, "bound_by": bound_by, "qgemm_over_bound": graph_k / bound_ms,
        "plan": plan_of(tq, n, n, n, sms_of(dev))}


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
        moe_launches, moe = check_moe()
        phase("moe", card=card, **moe)
        dense_launches, dense = check_dense_configs()
        phase("dense_configs", card=card, **dense)
        hybrid_launches, hybrid = check_hybrid()
        phase("hybrid", card=card, **hybrid)
        xlstm_launches, xlstm = check_xlstm()
        phase("xlstm", card=card, **xlstm)
        vlm_launches, vlm = check_vlm()
        phase("vlm", card=card, **vlm)
        encdec_launches, encdec = check_encdec()
        phase("encdec", card=card, **encdec)
        train_launches, train = check_train()
        phase("train", card=card, **train)
        dryrun_launches, dryrun = check_dryrun()
        phase("dryrun", card=card, **dryrun)
        distgemm_launches, distgemm = check_distgemm(dev)
        phase("distgemm", card=card, **distgemm)
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
               "gptpu": gptpu["launches"], "ops": ops_launches,
               "moe": moe_launches, "dense_configs": dense_launches,
               "hybrid": hybrid_launches, "xlstm": xlstm_launches, "vlm": vlm_launches,
               "encdec": encdec_launches, "train": train_launches,
               "dryrun": dryrun_launches, "distgemm": distgemm_launches}
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
