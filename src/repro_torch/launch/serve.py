"""Serving CLI for the port: the single-host driver over the
continuous-batching engine with the Tensorizer W8A8 path.

    python -m repro_torch.launch.serve --arch tinyllama-1.1b --quantize serve \\
        --cache-backend paged --paged-native --paged-kernel \\
        --requests 8 --prompt-len 128 --gen 32 --slots 8 --stagger-steps 2

``--arch`` takes every ported config (repro_torch.configs.ARCH_IDS): the
dense tinyllama-1.1b, qwen3-14b (qk_norm), starcoder2-15b (LayerNorm,
GeLU) and granite-20b (MQA), the MoE deepseek-moe-16b and
moonshot-v1-16b-a3b, and the recurrent zamba2-7b (hybrid: Mamba2 layers
and a shared attention block) and xlstm-125m (ssm: mLSTM/sLSTM pairs),
which serve on ``--cache-backend recurrent`` (what ``auto`` picks for them)
and can be the ``--draft-config`` of a dense or MoE target.
seamless-m4t-medium (encdec) and qwen2-vl-2b (vlm) read precomputed
embeddings and are refused, with the reference's message.

``--cache-backend contiguous`` leases per-slot rows sized to the sequence
budget; ``recurrent`` per-slot state rows (the hybrid's conv and ssm states
beside its shared attention's K/V, the xlstm's mLSTM and sLSTM states),
admitted by a masked replay of the
decode body; ``paged`` leases blocks from a pool, decoded through the gather
bridge, or block-natively with ``--paged-native`` (plain torch) and
``--paged-kernel`` (the paged-attention kernel). ``--prefill-chunk W``
admits buckets wider than W by the chunked scan; ``--prefix-cache`` (paged)
keeps the shared-prefix radix cache, and every request then opens with the
same half-prompt preamble, a shared system prompt.

``--temperature T`` (with ``--top-k``, ``--top-p``) samples the
even-indexed requests with seed ``--seed + i`` while the odd ones stay
greedy; ``--stop IDS`` (repeatable) applies to every request.
``--speculative`` decodes by draft-verify rounds: a draft model
(``--draft-config``) proposes ``--spec-k`` tokens per slot and the target
verifies the window in one forward.

``--hosts N`` (N > 1) serves the same traffic through the multi-host Router
over N in-process engines (request i carries session ``i % N``);
``--host-procs`` runs each host as a worker process instead
(``serving/host_main.py``, weights rebuilt from the same seed);
``--drain-at K`` drains host 0 after K fleet steps; ``--disaggregate
prefill:N,decode:M`` splits the fleet into prefill and decode roles, the
decode hosts adopting shipped KV blocks. ``--api-port P`` serves the engine
(or the fleet) over HTTP on port P instead of the synthetic traffic (0: a
port the OS picks) until SIGINT or SIGTERM.

Runs on the CUDA card by default; ``--device cpu`` runs the kernels' plain
versions (use ``--smoke`` there: full width is 1.1B parameters and more).
With ``--quantize serve`` the weights are built layer by layer, each layer
quantized before the next is drawn (models/model.py
``init_model_quantized``). Weights are random, drawn from a ``torch.Generator`` seeded with ``--seed`` (the
draft's too, so a draft of the target's config is the target); the prompts
come from a numpy generator seeded the same way. The report lines are those
of ``repro.launch.serve``'s single-host branch.
"""

from __future__ import annotations

import argparse
import signal
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.model import count_qtensors
from repro_torch.serving.api import serve_api
from repro_torch.serving.engine import SERVED_FAMILIES, Engine, EngineConfig, Request
from repro_torch.serving.metrics import (
    format_memory_stats, format_router_stats, format_sampling_stats,
    format_spec_stats, format_transport_stats,
)
from repro_torch.serving.router import Router, RouterConfig, parse_disaggregate
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.transport import (
    SubprocessTransport, build_model_spec, realize_model_spec,
)


# leaves named like projections that stay float, as in the JAX package:
# depthwise conv taps, the sLSTM block's FFN beside its recurrence, and the
# sLSTM recurrence weights
QUANT_SKIP = frozenset({"conv_w", "wup", "wdown", "rz", "ri", "rf", "ro"})


def quant_predicate(path, leaf) -> bool:
    """Quantize projection weights only (names starting with "w", plus
    lm_head, less ``QUANT_SKIP``); norms, the router, the embedding table
    and the recurrence weights stay float."""
    name = path[-1] if path else ""
    return (name == "lm_head" or name.startswith("w")) and name not in QUANT_SKIP


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="a ported config (repro_torch.configs.ARCH_IDS)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced CPU-test widths (not the served model)")
    ap.add_argument("--quantize", default="off", choices=["off", "serve"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4,
                    help="in-flight decode batch width (engine slots)")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--stagger-steps", type=int, default=0,
                    help="engine steps between request arrivals (0 = all at once)")
    ap.add_argument("--cache-backend", default="auto",
                    choices=["auto", "contiguous", "paged", "recurrent"],
                    help="SlotStore backend (auto: contiguous for dense/moe, "
                         "recurrent for ssm/hybrid)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged backend: tokens per KV block")
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="paged backend: pool size in blocks (0 = full capacity)")
    ap.add_argument("--paged-native", action="store_true",
                    help="paged backend: block-native decode over the pool "
                         "(no gather-bridge view)")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="with --paged-native: attend through the paged-attention "
                         "kernel (float KV)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill width W: buckets wider than W admit "
                         "through W-token chunks (0 = single-shot only)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged backend: shared-prefix radix cache; the "
                         "synthetic prompts share a half-prompt preamble")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-verify decode: the draft proposes --spec-k tokens "
                         "per slot each round, the target verifies the window in "
                         "one forward; tokens bitwise those of plain greedy decode")
    ap.add_argument("--draft-config", default="tinyllama-1.1b",
                    help="with --speculative: the draft's arch (the target's vocab; "
                         "smoke-reduced under --smoke)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="with --speculative: draft proposals per round "
                         "(verify window = spec-k + 1)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature of the even-indexed requests (seed "
                         "--seed + i); odd ones stay greedy (0 = all greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sampled requests: keep the k highest logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="sampled requests: nucleus filtering (1.0 = off)")
    ap.add_argument("--stop", action="append", metavar="IDS",
                    help="stop sequence as comma-separated token ids (repeatable; "
                         "every request)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weight generator and the prompts, and the "
                         "base sampling seed (request i samples with seed + i)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="1 = a single engine; > 1 serves through the multi-host "
                         "Router (one engine per host, cache-affinity placement "
                         "and load-aware spill)")
    ap.add_argument("--host-procs", action="store_true",
                    help="run each host as its own worker process (framed RPC over "
                         "a local socket) instead of an in-process engine")
    ap.add_argument("--drain-at", type=int, default=0,
                    help="with --hosts > 1: drain host 0 after this many fleet "
                         "steps (0 = never)")
    ap.add_argument("--disaggregate", default="",
                    help="with --hosts > 1: 'prefill:N,decode:M' (or 'N:M') role "
                         "split; admissions go to prefill hosts and streams ship "
                         "their KV blocks to decode hosts (requires --cache-backend "
                         "paged --paged-native)")
    ap.add_argument("--api-port", type=int, default=-1,
                    help="serve the streaming HTTP API on this port instead of the "
                         "synthetic traffic (0 = a port the OS picks, -1 = off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for tests)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the model axis of the smoke mesh (launch/mesh.py): one card "
                         "has none, so the mesh is the 1-wide data mesh")
    return ap


def sampling_for(args, i: int):
    """Request i's sampling params in the synthetic traffic: with
    --temperature > 0 the EVEN-indexed requests sample (seed --seed + i) and
    the odd ones stay greedy, so decode batches mix both; --stop applies to
    all."""
    stops = tuple(tuple(int(t) for t in s.split(",")) for s in (args.stop or []))
    if args.temperature > 0 and i % 2 == 0:
        return SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, seed=args.seed + i, stop=stops)
    if stops:
        return SamplingParams(stop=stops)
    return None


def build_model(arch: str, args, device):
    """The weights of ``arch`` from a generator seeded with --seed, W8A8 with
    --quantize serve: ``(cfg, params)``, through the model spec a worker
    process rebuilds them from (serving/transport.py)."""
    return realize_model_spec(build_model_spec(
        arch, smoke=args.smoke, quantize=args.quantize, seed=args.seed,
        model_parallel=args.model_parallel, device=device))[:2]


def _roles_for(args):
    """--disaggregate -> the per-host role tuple (None when off)."""
    return parse_disaggregate(args.disaggregate, args.hosts) if args.disaggregate else None


def _spawn_fleet(args, ecfg, device) -> List[SubprocessTransport]:
    """--host-procs: one worker process per host, each rebuilding the
    weights from the same spec. A boot failure reaps the partial fleet."""
    spec = build_model_spec(args.arch, smoke=args.smoke, quantize=args.quantize,
                            seed=args.seed,
                            draft_arch=args.draft_config if args.speculative else None,
                            model_parallel=args.model_parallel, device=device)
    fleet = []
    try:
        for _ in range(args.hosts):
            fleet.append(SubprocessTransport(spec, ecfg))
    except Exception:
        for t in fleet:
            t.close()
        raise
    print(f"[serve] spawned {len(fleet)} host processes "
          f"(pids {[t.pid for t in fleet]})", flush=True)
    return fleet


def _serve_fleet(router: Router, prompts, args) -> Tuple[List, Dict]:
    """The --hosts > 1 path: the synthetic traffic through the Router.
    Requests cycle over ``--hosts`` session keys, so the second lap of
    arrivals pins to the hosts holding those sessions (affinity hits);
    ``--drain-at K`` drains host 0 after K fleet steps."""
    requests = []
    fleet_steps = 0

    def tick(n):
        nonlocal fleet_steps
        for _ in range(n):
            router.step()
            fleet_steps += 1
            if args.drain_at and fleet_steps == args.drain_at:
                router.drain(0)
                print(f"[serve] draining host 0 at fleet step {fleet_steps}", flush=True)

    for i in range(args.requests):
        requests.append(router.submit(prompts[i], args.gen, session=str(i % args.hosts),
                                      sampling=sampling_for(args, i), strict=True))
        tick(args.stagger_steps)
    while router.has_work():
        tick(1)

    for r in requests:
        trail = "->".join(str(h) for h in r.hosts)
        handed = " (handoff)" if len(r.hosts) > 1 else ""
        print(f"[serve] req {r.id}: prompt {len(r.prompt)} tok | host {trail}{handed} | "
              f"{r.n_generated} tok", flush=True)
    s = router.stats()
    print(f"[serve] router: {format_router_stats(s)}", flush=True)
    if any(t["kind"] != "in-process" for t in s["router"]["transport"]):
        print(f"[serve] {format_transport_stats(s)}", flush=True)
    if args.temperature > 0 or args.stop:
        print(f"[serve] fleet {format_sampling_stats(s['fleet'])}", flush=True)
    if args.speculative:
        f = s["fleet"]
        rate = f["accepted_tokens"] / max(f["proposed_tokens"], 1)
        print(f"[serve] fleet speculative: {f['spec_rounds']} rounds + "
              f"{f['draft_steps']} draft steps | {f['accepted_tokens']}/"
              f"{f['proposed_tokens']} proposals accepted ({rate:.2f})", flush=True)
    for h, hs in enumerate(s["per_host"]):
        o = hs.get("opq", {})
        drained = " [drained]" if router.is_drained(h) else ""
        print(f"[serve] host {h}{drained}: {hs['completed']} done | "
              f"{hs['decode_steps']} decode steps | "
              f"{hs['preempted']} preempted, {hs['evicted']} evicted | "
              f"cache {format_memory_stats(hs['cache'])} | "
              f"opq {o.get('issued', 0)} instr, {o.get('affinity_hits', 0)} affinity hits",
              flush=True)
    print(f"[serve] sample generation (req 0): {requests[0].tokens}", flush=True)
    return requests, s


def _serve_http(target, args, front: str) -> None:
    """--api-port: the HTTP API over ``target`` until SIGINT or SIGTERM;
    closing flushes a terminal frame to every live stream."""
    srv = serve_api(target, port=args.api_port)
    print(f"[serve] HTTP API on {srv.url} ({front}): POST /v1/completions (SSE with "
          f"\"stream\": true), /v1/embeddings, /v1/classify; GET /v1/stats /healthz",
          flush=True)

    def _graceful(signum, frame):
        raise KeyboardInterrupt
    signal.signal(signal.SIGTERM, _graceful)
    srv.wait()
    print("[serve] shutdown: streams flushed, closing the backend", flush=True)


def run(argv=None) -> Tuple[List[Request], Dict]:
    """Parse ``argv``, build the model and engine, serve the synthetic
    traffic, print the report, and return ``(requests, engine stats)``."""
    ap = build_parser()
    args = ap.parse_args(argv)
    for name in ("requests", "prompt_len", "gen", "slots", "max_queue", "model_parallel"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1")
    if (args.paged_native or args.paged_kernel) and args.cache_backend != "paged":
        ap.error("--paged-native/--paged-kernel require --cache-backend paged")
    if args.paged_kernel and not args.paged_native:
        ap.error("--paged-kernel requires --paged-native")
    if args.prefix_cache and args.cache_backend != "paged":
        ap.error("--prefix-cache requires --cache-backend paged")
    if args.hosts < 1:
        ap.error("--hosts must be >= 1")
    if args.drain_at and args.hosts < 2:
        ap.error("--drain-at needs --hosts >= 2 (a handoff needs another host)")
    if args.disaggregate:
        if args.hosts < 2:
            ap.error("--disaggregate needs --hosts >= 2 (a prefill host and a "
                     "decode host)")
        if args.cache_backend != "paged" or not args.paged_native:
            ap.error("--disaggregate requires --cache-backend paged --paged-native "
                     "(block shipping exports and imports pool blocks)")
        if args.speculative:
            ap.error("--disaggregate does not support --speculative (the draft's "
                     "KV does not ship)")
        try:
            parse_disaggregate(args.disaggregate, args.hosts)
        except ValueError as e:
            ap.error(str(e))
    if args.spec_k < 1:
        ap.error("--spec-k must be >= 1")
    if args.speculative and args.paged_kernel:
        ap.error("--speculative does not support --paged-kernel (the kernel is a "
                 "one-query decode shape)")
    if args.temperature < 0:
        ap.error("--temperature must be >= 0 (0 = greedy)")
    if not 0.0 < args.top_p <= 1.0:
        ap.error("--top-p must be in (0, 1]")
    if args.top_k < 0:
        ap.error("--top-k must be >= 0 (0 = off)")
    if args.temperature > 0 and args.speculative:
        ap.error("--speculative is greedy-only: drop --speculative or --temperature")
    for stop in args.stop or []:
        if not all(t.strip().lstrip("-").isdigit() for t in stop.split(",")):
            ap.error(f"--stop takes comma-separated token ids, got {stop!r}")
    for arch in [args.arch] + ([args.draft_config] if args.speculative else []):
        try:
            get_config(arch)
        except ValueError as e:
            ap.error(str(e))
    arch_cfg = get_config(args.arch)
    family = arch_cfg.family
    if args.speculative and family not in ("dense", "moe"):
        ap.error(f"--speculative needs a dense-family TARGET arch, got {args.arch} "
                 f"(family={family}); recurrent models can be the draft, not the target")
    if family not in SERVED_FAMILIES or arch_cfg.input_mode != "tokens":
        ap.error(f"--arch {args.arch} (family={family}, input_mode="
                 f"{arch_cfg.input_mode}) is not servable yet: the engine handles "
                 "token-input dense/moe (contiguous or paged KV) and ssm/hybrid "
                 "(recurrent-state) archs; encdec/vlm serving is a ROADMAP item")
    device = resolve_device(args.device)
    with shd.use_mesh(make_smoke_mesh(args.model_parallel, device)):
        return _run(args, device)


def _run(args, device) -> Tuple[List[Request], Dict]:
    """``run``'s model, engine (or fleet) and traffic, under the mesh of
    ``--model-parallel`` (one card: the 1-wide data mesh)."""
    cfg, params = build_model(args.arch, args, device)
    if args.quantize == "serve":
        print(f"[serve] Tensorizer W8A8: {count_qtensors(params)} weight "
              f"tensors quantized", flush=True)
    draft_cfg = draft_params = None
    if args.speculative:
        # the draft's weights come from the same seed: with --draft-config
        # equal to --arch the draft IS the target and acceptance is total
        draft_cfg, draft_params = build_model(args.draft_config, args, device)
        print(f"[serve] speculative: draft {args.draft_config}, k={args.spec_k} "
              f"(verify window {args.spec_k + 1})", flush=True)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len),
                           dtype=np.int32)
    if args.prefix_cache:
        # hot-prefix traffic: every request opens with the same half-prompt
        # preamble, so all but the first admission walk onto cached blocks
        prompts[:, :args.prompt_len // 2] = prompts[0, :args.prompt_len // 2]
    ecfg = EngineConfig(
        max_slots=args.slots, max_queue=args.max_queue,
        max_seq_len=args.prompt_len + args.gen,
        cache_backend=args.cache_backend, block_size=args.block_size,
        n_blocks=args.n_blocks or None,
        paged_native=args.paged_native, paged_kernel=args.paged_kernel,
        prefill_chunk=args.prefill_chunk or None, prefix_cache=args.prefix_cache,
        speculative=args.speculative, spec_k=args.spec_k, draft=draft_cfg)
    transports = _spawn_fleet(args, ecfg, device) if args.host_procs else None
    if args.api_port >= 0 or args.hosts > 1 or transports is not None:
        fleet = args.hosts > 1 or transports is not None
        if fleet:
            target = Router(cfg, params, ecfg,
                            RouterConfig(n_hosts=args.hosts, roles=_roles_for(args)),
                            draft_params=draft_params, transports=transports,
                            device=device)
        else:
            target = Engine(cfg, params, ecfg, device=device, draft_params=draft_params)
        try:
            if args.api_port < 0:
                return _serve_fleet(target, prompts, args)
            front = (f"router, {args.hosts} host "
                     f"{'processes' if transports else 'engines'}" if fleet
                     else "single engine")
            _serve_http(target, args, front)
            return [], target.stats()
        finally:
            target.close()

    engine = Engine(cfg, params, ecfg, device=device, draft_params=draft_params)
    try:
        requests = []
        for i in range(args.requests):
            requests.append(engine.submit(prompts[i], args.gen,
                                          sampling=sampling_for(args, i), strict=True))
            for _ in range(args.stagger_steps):
                engine.step()
        engine.run_until_complete()
    finally:
        engine.close()

    for r in requests:
        print(f"[serve] req {r.id}: prompt {r.metrics.prompt_len} tok | "
              f"TTFT {r.metrics.ttft_s*1e3:.1f} ms "
              f"(queue {r.metrics.queue_wait_s*1e3:.1f} + "
              f"prefill+seed {r.metrics.prefill_s*1e3:.1f}) | "
              f"{r.metrics.n_generated} tok @ {r.metrics.decode_tok_s:.1f} tok/s",
              flush=True)
    s = engine.stats()
    print(f"[serve] engine: {s['completed']} requests | "
          f"{s['prefill_batches']} prefill batches | "
          f"{s['decode_steps']} decode steps | "
          f"sustained {s['sustained_tok_s']:.1f} tok/s | "
          f"mean queue depth {s['mean_queue_depth']:.2f} | "
          f"mean occupancy {s['mean_occupancy']:.2f}/{args.slots}", flush=True)
    print(f"[serve] admission: fused prefill-with-cache | "
          f"prefill wait {s['prefill_wait_s']*1e3:.1f} ms | "
          f"batched seed writes {s['seed_write_s']*1e3:.1f} ms | "
          f"0 replay decodes | "
          f"{s['admissions_deferred']} deferred (backpressure)", flush=True)
    if args.speculative:
        print(f"[serve] {format_spec_stats(s)}", flush=True)
    if args.temperature > 0 or args.stop:
        print(f"[serve] {format_sampling_stats(s)}", flush=True)
    if args.prefix_cache:
        print(f"[serve] prefix cache: {s['prefix_hits']} hits | "
              f"{s['prefix_blocks_reused']} blocks reused | "
              f"{s['prefix_tokens_reused']} prompt positions skipped | "
              f"{s['prefill_chunks']} prefill chunks computed", flush=True)
    print(f"[serve] cache: {format_memory_stats(s['cache'])}", flush=True)
    o = s["opq"]
    print(f"[serve] opq: {o['issued']} instructions | "
          f"{o['affinity_hits']} affinity hits | "
          f"{o['backups_issued']} backups", flush=True)
    print(f"[serve] sample generation (req 0): {requests[0].tokens}", flush=True)
    return requests, s


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
