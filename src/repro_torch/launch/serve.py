"""Serving CLI for the port: the single-host driver over the
continuous-batching engine with the Tensorizer W8A8 path.

    python -m repro_torch.launch.serve --arch tinyllama-1.1b --quantize serve \\
        --cache-backend paged --paged-native --paged-kernel \\
        --requests 8 --prompt-len 128 --gen 32 --slots 8 --stagger-steps 2

Runs on the CUDA card by default; ``--device cpu`` runs the kernels' plain
versions (use ``--smoke`` there: full width is 1.1B parameters). Weights are
random, drawn from a ``torch.Generator`` seeded with ``--seed``. The report
lines are those of ``repro.launch.serve``'s single-host branch.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import tensorizer as tz
from repro_torch.models import init_model
from repro_torch.models.model import count_qtensors
from repro_torch.serving.engine import Engine, EngineConfig, Request
from repro_torch.serving.metrics import format_memory_stats


def quant_predicate(path, leaf) -> bool:
    """Quantize projection weights only (names starting with "w", plus
    lm_head); norms and the embedding table stay float."""
    name = path[-1] if path else ""
    return name == "lm_head" or name.startswith("w")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
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
                    help="SlotStore backend; the port serves 'paged'")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged backend: tokens per KV block")
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="paged backend: pool size in blocks (0 = full capacity)")
    ap.add_argument("--paged-native", action="store_true",
                    help="block-native decode over the pool (required by the port)")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="with --paged-native: the paged-attention kernel "
                         "(required by the port)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weight generator and the prompts")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for tests)")
    return ap


def run(argv=None) -> Tuple[List[Request], Dict]:
    """Parse ``argv``, build the model and engine, serve the synthetic
    traffic, print the report, and return ``(requests, engine stats)``."""
    ap = build_parser()
    args = ap.parse_args(argv)
    for name in ("requests", "prompt_len", "gen", "slots", "max_queue"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1")
    if (args.paged_native or args.paged_kernel) and args.cache_backend != "paged":
        ap.error("--paged-native/--paged-kernel require --cache-backend paged")
    if args.paged_kernel and not args.paged_native:
        ap.error("--paged-kernel requires --paged-native")
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = cfg.replace(quantize=args.quantize)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_model(cfg, gen, device=device)
    if args.quantize == "serve":
        params = tz.quantize_params(params, predicate=quant_predicate)
        print(f"[serve] Tensorizer W8A8: {count_qtensors(params)} weight "
              f"tensors quantized", flush=True)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len),
                           dtype=np.int32)
    ecfg = EngineConfig(
        max_slots=args.slots, max_queue=args.max_queue,
        max_seq_len=args.prompt_len + args.gen,
        cache_backend=args.cache_backend, block_size=args.block_size,
        n_blocks=args.n_blocks or None,
        paged_native=args.paged_native, paged_kernel=args.paged_kernel)
    engine = Engine(cfg, params, ecfg, device=device)
    try:
        requests = []
        for i in range(args.requests):
            requests.append(engine.submit(prompts[i], args.gen, strict=True))
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
