#!/usr/bin/env python3
"""What a serving admission (one fused prefill batch) costs on each store
route of the PyTorch port: its wall time and the device memory it
allocates above what the engine held before it.

    python3 scripts/torch_prefill_cost.py [--src DIR] [--label NAME] [--reps N]

``--src DIR`` imports ``repro_torch`` from ``DIR/src`` instead of this
checkout's, so two versions (e.g. the parent commit unpacked by
``git archive`` into a directory that .gitignore lists) can be measured by
the same code in turns on one card. Needs a CUDA card.

Model: tinyllama-1.1b at full width, W8A8 (``--quantize serve``), random
weights from the serve CLI's seeded generator (seed 0). Cases:

  * ``serve``: the serve traffic's batch, 8 prompts of 128 tokens in one
    fused admission, max_seq_len 160, block size 16, on the contiguous
    store, the gather bridge, block-native plain and block-native through
    the paged-attention kernel, with bf16 and with int8 KV;
  * ``long``: 2 prompts of 1536 and 1900 tokens (tinyllama's 2048-token
    context) in one fused admission, on the contiguous store and through
    the kernel.

Each case admits its batch ``--reps`` times on one engine (each request
takes 2 tokens: the admission's and one decode step's, then retires). Per
case one JSON line: the median and every admission's wall ms (synchronised
before and after ``Engine._admit``) and the peak of allocated device memory
during the admission above what was allocated before it. Last, the card's
line (nvidia-smi name and power limit).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUTES = {
    "contiguous": {"cache_backend": "contiguous"},
    "bridge": {"cache_backend": "paged"},
    "native_plain": {"cache_backend": "paged", "paged_native": True},
    "native_kernel": {"cache_backend": "paged", "paged_native": True, "paged_kernel": True},
}
CASES = ([("serve", route, kv, 160, (128,) * 8)
          for kv in ("bfloat16", "int8") for route in ROUTES]
         + [("long", route, "bfloat16", 2048, (1536, 1900))
            for route in ("contiguous", "native_kernel")])


def admit_cost(cfg, params, route, max_seq_len, lengths, reps, seed):
    """``reps`` fused admissions of prompts of ``lengths`` tokens on one
    engine of ``route``: each admission's wall ms and its peak device bytes
    above the bytes allocated before it."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import Engine, EngineConfig
    rng = np.random.default_rng(seed)
    engine = Engine(cfg, params, EngineConfig(
        max_slots=len(lengths), max_seq_len=max_seq_len, block_size=16, **ROUTES[route]),
        device="cuda")
    ms, peak = [], []
    try:
        for _ in range(reps):
            for n in lengths:
                engine.submit(rng.integers(0, cfg.vocab, (n,), dtype=np.int32), 2, strict=True)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            engine._admit()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            peak.append(torch.cuda.max_memory_allocated() - before)
            engine.run_until_complete()
    finally:
        engine.close()
    return ms, peak


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT), help="checkout whose src/ is imported")
    ap.add_argument("--label", default="this", help="tag of every output line")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    src = Path(args.src).resolve() / "src"
    if not (src / "repro_torch").is_dir():
        print(f"[torch_prefill_cost] {src}/repro_torch not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("[torch_prefill_cost] no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core import tensorizer as tz
    from repro_torch.launch.serve import quant_predicate
    from repro_torch.models import init_model
    base = get_config("tinyllama-1.1b").replace(quantize="serve")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tz.quantize_params(init_model(base, gen, device="cuda"), predicate=quant_predicate)
    # one warm admission: the first call of each kernel and library pays set-up
    admit_cost(base, params, "native_kernel", 160, (128,), 1, seed=1)
    for name, route, kv, max_seq_len, lengths in CASES:
        ms, peak = admit_cost(base.replace(kv_cache_dtype=kv), params, route, max_seq_len,
                              lengths, args.reps, seed=2)
        print(json.dumps({"label": args.label, "case": name, "route": route, "kv": kv,
                          "prompts": list(lengths), "admit_ms_median": statistics.median(ms),
                          "admit_ms": ms, "admit_peak_bytes_max": max(peak),
                          "admit_peak_bytes": peak}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"label": args.label, "card": smi.stdout.strip(), "src": str(src),
                      "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
