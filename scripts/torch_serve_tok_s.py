#!/usr/bin/env python3
"""The serve traffic's tok/s and TTFT on the card, for one checkout of the
PyTorch port: ``chip_smoke.py``'s serve phase traffic (tinyllama-1.1b at
full width, W8A8, block-native paged decode through the kernels, 8 slots,
8 requests of 128 + 32 tokens 2 steps apart), served ``--runs`` times in
one process.

    python3 scripts/torch_serve_tok_s.py [--src DIR] [--runs N] [--label NAME]

``--src DIR`` serves another checkout with its own ``chip_smoke.py``,
``repro_torch`` and kernels (e.g. the parent commit unpacked by
``git archive`` into a directory that .gitignore lists), so two versions
are measured in one call, in turns (parent, change, change, parent): the
host's speed differs between calls by more than either version's spread.
One JSON line per run (its sustained tok/s, mean TTFT and wall time), then
the card's line (nvidia-smi name and power limit). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout to serve (default: this one)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src), str(src / "src")]
    import torch
    if not torch.cuda.is_available():
        print("[torch_serve_tok_s] no CUDA card available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    _build.build_all()
    for i in range(args.runs):
        reqs, stats, wall, _ = chip_smoke.serve_once()
        print(json.dumps({"label": args.label, "src": str(src), "run": i,
                          "sustained_tok_s": stats["sustained_tok_s"],
                          "mean_ttft_ms": 1e3 * sum(r.metrics.ttft_s for r in reqs) / len(reqs),
                          "wall_s": wall}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
