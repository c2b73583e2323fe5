"""Readings that the correctness limits are set from, for one cell, all
seeds in one process (set-up is paid per seed, the kernel builds once):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed: a run of the cell as ``run.py`` makes it (trace off), then
on its sample the program's widest served-token gap under the int8
reference (the lower reading), and the control's widest gap: the int4
reference put in the program's place, read at the same positions (the
upper reading). One JSON line a seed, to standard output. The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _stats(gaps) -> dict:
    """The widest gap, the mean, the five widest, the median, and the share of
    tokens that are the reference's best (gap 0)."""
    g = sorted(float(x) for x in gaps)
    return {"widest": g[-1], "mean": sum(g) / len(g), "top5": g[-5:][::-1],
            "median": g[len(g) // 2],
            "best_share": sum(x == 0.0 for x in g) / len(g), "tokens": len(g)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.run import every_reading, execute, pin_threads
    pin_threads("helpers")
    import torch
    from portbench import check, spec
    from portbench.model import Model
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    torch.ones(1, device=device).sum().item()
    pin_threads("driver")
    m = Model.from_config(cell.config)
    for seed in (int(s) for s in args.seeds.split(",")):
        rec, peak, _ = execute(cell, seed, args.seconds, False, device, judge=False)
        samples = check.sample(rec, seed)
        ref = check.reference_logits(cell.config, m, seed, samples, device, bits=8)
        gaps = check.served_gaps(ref, samples)
        low = check.reference_logits(cell.config, m, seed, samples, device, bits=4)
        ctl = check.control_gaps(ref, low)
        line = {"seed": seed, "program": _stats(gaps), "control": _stats(ctl),
                "requests": len(samples), "readings": every_reading(rec),
                "memory_peak_bytes": int(peak),
                "arrivals": len(rec.arrivals())}
        print(json.dumps(line), flush=True)
        del rec, ref, low, samples
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
