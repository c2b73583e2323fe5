"""Shared set-up of the benchmark's CPU tests: the checkout's root and the
program's ``src`` on the import path, and cells shrunk to a size the CPU
runs in seconds (the port's own reduced config of each architecture; the
traffic's and engine's sizes cut to match)."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import spec  # noqa: E402

# limits of the reduced cells, set from their CPU readings the way the
# cells' own are set from the card's: the program's widest gap 0.04-0.16
# and mean at most 0.011;
# the int4 control's widest 1.46-2.35 and mean 0.21-0.35
SMOKE_LIMITS = {"logit_gap": 0.6, "mean_gap": 0.1}


def smoke_cell(name: str) -> spec.Cell:
    """Cell ``name`` at the port's reduced width and depth, four slots,
    comparing the numbers the cell compares."""
    cell = spec.cell(name)
    c = dict(cell.config, smoke=True, num_hidden_layers=2, hidden_size=64,
             num_attention_heads=4, head_dim=16, vocab_size=256,
             num_key_value_heads=2, intermediate_size=128)
    cell.config = c
    cell.traffic = dict(cell.traffic, clients=4, ramp_wave=2, block=4,
                        prompt_len={"dist": "lognormal", "median": 20, "sigma": 0.5,
                                    "lo": 8, "hi": 40},
                        output_len={"dist": "lognormal", "median": 8, "sigma": 0.4,
                                    "lo": 4, "hi": 12})
    cell.engine = dict(max_slots=4, max_queue=8, max_seq_len=64, n_blocks=None,
                       prefill_chunk=None)
    cell.limits = {k: SMOKE_LIMITS[k] for k in cell.limits}
    return cell
