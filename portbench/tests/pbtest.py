"""Shared set-up of the benchmark's CPU tests: the checkout's root and the
program's ``src`` on the import path, and cells shrunk to a size the CPU
runs in seconds (the port's own reduced config of each architecture; the
traffic's and engine's sizes cut to match).

The test cases (``CASES``) are every cell of ``BENCHMARK.json`` and each
configuration fixture beside the tests (``FIXTURES``: a configuration file
at the port's reduced sizes, served with the first cell's traffic and
engine), so a cell added as data is tested without an edit here."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import spec  # noqa: E402
from portbench.model import Model  # noqa: E402

TESTS = Path(__file__).resolve().parent
CELLS = [w["name"] for w in spec.manifest()["workloads"]]
# the port's reduced deepseek_moe_16b: routed and shared experts, top-k
FIXTURES = ["moe-smoke"]
CASES = CELLS + FIXTURES

# limits of the reduced cases by family, set from their CPU readings the
# way the cells' own are set from the card's. Dense: the program's widest
# gap 0.04-0.16 and mean at most 0.011, the int4 control's widest 1.46-2.35
# and mean 0.21-0.35. MoE (moe-smoke, 14 runs): the program's 90th
# percentile 0; the control's 0.80-1.11, the planted faults' 1.06-3.59;
# read with unrenormalised gates 0.10-0.21, with a leading dense layer
# 3.51-3.95. Where a token's experts score within rounding of a tie it
# takes others (check.py doc), which moves the widest gap (0.06-2.09) and,
# in a short run's few tokens, the mean (0.001-0.034, 0.13 over 12
# tokens): neither is compared for MoE.
SMOKE_LIMITS = {"dense": {"logit_gap": 0.6, "mean_gap": 0.1},
                "moe": {"p90_gap": 0.05}}


def fixture(name: str) -> dict:
    """Configuration fixture ``name`` (``<name>.json`` beside the tests)."""
    return spec.load_json(TESTS / f"{name}.json")


def _smoke_config(c: dict) -> dict:
    """Configuration file ``c`` at ``ArchConfig.smoke()``'s sizes."""
    kv, heads = c["num_key_value_heads"], c["num_attention_heads"]
    out = dict(c, smoke=True, num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               head_dim=16, vocab_size=256, num_key_value_heads=min(kv, 2) if kv < heads else 4,
               intermediate_size=128)
    if c.get("n_routed_experts"):
        out.update(n_routed_experts=min(c["n_routed_experts"], 4),
                   num_experts_per_tok=min(c["num_experts_per_tok"], 2),
                   moe_intermediate_size=128)
    return out


def smoke_cell(name: str) -> spec.Cell:
    """Case ``name`` (a cell or a fixture, ``CASES``) at the port's reduced
    width and depth, four slots, comparing the numbers of its family's
    ``SMOKE_LIMITS`` that the cell compares (a fixture: all of them)."""
    if name in FIXTURES:
        cell = spec.cell(CELLS[0])
        cell.name, cell.config = name, fixture(name)
        cell.store = cell.config["store"]
    else:
        cell = spec.cell(name)
    cell.config = _smoke_config(cell.config)
    cell.traffic = dict(cell.traffic, clients=4, ramp_wave=2,
                        prompt_len={"dist": "lognormal", "median": 20, "sigma": 0.5,
                                    "lo": 8, "hi": 40},
                        output_len={"dist": "lognormal", "median": 8, "sigma": 0.4,
                                    "lo": 4, "hi": 12})
    cell.engine = dict(max_slots=4, max_queue=8, max_seq_len=64, n_blocks=None,
                       prefill_chunk=None)
    # the card's rate sizes no CPU window: the smoke window closes on time
    cell.window_out_tok_s = None
    limits = SMOKE_LIMITS[Model.from_config(cell.config).family]
    cell.limits = limits if name in FIXTURES else {k: v for k, v in limits.items()
                                                   if k in cell.limits}
    return cell
