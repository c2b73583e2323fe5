"""Instruction selection, the paper's Table-1 method as a live component:
the port of ``repro.core.instr_select``.

GPTPU measured ops/s (OPS) and results/s (RPS) of every instruction (paper
§3.2, Eqs. 1-3) and rewrote algorithms onto the one with the highest RPS.
Here the table is measured on the device the operands live on, cached in a
JSON file keyed by that device's name (so a CPU table never chooses the
card's lowering), and ``best_gemm_lowering`` picks tpuGemm's lowering from
it. The file is ``_instr_table.json`` beside this module unless
``REPRO_TORCH_INSTR_TABLE`` names another; it is never the JAX package's.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch import resolve_device

TABLE_ENV = "REPRO_TORCH_INSTR_TABLE"
DEFAULT_TABLE = Path(__file__).resolve().parent / "_instr_table.json"

Table = Dict[str, Dict[str, float]]
Device = Optional[Union[str, torch.device]]


def device_key(device: torch.device) -> str:
    """The table's key for a device: the card's name, or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_op(fn: Callable, *args, iters: int = 30) -> Dict[str, float]:
    """OPS and RPS by the paper's two-run differencing (Eqs. 1-2): run the op
    ``iters`` and ``2*iters`` times; the difference cancels transfer and
    set-up time. Each timed run starts and ends with the device idle."""
    device = args[0].device
    out = fn(*args)                                  # warm (and build a kernel)
    _sync(device)

    def run(n: int) -> float:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        _sync(device)
        return time.perf_counter() - t0

    t1, t2 = run(iters), run(2 * iters)
    dt = max(t2 - t1, 1e-9)
    return {
        "ops_per_s": iters / dt,                          # Eq. 1
        "results_per_s": iters * out.numel() / dt,        # Eq. 2
    }


def build_table(device: Device = None, size: int = 256, iters: int = 20) -> Table:
    """Measure every GPTPU instruction (paper Table 1) on ``device``."""
    from repro_torch.core import gemm, instr as I   # gemm itself consults this module

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((size, size), generator=gen, device=dev)
    b = torch.randn((size, size), generator=gen, device=dev)
    v = torch.randn((size,), generator=gen, device=dev)
    k3 = torch.randn((3, 3), generator=gen, device=dev)
    cases = {
        "conv2D": (I.conv2d_quant, (a, k3)),
        "FullyConnected": (I.fully_connected_quant, (v, b)),
        "sub": (I.sub_quant, (a, b)),
        "add": (I.add_quant, (a, b)),
        "mul": (I.mul_quant, (a, b)),
        "crop": (lambda x: I.crop_fp(x, size // 2, size // 2), (a,)),
        "ext": (I.ext_fp, (a,)),
        "mean": (I.mean_quant, (a,)),
        "max": (I.max_quant, (a,)),
        "tanh": (I.tanh_quant, (a,)),
        "ReLu": (I.relu_quant, (a,)),
        # the two GEMM lowerings head to head, for best_gemm_lowering
        "gemm_fully_connected": (gemm.gemm_fully_connected, (a, b)),
        "gemm_conv2d": (gemm.gemm_conv2d, (a, b)),
    }
    return {name: measure_op(fn, *args, iters=iters) for name, (fn, args) in cases.items()}


def table_path() -> Path:
    return Path(os.environ.get(TABLE_ENV, DEFAULT_TABLE))


def get_table(device: Device = None, refresh: bool = False) -> Table:
    """The measured table of ``device``: read from the table file, or
    measured now (``refresh`` forces it) and written back beside the other
    devices' tables. A file that cannot be written leaves the measurement
    in use for this call only."""
    dev = resolve_device(device)
    key = device_key(dev)
    path = table_path()
    tables = json.loads(path.read_text()) if path.exists() else {}
    if key in tables and not refresh:
        return tables[key]
    tables[key] = build_table(dev)
    try:
        path.write_text(json.dumps(tables, indent=1))
    except OSError:
        pass
    return tables[key]


def best_gemm_lowering(device: Device = None) -> str:
    """The GEMM lowering with the higher measured RPS (paper §7.1.3)."""
    t = get_table(device)
    fc = t.get("gemm_fully_connected", {}).get("results_per_s", 0.0)
    cv = t.get("gemm_conv2d", {}).get("results_per_s", 0.0)
    return "fully_connected" if fc >= cv else "conv2d"
