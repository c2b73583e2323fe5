"""Run one benchmark cell of the port on this machine's card(s) and print
one JSON result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process, one card: it builds the seeded weights and the port's engine,
warms up the cell's shapes and ramps its clients (set-up), drives the
closed loop for ``--seconds`` (the window; where the cell's file gives
``window_out_tok_s``, for the work that rate does in ``--seconds``,
``portbench/loop.py``), then judges a sample of what
the engine served against the plain reference (``correct``). With
``--trace 0`` it reports the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics from a traced window. It exits with another code
than 0, and prints no result, without a CUDA card (or with fewer cards
than the cell needs), without the program beside it, or if JAX or the JAX
package has been loaded.

Caches stay inside the checkout: the port builds its kernels under
``build/kernels``; Triton and torch extension builds, were any made, go
under ``build/`` too.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


def _process_age_s() -> float:
    """Seconds since this process started (from /proc), or 0 where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_IMPORT = _process_age_s()
PC_AT_IMPORT = time.perf_counter()


def pin_threads(stage: str) -> None:
    """Keep the host's threads from moving between cores, so runs of one
    cell do not settle in different modes. ``"helpers"``, before torch
    starts any thread: the process's threads take every allowed core but
    the first two, which the threads started from here on inherit (the
    CUDA runtime's among them); ``"driver"``, once the card is set up: the
    thread that drives the engine takes the second core alone. Torch's own
    CPU thread pool is held to one thread. Does nothing with fewer than
    three allowed cores."""
    if not hasattr(os, "sched_setaffinity"):
        return
    cores = sorted(os.sched_getaffinity(0)) if stage == "helpers" else _CORES
    if len(cores) < 3:
        return
    if stage == "helpers":
        _CORES[:] = cores
        os.sched_setaffinity(0, cores[2:])
    else:
        os.sched_setaffinity(0, cores[1:2])


_CORES: list = []


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def execute(cell, seed: int, seconds: float, trace: bool, device, *, judge: bool = True,
            plant=None):
    """Build, warm up, serve the window, free the program, and (with
    ``judge``) compare with the reference. ``plant(engine)``, where given,
    breaks the engine before the run (the tests' planted faults). Returns
    (record, peak bytes, checks or None)."""
    import torch
    from portbench import check, devtrace, sut
    from portbench.loop import Loop
    from portbench.model import Model
    from portbench.traffic import Traffic

    cuda = device.type == "cuda"
    m = Model.from_config(cell.config)
    cfg = sut.port_config(cell.config)
    marks = {"imports": time.perf_counter()}
    params = sut.port_params(m, cfg, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    marks["weights"] = time.perf_counter()
    eng = sut.engine(cfg, params, cell.store, cell.engine, device)
    if plant is not None:
        plant(eng)
    marks["engine"] = time.perf_counter()
    loop = Loop(eng, Traffic(cell.traffic, m.vocab, seed), m)
    loop.rec.marks.update(marks)
    tracer = devtrace.Tracer(eng) if trace else None
    try:
        rate = cell.window_out_tok_s
        rec = loop.run(seconds, on_open=tracer.start if tracer else (lambda: None),
                       on_close=tracer.stop if tracer else (lambda: None),
                       work_tokens=math.ceil(seconds * rate) if rate else None)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    finally:
        eng.close()
    rec.setup_s = AGE_AT_IMPORT + (rec.t0 - PC_AT_IMPORT)
    del loop, eng, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if tracer is not None:
        rec.trace = tracer.summary(rec.t0, rec.t_stop)
        tracer.prof = None
    checks = check.judge(cell.config, m, seed, rec, cell.limits, device) if judge else None
    rec.marks["judged"] = time.perf_counter()
    return rec, peak, checks


def readings(cell, rec, trace: bool):
    """The cell's metrics: end-to-end without the trace, per-layer with it."""
    from portbench import spec
    entries, kind = (cell.per_layer, "metrics") if trace else (cell.end_to_end, "e2e")
    out = {}
    for e in entries:
        v = spec.reader(kind, e["name"])(rec)
        if v is not None:
            out[e["name"]] = {"value": float(v), "unit": e["unit"]}
    return out


def every_reading(rec) -> dict:
    """Every metric reader's value on this run, whichever cell it belongs
    to (printed to standard error, for the record)."""
    from portbench import spec
    out = {}
    for kind in ("e2e", "metrics"):
        for path in sorted((spec.BENCH / kind).glob("*.py")):
            v = spec.reader(kind, path.stem)(rec)
            if v is not None:
                out[path.stem] = float(v)
    return out


def describe(rec) -> str:
    arr = rec.arrivals()
    phases = {k: round(AGE_AT_IMPORT + v - PC_AT_IMPORT, 3)
              for k, v in sorted(rec.marks.items(), key=lambda kv: kv[1])}
    return (f"set-up phases end at (s from process start) {json.dumps(phases)}; "
            f"window {rec.window_s:.3f} s: {len(rec.steps)} steps, "
            f"{sum(st.tokens for st in rec.steps)} tokens, {len(arr)} arrivals "
            f"({sum(s.failed for s in arr)} failed), "
            f"{sum(1 for s in rec.served if s.finished and rec.in_window(s.finished))} finished; "
            f"counters {json.dumps(rec.counters)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    pin_threads("helpers")
    try:
        from portbench import check, spec
        cell = spec.cell(args.workload)
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"portbench: needs {cell.chips} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.set_num_threads(1)
        torch.ones(1, device=device).sum().item()
        pin_threads("driver")
        rec, peak, checks = execute(cell, args.seed, args.seconds, bool(args.trace), device)
        out = {
            "correct": check.passed(checks),
            "attempted": len(rec.arrivals()),
            "failed": int(sum(s.failed for s in rec.arrivals())),
            "metrics": readings(cell, rec, bool(args.trace)),
            "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                       "count": cell.chips, "memory_peak_bytes": int(peak)},
        }
        if args.trace:
            out["device"].update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
            out["breakdown"] = rec.trace.breakdown()
        out["checks"] = checks
    except Exception:       # the run's boundary: report, print no result
        traceback.print_exc()
        return 1
    bad = banned_modules()
    if bad:
        print(f"portbench: loaded modules {bad} (JAX or the JAX package)", file=sys.stderr)
        return 4
    print(f"card: {_card()}", file=sys.stderr)
    print(describe(rec), file=sys.stderr)
    print(f"readings: {json.dumps(every_reading(rec))}", file=sys.stderr)
    if args.trace:
        print(f"trace: busy {rec.trace.busy_s:.6f} s of {rec.trace.window_s:.6f} s, "
              f"{rec.trace.n_events} device events, the last {rec.trace.last_event_s} s "
              f"past the window, {rec.trace.markers_found} markers, offset minus wall "
              f"clock {rec.trace.offset_vs_wall_ns} ns, idle gaps by host activity "
              f"{json.dumps(dict(rec.trace.idle_count))}", file=sys.stderr)
    for name, c in checks.items():
        bound = f"max {c['max']}" if "max" in c else f"min {c['min']}"
        print(f"check {name} {c['value']} {bound}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
