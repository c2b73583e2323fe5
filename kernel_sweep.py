#!/usr/bin/env python3
"""Device times of the stencil and qgemv kernels, and sweeps of their
compiled-in settings, on one NVIDIA card.

    python3 kernel_sweep.py [--src DIR] [--label NAME] [--check] [--sweep]

Run from the root of a checkout. ``--src DIR`` imports ``repro_torch`` from
``DIR/src`` instead of this checkout's, so that another version (for
example the parent commit, unpacked by ``git archive`` into a git-ignored
directory such as ``build/parent``) is timed by the same code; run the two
in turns (parent, change, change, parent) in one call to compare them on
one card. Each line printed is one JSON object, tagged with ``--label``
(redirect the output to keep it):

- ``card``: the card's name and power limit (nvidia-smi), the source, and
  ptxas' registers and spills of the two kernels' builds;
- ``yardsticks``: the graph time of a one-element add, of ``clone`` of a
  cold 1024^2 and 4096^2 field, and of a sum reading each serving
  projection's int8 weights once;
- ``check`` (``--check``): ``chip_smoke.check_stencil`` and
  ``chip_smoke.check_qgemv``;
- ``stencil3x3`` and ``qgemv``: ``chip_smoke.time_stencil`` and
  ``chip_smoke.time_qgemv`` (device times from CUDA graphs, operands cold);
- ``stencil_sweep`` (``--sweep``): device time at 1024^2 and 4096^2 of
  every warps per block x rows in flight (the kernel built with
  ``-DSTENCIL_WARPS``, ``-DSTENCIL_DEPTH``) x strip height;
- ``qgemv_sweep`` (``--sweep``): device time on every serving projection
  of every stripe width x cluster size, at B = 8 on the tensor cores for
  ring depths 3 and 4 (``-DQGEMV_RING``), and at B = 1 on the CUDA cores
  for 4 and 8 loads in flight and on the tensor cores (4-row chunks).

The sweeps build their variants of ``csrc/*.cu`` into ``build/sweep/`` and
call the C entry points directly with explicit plans; the package's own
libraries and plans are not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SWEEP_DIR = ROOT / "build" / "sweep"


def emit(label, record):
    print(json.dumps({"label": label, **record}), flush=True)


def yardsticks(dev, cs):
    """What the card does with no kernel of ours: the graph time of a
    one-element add (the floor of a launch in a graph), ``clone`` of a cold
    field (one read and one write of it, PyTorch's copy kernel), and a sum
    of each serving projection's cold int8 weights viewed as int32 (one
    read of them, PyTorch's reduction kernel)."""
    import torch
    one = torch.zeros(1, device=dev)
    rows = [{"what": "add_ on 1 element", "graph_ms": cs.graph_ms(lambda: one.add_(1), 50)}]
    for n in (1024, 4096):
        xs = itertools.cycle(cs.cold_copies(lambda: torch.empty((n, n), device=dev), 4 * n * n))
        rows.append({"what": f"clone of {n}^2 f32", "graph_ms":
                     cs.graph_ms(lambda: next(xs).clone(), 50)})
    for K, N in cs.QGEMV_PAIRS:
        ws = itertools.cycle(cs.cold_copies(
            lambda: torch.zeros((K, N), dtype=torch.int8, device=dev), K * N))
        rows.append({"what": f"sum of {K}x{N} int8 as int32", "graph_ms":
                     cs.graph_ms(lambda: next(ws).view(torch.int32).sum(), 50)})
    return rows


def build_variants(name, variants):
    """``csrc/<name>.cu`` built once for each dict of defines in
    ``variants``, all ``nvcc`` at once, into ``build/sweep/``; the loaded
    libraries in the same order."""
    from repro_torch.kernels import _build
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for defines in variants:
        tag = "_".join(f"{k}{v}" for k, v in sorted(defines.items()))
        out = SWEEP_DIR / f"lib{name}_{tag}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines.items()),
               "-o", str(out), str(_build.CSRC / f"{name}.cu")]
        jobs.append((out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    libs = []
    for out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs.append(lib)
    return libs


def sweep_stencil(dev, cs, warps_set=(1, 2, 4, 8), depths=(2, 4, 8),
                  rows_set=(2, 4, 8, 16, 32, 64)):
    import torch
    from repro_torch.kernels import _build
    variants = [{"STENCIL_WARPS": wp, "STENCIL_DEPTH": d}
                for wp, d in itertools.product(warps_set, depths)]
    libs = build_variants("stencil3x3", variants)
    gen = torch.Generator(device=dev).manual_seed(20)
    w = torch.randn((3, 3), generator=gen, device=dev)
    rows = []
    for n in (1024, 4096):
        xs = itertools.cycle(cs.cold_copies(
            lambda: torch.randn((n, n), generator=gen, device=dev), 4 * n * n))
        out = torch.empty((n, n), device=dev)
        for (defines, lib), r in itertools.product(zip(variants, libs), rows_set):
            def call():
                x = next(xs)
                _build.check(lib.stencil3x3_launch(
                    x.data_ptr(), w.data_ptr(), out.data_ptr(), n, n, 4, r,
                    torch.cuda.current_stream().cuda_stream), "stencil3x3 sweep")
            rows.append({"n": n, "width": 4, "rows": r, "warps": defines["STENCIL_WARPS"],
                         "depth": defines["STENCIL_DEPTH"],
                         "blocks": -(-n // (defines["STENCIL_WARPS"] * 128)) * -(-n // r),
                         "graph_ms": cs.graph_ms(call, 50)})
    return rows


def sweep_qgemv(dev, cs, clusters=(1, 2, 4, 8)):
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import qdot_serve as tqs
    rings = (3, 4)
    libs = dict(zip(rings, build_variants("qgemv", [{"QGEMV_RING": r} for r in rings])))
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = []
    for B, (K, N) in itertools.product((8, 1), cs.QGEMV_PAIRS):
        x = torch.randn((B, K), generator=gen, device=dev)
        s = torch.rand(N, generator=gen, device=dev) * 1e-2
        out = torch.empty((B, N), device=dev)
        ws = itertools.cycle(cs.cold_copies(lambda: torch.randint(
            -128, 128, (K, N), generator=gen, device=dev, dtype=torch.int8), K * N))
        # (rows per chunk, stripe widths, depths, library of each depth)
        if B == 8:
            grids = [(8, tqs.STRIPES, rings, libs)]
        else:
            grids = [(1, tqs.STRIPES[:2], tqs.CORES_DEPTH, {d: libs[4] for d in tqs.CORES_DEPTH}),
                     (4, tqs.STRIPES, (4,), libs)]
        for rb, stripes, depths, lib_of in grids:
            for tn, c, depth in itertools.product(stripes, clusters, depths):
                lib = lib_of[depth]

                def call():
                    _build.check(lib.qgemv_launch(
                        x.data_ptr(), next(ws).data_ptr(), s.data_ptr(), out.data_ptr(),
                        B, K, N, rb, tn, c, depth, torch.cuda.current_stream().cuda_stream),
                        "qgemv sweep")
                rows.append({"B": B, "K": K, "N": N, "rb": rb, "tn": tn, "cluster": c,
                             "depth": depth, "ctas": (N // tn) * c * -(-B // rb),
                             "graph_ms": cs.graph_ms(call, 50)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT), help="checkout whose src/ is imported")
    ap.add_argument("--label", default="change")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    src = Path(args.src).resolve() / "src"
    if not (src / "repro_torch" / "kernels").is_dir():
        print(f"[kernel_sweep] {src}/repro_torch not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("[kernel_sweep] no CUDA card available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    from repro_torch.kernels import _build
    seconds = _build.build_all(["stencil3x3", "qgemv"])
    emit(args.label, {"phase": "card", "nvidia_smi": smi.stdout.strip(),
                      "src": str(src), "torch": torch.__version__, "build_s": seconds,
                      "ptxas": {k: [l for l in v.splitlines() if "registers" in l or "spill" in l]
                                for k, v in _build.build_logs.items()}})
    emit(args.label, {"phase": "yardsticks", "rows": yardsticks(dev, cs)})
    if args.check:
        emit(args.label, {"phase": "check", "stencil3x3": cs.check_stencil(dev),
                          "qgemv": cs.check_qgemv(dev)})
    emit(args.label, {"phase": "stencil3x3", "rows": cs.time_stencil(dev)})
    emit(args.label, {"phase": "qgemv", "rows": cs.time_qgemv(dev, [])})
    if args.sweep:
        emit(args.label, {"phase": "stencil_sweep", "rows": sweep_stencil(dev, cs)})
        emit(args.label, {"phase": "qgemv_sweep", "rows": sweep_qgemv(dev, cs)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
