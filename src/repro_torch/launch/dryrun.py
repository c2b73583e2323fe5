"""The dry run on one card: the port of ``repro.launch.dryrun``.

For every (architecture x input shape) cell, the cell's step
(``make_train_step``, ``make_prefill_step`` or ``make_decode_step``) runs
once on PyTorch's meta device over inputs of the reference's shapes and
dtypes (``models/steps.py``: ``param_sds``, ``opt_sds``, ``batch_specs``,
``cache_specs``), under the accounting context (``repro_torch.accounting``).
Nothing is allocated on any device. Eager code has no loop body counted
once, so every layer is counted at full depth and nothing is
extrapolated. A record holds:

  * ``flops``: contraction FLOPs (aten contractions and hand-kernel
    records; XLA's ``flops`` also counts elementwise work);
  * ``bytes_accessed``: the eager program's traffic, reckoned (``bytes_note``);
  * ``memory``: ``argument_size_in_bytes`` (params, optimizer state, batch,
    cache), ``output_size_in_bytes`` and ``peak_bytes`` (arguments plus the
    most bytes the step's own storages hold at once, in place of XLA's
    ``temp_size_in_bytes``);
  * ``collective_bytes``: null, ``collectives``: "none: one device".

``--multi-pod`` and ``--both-meshes`` describe the reference's pod layouts
instead. One card cannot run a partitioned program, so such a record holds
only ``memory.argument_size_in_bytes`` per device (each leaf's shard shape
under the reference's specs and ``_fit``); its FLOP, byte and peak fields
are null with the reason.

Records go to ``reports/dryrun_torch/`` (``--out``), one JSON file each.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape decode_32k
  python -m repro_torch.launch.dryrun --arch all --shape all [--quantize serve]
  python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import accounting
from repro_torch import tree as T
from repro_torch.accounting import Accounting
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_by_name
from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.core import tensorizer as tz
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import steps as ST

REPORT_DIR = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"
CARD_MESH = "card_1"
POD_MESHES = {False: "pod_16x16", True: "multipod_2x16x16"}
LONG_SKIP = "full-attention arch: long_500k requires sub-quadratic decode (DESIGN.md)"
SERVE_TRAIN_SKIP = ("quantize=serve is the serving build: its int8 weights take no "
                    "gradient (the reference's train lowering raises on them)")
POD_NOTE = ("pod layout: one card cannot run the partitioned program; only the "
            "per-device argument bytes (each leaf's shard shape) are reckoned")
MOE_NOTE = "MoE on meta: a balanced router's expert queues (no routing data)"


def _leaves(tree):
    """Tensor leaves of a tree of dicts, NamedTuples, tuples and QTensors."""
    out = []
    for leaf in T.leaves(tree):
        if isinstance(leaf, tz.QTensor):
            out += [leaf.q, leaf.scale]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages under a tree (views counted once)."""
    seen = {}
    for t in _leaves(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def build_cell(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[Callable, Tuple, Tuple]:
    """``(step_fn, args, arg_specs)`` of a cell: meta inputs and their
    partition specs on the current mesh."""
    params, pspecs = ST.param_sds(cfg)
    batch, bspecs = ST.batch_specs(cfg, shape)
    if shape.kind == "train":
        opt, ospecs = ST.opt_sds(cfg, params, pspecs)
        step = torch.zeros((), dtype=torch.int32, device=ST.META)
        return ST.make_train_step(cfg), (params, opt, batch, step), (pspecs, ospecs, bspecs, ())
    if shape.kind == "prefill":
        prefill = ST.make_prefill_step(cfg)

        def prefill_step(params, batch):
            return prefill(params, batch.get("tokens"), embeds=batch.get("embeds"),
                           positions3=batch.get("positions3"))
        return prefill_step, (params, batch), (pspecs, bspecs)
    cache, cspecs = ST.cache_specs(cfg, shape)
    decode = ST.make_decode_step(cfg)

    def decode_step(params, cache, batch):
        if cfg.family != "encdec":     # the port decodes with a per-slot index
            cache = dict(cache, index=cache["index"].expand(shape.global_batch))
        return decode(params, cache, batch["tokens"], positions3=batch.get("positions3"))
    return decode_step, (params, cache, batch), (pspecs, cspecs, bspecs)


def reduced_depths(cfg: ArchConfig):
    """(cfg_hi, cfg_lo, units_hi, units_lo, units_full): the reference's
    reduced-depth configs, field for field. The port counts every layer,
    so nothing is extrapolated from them; they check that the count is
    linear in depth."""
    if cfg.family == "encdec":
        hi = cfg.replace(n_layers=3, n_enc_layers=3, scan_unroll=True)
        lo = cfg.replace(n_layers=2, n_enc_layers=2, scan_unroll=True)
        return hi, lo, 3, 2, cfg.n_layers
    if cfg.family == "hybrid":
        tail = cfg.n_layers % cfg.attn_every
        g_full = cfg.n_layers // cfg.attn_every
        hi = cfg.replace(n_layers=2 * cfg.attn_every + tail, scan_unroll=True)
        lo = cfg.replace(n_layers=1 * cfg.attn_every + tail, scan_unroll=True)
        return hi, lo, 2, 1, g_full          # units = shared-block groups
    if cfg.family == "ssm":
        hi = cfg.replace(n_layers=4, scan_unroll=True)   # 2 pairs
        lo = cfg.replace(n_layers=2, scan_unroll=True)   # 1 pair
        return hi, lo, 2, 1, cfg.n_layers // 2           # units = pairs
    hi = cfg.replace(n_layers=3, scan_unroll=True)
    lo = cfg.replace(n_layers=2, scan_unroll=True)
    return hi, lo, 3, 2, cfg.n_layers


def count_step(cfg: ArchConfig, shape: ShapeCfg) -> Dict:
    """Run a cell's step once on meta under the accounting context (the
    current mesh must be one device): its counts and memory."""
    fn, args, _ = build_cell(cfg, shape)
    arg_bytes = tree_bytes(args)
    with Accounting() as acc:
        out = fn(*args)
    return {"flops": acc.flops, "bytes_accessed": acc.bytes_accessed,
            "memory": {"argument_size_in_bytes": arg_bytes,
                       "output_size_in_bytes": tree_bytes(out),
                       "peak_bytes": arg_bytes + acc.peak_bytes},
            "flops_by_op": dict(acc.flops_by_op), "flops_by_dtype": dict(acc.flops_by_dtype),
            "kernels": acc.kernels}


def pod_argument_bytes(cfg: ArchConfig, shape: ShapeCfg) -> int:
    """Per-device argument bytes on the current (pod) mesh: each leaf's
    shard shape under its fitted spec."""
    _, args, specs = build_cell(cfg, shape)
    total = 0

    def walk(t, spec):
        nonlocal total
        if t is None:
            return
        if isinstance(t, dict):
            for k in t:
                walk(t[k], spec[k])
        elif isinstance(t, tz.QTensor):
            walk(t.q, spec.q)
            walk(t.scale, spec.scale)
        elif isinstance(t, tuple):          # AdamWState, the args tuple
            for a, s in zip(t, spec):
                walk(a, s)
        else:
            n = 1
            for d in ST.shard_shape(t.shape, spec):
                n *= d
            total += n * t.element_size()
    walk(args, specs)
    return total


def run_cell(arch: str, shape_name: str, multi_pod: Optional[bool] = None,
             quantize: str = "off", overrides: Optional[Dict] = None,
             tag: str = "") -> Dict:
    """One cell's record: on one card (``multi_pod`` None, mesh
    ``card_1``), or the per-device argument bytes of a pod layout
    (``multi_pod`` False: 16 x 16, True: 2 x 16 x 16)."""
    cfg = get_config(arch)
    if quantize != "off":
        cfg = cfg.replace(quantize=quantize)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape_by_name(shape_name)
    mesh_name = CARD_MESH if multi_pod is None else POD_MESHES[multi_pod]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind,
           "quantize": quantize, "tag": tag, "status": "skipped"}
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        rec["reason"] = LONG_SKIP
        return rec
    if shape.kind == "train" and cfg.quantize == "serve":
        rec["reason"] = SERVE_TRAIN_SKIP
        return rec
    t0 = time.time()
    if multi_pod is None:
        with shd.use_mesh(shd.Mesh((1,), ("data",), ST.META)):
            counted = count_step(cfg, shape)
        rec.update(status="ok", n_devices=1, seconds=round(time.time() - t0, 2),
                   flops=counted["flops"], bytes_accessed=counted["bytes_accessed"],
                   bytes_note=accounting.BYTES_NOTE, collective_bytes=None,
                   collectives=accounting.COLLECTIVES_NOTE, memory=counted["memory"],
                   flops_by_op=counted["flops_by_op"],
                   flops_by_dtype=counted["flops_by_dtype"], kernels=counted["kernels"])
        if cfg.family == "moe":
            rec["note"] = MOE_NOTE
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
        with shd.use_mesh(mesh):
            arg_bytes = pod_argument_bytes(cfg, shape)
        rec.update(status="ok", n_devices=mesh.size, seconds=round(time.time() - t0, 2),
                   flops=None, bytes_accessed=None, collective_bytes=None,
                   reason=POD_NOTE, collectives=POD_NOTE,
                   memory={"argument_size_in_bytes": arg_bytes,
                           "output_size_in_bytes": None, "peak_bytes": None})
    rec.update(model_params=cfg.param_count(),
               model_params_active=cfg.active_param_count(),
               tokens=shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len))
    return rec


def save(rec: Dict, directory: Path = REPORT_DIR) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tag = f"_{rec['tag']}" if rec.get("tag") else ""
    q = f"_q{rec['quantize']}" if rec.get("quantize", "off") != "off" else ""
    p = directory / f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{q}{tag}.json"
    p.write_text(json.dumps(rec, indent=1))
    return p


def _overrides(text: str) -> Dict:
    out = {}
    for kv in filter(None, text.split(",")):
        k, v = kv.split("=")
        out[k] = {"true": True, "false": False}.get(v.lower(), v)
        if isinstance(out[k], str):
            for caster in (int, float):
                try:
                    out[k] = caster(v)
                    break
                except ValueError:
                    pass
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 pod layout's per-device argument bytes")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the 16 x 16 and 2 x 16 x 16 pod layouts")
    ap.add_argument("--quantize", default="off")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", default="", help="k=v,k=v config overrides")
    ap.add_argument("--out", default=str(REPORT_DIR), help="directory of the records")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch.replace("-", "_").replace(".", "_")]
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    meshes = ([False, True] if args.both_meshes
              else [True] if args.multi_pod else [None])
    overrides = _overrides(args.override)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = f"{arch} x {shape} x {CARD_MESH if mp is None else POD_MESHES[mp]}"
                try:
                    rec = run_cell(arch, shape, mp, args.quantize, overrides, args.tag)
                    p = save(rec, Path(args.out))
                    if rec["status"] != "ok":
                        print(f"[dryrun] SKIP {label}: {rec['reason']}", flush=True)
                    elif mp is None:
                        mem = rec["memory"]
                        print(f"[dryrun] OK   {label}: {rec['seconds']}s "
                              f"flops={rec['flops']:.4e} bytes={rec['bytes_accessed']:.4e} "
                              f"args={mem['argument_size_in_bytes']:.4e}B "
                              f"peak={mem['peak_bytes']:.4e}B -> {p.name}", flush=True)
                    else:
                        print(f"[dryrun] OK   {label}: args/device="
                              f"{rec['memory']['argument_size_in_bytes']:.4e}B -> {p.name}",
                              flush=True)
                except Exception as e:
                    failures += 1
                    print(f"[dryrun] FAIL {label}: {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
