"""The port's dry run and cost accounting against the JAX package's.

* Configs: ``ShapeCfg``/``SHAPES``/``shape_by_name`` field for field;
  ``is_encdec``, ``param_count`` and ``active_param_count`` bitwise for all
  10 archs at full width and smoke; ``reduced_depths`` the reference's
  configs field for field (the reference's dryrun module forces 512 host
  devices at import, so its function is compiled from its source).
* FLOPs: the port's contraction FLOPs (``repro_torch.accounting``) against
  the reference's, read from the step's jaxpr: every ``dot_general`` that
  contracts a dimension (one that contracts none is an elementwise product
  in disguise, which XLA's einsum paths emit), nested jaxprs walked, scan
  bodies times their length. tinyllama's train, prefill (the chunked
  attention) and decode are equal to the integer; every other family is
  equal or differs by a term derived from the shapes below, each with its
  reason. The port counts the same on the CPU and on meta, and at full
  width its count is linear in depth across ``reduced_depths``.
* The accounting itself: the peak tracker on a hand-built live set, and
  each hand-kernel wrapper on meta (its plain version's shape and dtype, its
  formula recorded, nothing launched) and on the CPU (the plain version's
  own ops not counted).
* The CLI in a subprocess: a ``status: "ok"`` record with the reference's
  keys, ``collective_bytes: null``; a pod-mesh record with only argument
  bytes; the reference's long_500k skip.

The JAX side only traces (``jax.make_jaxpr``) at smoke widths: nothing is
compiled, and nothing runs at full width but the port on meta.
"""

import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.extend.core
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import ARCH_IDS, get_config as jget
from repro.configs.base import SHAPES as JSHAPES, ShapeCfg as JShape, shape_by_name as jshape
from repro.distributed import sharding as jshd
from repro.models import ssm as JSSM
from repro.models import steps as JST
from repro_torch import accounting
from repro_torch.accounting import Accounting
from repro_torch.configs import SHAPES, get_config as tget, shape_by_name
from repro_torch.configs.base import ShapeCfg
from repro_torch.distributed import sharding as tshd
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import qdot_serve as tqs
from repro_torch.kernels import qgemm as tq
from repro_torch.kernels import stencil3x3 as tst
from repro_torch.launch import dryrun as TD
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.models.attention import ATTEND_ROWS
from repro_torch.models.moe import EXPERT_ROWS, ROUTER_ROWS
from repro_torch.models.xlstm import FIXED_ROWS

import _torch_parity as P

REPO = Path(__file__).resolve().parent.parent
META = torch.device("meta")


# ------------------------------------------------------------- configs

def test_shapes_match_the_reference():
    assert [dataclasses.asdict(s) for s in SHAPES] == [dataclasses.asdict(s) for s in JSHAPES]
    for s in JSHAPES:
        assert dataclasses.asdict(shape_by_name(s.name)) == dataclasses.asdict(jshape(s.name))
    with pytest.raises(KeyError):
        shape_by_name("train_8k")


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_counts_are_the_references(arch, smoke):
    j, t = jget(arch), P.jax_block(tget(arch))
    if smoke:
        j, t = j.smoke(), t.smoke()
    assert t.is_encdec == j.is_encdec
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    if arch == "tinyllama_1_1b" and not smoke:
        assert t.param_count() == 1_099_956_224


def _reference_reduced_depths():
    """The reference's ``reduced_depths``, compiled from its source: its
    module forces 512 host devices when imported, so it is not imported."""
    path = REPO / "src" / "repro" / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "reduced_depths")
    scope = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), scope)
    return scope["reduced_depths"]


def test_reduced_depths_are_the_references():
    ref = _reference_reduced_depths()
    for arch in ARCH_IDS:
        hi, lo, uh, ul, uf = TD.reduced_depths(P.jax_block(tget(arch)))
        rhi, rlo, ruh, rul, ruf = ref(jget(arch))
        assert (P.jax_fields(hi), P.jax_fields(lo)) == (
            dataclasses.asdict(rhi), dataclasses.asdict(rlo)), arch
        assert (uh, ul, uf) == (ruh, rul, ruf), arch


# ------------------------------------------------------------- FLOPs

def _dot_flops(eqn) -> int:
    (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
    ls, rs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
    free = lambda s, c, b: math.prod(d for i, d in enumerate(s) if i not in c and i not in b)
    return (2 * math.prod(ls[i] for i in lb) * math.prod(ls[i] for i in lc)
            * free(ls, lc, lb) * free(rs, rc, rb))


def jaxpr_flops(jaxpr, mult: int = 1) -> int:
    """Contraction FLOPs of a jaxpr: every dot_general contracting at least
    one dimension, nested jaxprs included, scan bodies times their length."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "while":
            raise ValueError("a while loop's trip count is unknown")
        if name == "dot_general" and eqn.params["dimension_numbers"][0][0]:
            total += mult * _dot_flops(eqn)
        m = mult * (eqn.params["length"] if name == "scan" else 1)
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                inner = sub if isinstance(sub, jax.extend.core.Jaxpr) else getattr(sub, "jaxpr", None)
                if isinstance(inner, jax.extend.core.Jaxpr):
                    total += jaxpr_flops(inner, m)
    return total


@pytest.fixture
def auto_mesh():
    """The reference traced on an Auto-axis one-device mesh (its
    with_sharding_constraint raises on the conftest's Explicit-axis one)."""
    prev = jshd.current_mesh()
    jshd.set_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,)))
    yield
    jshd.set_mesh(prev)


def ref_flops(cfg, shape) -> int:
    params = JST.param_sds(cfg)
    if shape.kind == "train":
        fn = JST.make_train_step(cfg)
        args = (params, JST.opt_sds(cfg, params), JST.batch_specs(cfg, shape),
                jax.ShapeDtypeStruct((), jnp.int32))
    elif shape.kind == "prefill":
        fn, args = JST.make_prefill_step(cfg), (params, JST.batch_specs(cfg, shape))
    else:
        fn = JST.make_decode_step(cfg)
        args = (params, JST.cache_specs(cfg, shape), JST.batch_specs(cfg, shape))
    return jaxpr_flops(jax.make_jaxpr(fn)(*args).jaxpr)


def _materialize(t, vocab, gen):
    """A CPU tensor of a meta leaf's shape and dtype with valid values."""
    if t.dtype in (torch.int32, torch.int64):
        return torch.randint(0, min(vocab, 16), tuple(t.shape), generator=gen, dtype=t.dtype)
    if t.dtype == torch.int8:
        return torch.randint(-127, 128, tuple(t.shape), generator=gen, dtype=t.dtype)
    return (torch.rand(tuple(t.shape), generator=gen) * 0.02 + 1e-3).to(t.dtype)


def _on_cpu(tree, vocab, gen):
    if isinstance(tree, dict):
        return {k: _on_cpu(v, vocab, gen) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_on_cpu(v, vocab, gen) for v in tree)) if hasattr(tree, "_fields") \
            else tuple(_on_cpu(v, vocab, gen) for v in tree)
    if isinstance(tree, TM.tz.QTensor):
        return TM.tz.QTensor(_on_cpu(tree.q, vocab, gen), _on_cpu(tree.scale, vocab, gen),
                             tree.meta_shape)
    return None if tree is None else _materialize(tree, vocab, gen)


def port_flops(cfg, shape, device=META) -> int:
    with tshd.use_mesh(tshd.Mesh((1,), ("data",), META)):
        fn, args, _ = TD.build_cell(cfg, shape)
    if device.type == "cpu":
        args = _on_cpu(args, cfg.vocab, torch.Generator().manual_seed(0))
    with tshd.use_mesh(tshd.Mesh((1,), ("data",), device)):
        with Accounting() as acc:
            fn(*args)
    return acc.flops


def _pad(n: int, rows: int = 64) -> int:
    return -(-n // rows) * rows


def _attend_pad(cfg, B, S, layers):
    """Decode's one-query contraction runs ATTEND_ROWS rows a call, zero
    rows padding the batch: the score and value contractions of the
    padding rows."""
    return layers * 4 * cfg.n_heads * S * cfg.hd * (_pad(B, ATTEND_ROWS) - B)


def ssd_backward_delta(B, T, H, N, P, chunk) -> int:
    """The chunked recurrence's backward, port minus reference, each
    framework's own count of that function alone at these shapes: JAX
    transposes its three-operand einsums into contractions that the port's
    autograd of an elementwise product and a two-operand einsum forms
    differently."""
    shp = [(B, T, H), (B, T, H, N), (B, T, H, N), (B, T, H, P)]
    sds = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shp]
    f = lambda *a: jnp.sum(JSSM.chunked_linear_recurrence(*a, chunk)[0])  # noqa: E731
    ref = (jaxpr_flops(jax.make_jaxpr(jax.value_and_grad(f, argnums=(0, 1, 2, 3)))(*sds).jaxpr)
           - jaxpr_flops(jax.make_jaxpr(f)(*sds).jaxpr))
    ts = [torch.empty(s, device=META, requires_grad=True) for s in shp]
    y = TSSM.chunked_linear_recurrence(*ts, chunk)[0].sum()
    with Accounting() as acc:
        torch.autograd.grad(y, ts)
    return acc.flops - ref


def derived_delta(cfg, shape) -> int:
    """The port's contraction FLOPs minus the reference's, from the shapes.
    0 for the dense configs' train and prefill."""
    B, S, kind = shape.global_batch, shape.seq_len, shape.kind
    D, L = cfg.d_model, cfg.n_layers
    if cfg.family in ("dense", "vlm"):
        return _attend_pad(cfg, B, S, L) if kind == "decode" else 0
    if cfg.family == "encdec":
        kv = cfg.n_kv * cfg.hd
        if kind == "train":
            return 0
        if kind == "prefill":
            # the reference's cross attention projects K/V of the decoder
            # stream too, then replaces them with the encoder's
            return -L * 2 * (2 * B * S * D * kv)
        se = max(1, S // cfg.enc_len_ratio)
        # padding rows of self and cross decode contractions; the reference's
        # cross decode projects K/V of the token and drops them
        return (_attend_pad(cfg, B, S, L) + _attend_pad(cfg, B, se, L)
                - L * 2 * (2 * B * D * kv))
    if cfg.family == "moe":
        E, F, k = cfg.n_experts, cfg.d_ff, cfg.topk
        T = B * (1 if kind == "decode" else S)
        capacity = max(k, math.ceil(T * k / E * cfg.capacity_factor))
        n_pass = 1 if T <= EXPERT_ROWS else -(-(-(-T * k // E)) // EXPERT_ROWS)
        # the router runs ROUTER_ROWS rows a call, zero-padded; the experts
        # run n_pass x (E, EXPERT_ROWS) rows gathered from their queues where
        # the reference runs its (E, capacity) buffers (dispatch and combine
        # are a scatter-add in both: no contraction)
        fwd = L * (2 * (_pad(T, ROUTER_ROWS) - T) * D * E
                   + 6 * E * D * F * (EXPERT_ROWS * n_pass - capacity))
        if kind == "train":
            return 4 * fwd        # forward, remat's recompute, two backward products
        return fwd + (_attend_pad(cfg, B, S, L) if kind == "decode" else 0)
    if cfg.family == "hybrid":
        G = L // cfg.attn_every
        di = TSSM.d_inner(cfg)
        H, P, N = TSSM.n_ssm_heads(cfg), cfg.ssm_headdim, cfg.ssm_state
        if kind == "prefill":
            return 0
        if kind == "decode":
            # the ssm readout C . h is a fixed tree of adds in the port
            return _attend_pad(cfg, B, S, G) - L * 2 * B * H * P * N
        # torch's checkpoint stops its recompute at the last saved tensor, so
        # each group's last mamba wo is not recomputed; the reference's inner
        # scan over the group's layers recomputes it
        return (L * ssd_backward_delta(B, S, H, N, P, min(cfg.ssm_chunk, S))
                - G * 2 * B * S * di * D)
    if cfg.family == "ssm":
        n = L // 2
        H = cfg.n_heads
        hd = D // H
        T = 1 if kind == "decode" else S
        # the sLSTM's recurrent product and its up/down projections run
        # FIXED_ROWS rows a call, zero-padded
        rec = 2 * H * hd * 4 * hd * T * (_pad(B, FIXED_ROWS) - B)
        fdot = 2 * (_pad(B * T, FIXED_ROWS) - B * T) * (D * 2 * D + D * D)
        fwd = n * (rec + fdot)
        if kind == "prefill":
            return fwd
        if kind == "decode":
            # mLSTM's readouts C q and n . q are fixed trees of adds
            return fwd - n * (2 * B * H * hd * hd + 2 * B * H * hd)
        chunk = min(cfg.ssm_chunk, S)
        # backward: twice the forward's padded products, less the first
        # step's product for the grad of h_0 (a constant, which the port's
        # autograd skips and the reference's scan transpose does not), plus
        # the chunked recurrence's backward (num and den)
        bwd = 2 * fwd - n * H * 2 * _pad(B, FIXED_ROWS) * 4 * hd * hd + n * (
            ssd_backward_delta(B, S, H, hd, hd, chunk) + ssd_backward_delta(B, S, H, hd, 1, chunk))
        # remat's recompute: the port leaves out its last wdown call
        # (FIXED_ROWS rows), the reference its whole wdown product
        recompute = fwd - n * 2 * FIXED_ROWS * D * D + n * 2 * B * S * D * D
        return fwd + bwd + recompute
    raise AssertionError(cfg.family)


TINY_CELLS = [("train", 24, 2), ("prefill", 24, 2), ("decode", 24, 64), ("decode", 24, 3)]


@pytest.mark.parametrize("kind,S,B", TINY_CELLS, ids=lambda v: str(v))
def test_tinyllama_flops_equal_the_references(auto_mesh, kind, S, B):
    """S = 24 is longer than the smoke attn_chunk (16): the chunked online
    softmax runs in train and prefill, its last chunk padded. Decode is
    equal at a batch of ATTEND_ROWS; at 3 rows the port also counts its
    padding rows, which it computes."""
    jc, tc = jget("tinyllama_1_1b").smoke(), tget("tinyllama_1_1b").smoke()
    assert S > tc.attn_chunk
    ref = ref_flops(jc, JShape("x", S, B, kind))
    got = port_flops(tc, ShapeCfg("x", S, B, kind))
    assert got == ref + derived_delta(tc, ShapeCfg("x", S, B, kind))
    if B % ATTEND_ROWS == 0 or kind != "decode":
        assert got == ref
    assert port_flops(tc, ShapeCfg("x", S, B, kind), torch.device("cpu")) == got


FAMILY_ARCHS = ["deepseek_moe_16b", "qwen2_vl_2b", "seamless_m4t_medium", "zamba2_7b",
                "xlstm_125m", "qwen3_14b", "starcoder2_15b", "granite_20b"]


def _family_cells(arch):
    family = jget(arch).family
    if family == "moe":                    # at most EXPERT_ROWS tokens: one expert pass
        return [("train", 16, 2), ("prefill", 16, 2), ("decode", 16, 8)]
    if family == "ssm":                    # no attention: two mLSTM chunks of 8
        return [("train", 16, 2), ("prefill", 16, 2), ("decode", 16, 3)]
    return [c for c in TINY_CELLS if c[2] != ATTEND_ROWS]   # decode at 3 rows: padded


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_flops_equal_or_derived(auto_mesh, arch):
    jc, tc = jget(arch).smoke(), P.jax_block(tget(arch).smoke())
    for kind, S, B in _family_cells(arch):
        ref = ref_flops(jc, JShape("x", S, B, kind))
        got = port_flops(tc, ShapeCfg("x", S, B, kind))
        assert got == ref + derived_delta(tc, ShapeCfg("x", S, B, kind)), (kind, B)
    kind, S, B = _family_cells(arch)[-1]
    assert port_flops(tc, ShapeCfg("x", S, B, kind), torch.device("cpu")) == got


@pytest.mark.parametrize("arch,shape", [("tinyllama_1_1b", "decode_32k"),
                                        ("zamba2_7b", "decode_32k"),
                                        ("xlstm_125m", "decode_32k")])
def test_full_width_count_is_linear_in_depth(arch, shape):
    """At full width, the count at full depth is the reduced-depth pair's
    line at the full number of units: every layer is counted."""
    cfg, sh = tget(arch), shape_by_name(shape)
    hi, lo, u_hi, u_lo, u_full = TD.reduced_depths(cfg)
    f_hi, f_lo, f_full = (port_flops(c, sh) for c in (hi, lo, cfg))
    assert (f_hi - f_lo) % (u_hi - u_lo) == 0
    assert f_full == f_lo + (u_full - u_lo) * (f_hi - f_lo) // (u_hi - u_lo)


# ------------------------------------------------------------- accounting

def test_peak_tracker_follows_a_known_live_set():
    pre = torch.empty(1000, device=META)          # before the context: never counted
    with Accounting() as acc:
        a = torch.empty(1000, device=META)        # 4000 live
        b = torch.empty(500, device=META)         # 6000
        v = b.view(20, 25)                        # a view: no new bytes
        b.add_(1)                                 # in place: no new bytes
        pre.mul_(2)                               # an argument updated: not counted
        del a                                     # 2000
        c = torch.empty(2000, device=META)        # 10000: the peak
        del b                                     # the view keeps b's storage: 10000
        assert acc.live_bytes == 10000
        del v                                     # 8000
        assert acc.live_bytes == 8000
        x = torch.ones(256, device=META, requires_grad=True)   # 9024
        y = x.exp()                               # saved by autograd: 10048
        z = y.sum()                               # 10052
        del y                                     # still saved: 10052
        assert acc.live_bytes == 10052
        (g,) = torch.autograd.grad(z, x)          # graph freed, grad alive
        del z, c
    assert acc.peak_bytes == 10052 + 4 + 1024     # z's seed grad and x's beside the saved y
    assert acc.live_bytes == 1024 + 1024          # x and its grad
    assert acc.flops == 0 and acc.bytes_accessed > 0
    assert g.shape == x.shape


def test_tree_walks_free_their_leaves():
    """``tree.flatten``/``unflatten`` leave no reference cycle: a leaf dies
    with its last reference, not at the next garbage collection (a train
    step's gradients held by such a cycle raised its peak by up to 2.2 GB,
    depending on when the collector ran)."""
    import gc
    import weakref
    from repro_torch import tree as T
    gc.disable()
    try:
        t = torch.ones(4)
        ref = weakref.ref(t)
        leaves, spec = T.flatten({"a": t, "b": [None, (1,)]})
        back = T.unflatten(spec, leaves)
        del t, leaves, back
        assert ref() is None
    finally:
        gc.enable()


def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, dtype=torch.int8)  # noqa: E731
    f32 = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    M, K, N = 24, 256, 128
    pool = torch.rand((6, 16, 2, 64), generator=g).to(torch.bfloat16)
    tables = torch.randint(1, 6, (3, 4), generator=g, dtype=torch.int32)
    index = torch.tensor([5, 30, 63], dtype=torch.int32)
    return [
        ("qgemm", tq.qgemm, (i8(M, K), i8(K, N), f32(N), f32(M), torch.bfloat16),
         2 * M * N * K, M * K + K * N + 4 * N + 4 * M + 2 * M * N),
        ("qgemm_tile_scales", tq.qgemm_tile_scales, (i8(128, 256), i8(256, 128), f32(1, 2),
                                                     f32(2, 1)),
         2 * 128 * 128 * 256, 128 * 256 * 2 + 8 + 8 + 4 * 128 * 128),
        ("qgemv", tqs.qgemv, (f32(3, K), i8(K, 2 * N), f32(2 * N)),
         2 * 3 * K * 2 * N, 4 * 3 * K + K * 2 * N + 4 * 2 * N + 4 * 3 * 2 * N),
        ("stencil3x3", tst.stencil3x3, (f32(33, 70), f32(3, 3)),
         18 * 33 * 70, 8 * 33 * 70 + 36),
        ("paged_decode_attention", tpa.paged_decode_attention,
         (f32(3, 4, 64), pool, pool.clone(), tables, index),
         4 * 3 * 4 * 4 * 16 * 64, 2 * 4 * 3 * 4 * 64 + 2 * 3 * 4 * 16 * 2 * 64 * 2 + 4 * 12 + 12),
    ]


@pytest.mark.parametrize("case", _kernel_cases(), ids=lambda c: c[0])
def test_kernel_wrappers_record_and_run_on_meta(case):
    name, fn, args, flops, nbytes = case
    launches = fn.launches
    with Accounting() as cpu:
        plain = fn(*args)
    assert cpu.kernels == {name: {"calls": 1, "flops": flops, "bytes": nbytes}}
    assert cpu.flops == flops and cpu.bytes_accessed == nbytes   # the plain ops uncounted
    meta_args = [a.to(META) if isinstance(a, torch.Tensor) else a for a in args]
    with Accounting() as meta:
        out = fn(*meta_args)
    assert out.device.type == "meta"
    assert (tuple(out.shape), out.dtype) == (tuple(plain.shape), plain.dtype)
    assert meta.kernels == cpu.kernels and meta.flops == flops
    assert fn.launches == launches
    assert fn(*meta_args).shape == plain.shape               # no context: no record


# ------------------------------------------------------------- the CLI

def _dryrun(tmp_path, *argv):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                          "--out", str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_cli_writes_a_full_width_decode_record(tmp_path):
    out = _dryrun(tmp_path, "--arch", "tinyllama-1.1b", "--shape", "decode_32k")
    assert "[dryrun] OK" in out
    rec = json.loads((tmp_path / "tinyllama_1_1b_decode_32k_card_1.json").read_text())
    for key in ("arch", "shape", "mesh", "kind", "quantize", "tag", "status", "n_devices",
                "flops", "bytes_accessed", "collective_bytes", "memory", "model_params",
                "model_params_active", "tokens"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["mesh"] == "card_1" and rec["n_devices"] == 1
    assert rec["collective_bytes"] is None and rec["collectives"] == accounting.COLLECTIVES_NOTE
    for key in ("hlo_bytes", "flops_scan_mode_raw", "collective_counts_hi"):
        assert key not in rec
    cfg = tget("tinyllama_1_1b")
    assert rec["model_params"] == cfg.param_count() == 1_099_956_224
    assert rec["tokens"] == 128
    mem = rec["memory"]
    cache = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv * cfg.hd * 2        # bf16 K and V
    assert mem["argument_size_in_bytes"] > cache
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"]
    assert rec["flops"] > 2 * 128 * 1.0e9 and rec["bytes_accessed"] > cache


def test_cli_skips_long_500k_and_records_pod_layouts(tmp_path, capsys):
    assert TD.main(["--arch", "tinyllama-1.1b", "--shape", "all", "--both-meshes",
                    "--out", str(tmp_path)]) == 0
    assert "SKIP" in capsys.readouterr().out
    rec = json.loads((tmp_path / "tinyllama_1_1b_long_500k_pod_16x16.json").read_text())
    assert rec["status"] == "skipped"
    src = (REPO / "src" / "repro" / "launch" / "dryrun.py").read_text()
    assert f'rec["reason"] = "{rec["reason"]}"' in src      # the reference's reason
    for mesh, n in (("pod_16x16", 256), ("multipod_2x16x16", 512)):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            rec = json.loads((tmp_path / f"tinyllama_1_1b_{shape}_{mesh}.json").read_text())
            assert rec["status"] == "ok" and rec["n_devices"] == n
            assert rec["memory"]["argument_size_in_bytes"] > 0
            for key in ("flops", "bytes_accessed", "collective_bytes"):
                assert rec[key] is None
            assert rec["memory"]["peak_bytes"] is None and rec["reason"]


# ------------------------------------------------ on the card (CUDA only)

def _card_cells():
    return [("train", tget("tinyllama_1_1b"), ShapeCfg("card_train", 128, 8, "train")),
            ("decode", tget("tinyllama_1_1b").replace(quantize="serve"),
             ShapeCfg("card_decode", 2048, 8, "decode")),
            ("prefill", tget("tinyllama_1_1b").replace(quantize="serve"),
             ShapeCfg("card_prefill", 2048, 1, "prefill"))]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _card_cells(), ids=lambda c: c[0])
def test_card_cell_counts_equal_the_meta_count(cell):
    """chip_smoke's dryrun cells: the card's contraction FLOPs equal the
    meta count, qgemm's records its launches, the argument bytes the
    allocator's requested bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    _, cfg, shape = cell
    with tshd.use_mesh(tshd.Mesh((1,), ("data",), META)):
        meta = TD.count_step(cfg, shape)
        fn, args, _ = TD.build_cell(cfg, shape)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
    card_args = _on_card(args, cfg.vocab)
    torch.cuda.synchronize()
    assert (torch.cuda.memory_stats(dev)["requested_bytes.all.current"] - before
            == meta["memory"]["argument_size_in_bytes"])
    launches = tq.qgemm.launches
    with tshd.use_mesh(tshd.Mesh((1,), ("data",), dev)):
        with Accounting() as acc:
            fn(*card_args)
    torch.cuda.synchronize()
    assert acc.flops == meta["flops"]
    assert tq.qgemm.launches - launches == meta["kernels"].get("qgemm", {}).get("calls", 0)


def _on_card(tree, vocab):
    cpu = _on_cpu(tree, vocab, torch.Generator().manual_seed(0))

    def move(t):
        if isinstance(t, dict):
            return {k: move(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return type(t)(*(move(v) for v in t)) if hasattr(t, "_fields") \
                else tuple(move(v) for v in t)
        if isinstance(t, TM.tz.QTensor):
            return TM.tz.QTensor(move(t.q), move(t.scale), t.meta_shape)
        return None if t is None else t.to("cuda")
    return move(cpu)
