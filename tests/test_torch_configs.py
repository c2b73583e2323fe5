"""The ported configs and their layer pieces against the JAX package: the
MoE family (moonshot-v1-16b-a3b, deepseek-moe-16b) and the dense family's
other configs (qwen3-14b: qk_norm; starcoder2-15b: LayerNorm and GeLU;
granite-20b: MQA), at their smoke sizes.

  * configs — every field equal to the reference's (zamba2-7b's,
    xlstm-125m's, seamless-m4t-medium's and qwen2-vl-2b's too); the CLI
    serves xlstm-125m, and it and the Engine refuse the embeds-input
    seamless-m4t-medium and qwen2-vl-2b with the reference's messages;
  * layer pieces — ``rms_head_norm``, LayerNorm, GeLU and the GeLU MLP;
  * the model — the fused prefill-with-cache (logits and K/V) on each new
    arch, with W8A8 weights carried from the reference by
    ``params_from_numpy``, and ``forward`` (the embedding forward; for MoE
    the shared, dropping capacity) against the reference's forward in f32;
    greedy first tokens equal wherever the reference's top-2 margin is
    clear. The reference's forward attends by its training attention,
    whose bf16 rounding the port does not carry (the port's embedding
    forward attends as its prefill does, tests/test_torch_sampling.py), so
    in bf16 the two are different functions and the forward is compared in
    f32 only;
  * the streamed build bitwise the whole-model init, then quantized;
  * ``params_from_numpy`` on a MoE tree; the serve quantization predicate
    against the reference's on every leaf path;
  * the Engine and the CLI serve each new arch on the CPU.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (tests/test_torch_model.py
says why), under an Auto-axis mesh. Tolerances: in f32, 1e-5 absolute on
the layer pieces and 2e-5 on logits and K/V (f32 sums in another order;
measured below 5e-6); in bf16 (W8A8, the served dtype) the bf16 layer pieces
bitwise where op by op (GeLU) and within one bf16 ulp of the value
elsewhere, and logits and K/V within 3% of the reference's absolute max
with the RMS within 0.5% (tests/test_torch_model.py's bound: a last-bit
difference moves a bf16 rounding and then an int8 activation code).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config
from repro.core import tensorizer as jtz
from repro.distributed import sharding as shd
from repro.launch.serve import _quant_predicate
from repro.models import init_model
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import serve as JSV
from repro_torch.configs import ARCH_IDS, get_config as tget_config
from repro_torch.core import tensorizer as tz
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import quant_predicate
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import serve as TSV
from repro_torch.serving import Engine, EngineConfig
from repro_torch.testing.params import params_from_numpy

import _torch_parity as P

NEW_ARCHS = ["moonshot-v1-16b-a3b", "deepseek-moe-16b", "qwen3-14b", "starcoder2-15b",
             "granite-20b"]
UNPORTED = ["xlstm-125m", "seamless-m4t-medium", "qwen2-vl-2b"]
DTYPES = ["float32", "bfloat16"]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}
TOKENS = (3, 16)
PUBLISHED_BLOCK = {"first_k_dense": 1, "dense_d_ff": 10944, "norm_topk_prob": False}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, jtz.QTensor):
        return types.SimpleNamespace(q=np.asarray(tree.q), scale=np.asarray(tree.scale))
    return np.asarray(tree)


def _layer_inputs():
    rng = np.random.default_rng(3)
    return {"x": (rng.standard_normal((4, 5, 64)) * 3).astype(np.float32),
            "heads": (rng.standard_normal((4, 5, 2, 16)) * 2).astype(np.float32),
            "scale": rng.uniform(0.5, 1.5, (64,)).astype(np.float32),
            "bias": rng.standard_normal((64,)).astype(np.float32),
            "hscale": rng.uniform(0.5, 1.5, (16,)).astype(np.float32)}


def _reference():
    out = {}
    li = _layer_inputs()
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        star = get_config("starcoder2-15b").smoke()
        for dt in DTYPES:
            x = jnp.asarray(li["x"]).astype(dt)
            out["layernorm", dt] = np.asarray(jax.jit(lambda x: JL.apply_norm(
                {"scale": jnp.asarray(li["scale"]), "bias": jnp.asarray(li["bias"])}, x,
                star))(x).astype(jnp.float32))
            out["gelu", dt] = np.asarray(jax.jit(jax.nn.gelu)(x).astype(jnp.float32))
            out["head_norm", dt] = np.asarray(jax.jit(lambda h: JL.rms_head_norm(
                h, jnp.asarray(li["hscale"])))(jnp.asarray(li["heads"]).astype(dt))
                .astype(jnp.float32))
        tokens = np.random.default_rng(5).integers(0, 256, TOKENS).astype(np.int32)
        out["tokens"] = tokens
        for arch in NEW_ARCHS:
            for dt in DTYPES:
                cfg = get_config(arch).smoke().replace(quantize="serve", dtype=dt)
                params = jtz.quantize_params(init_model(cfg, jax.random.PRNGKey(0)),
                                             predicate=_quant_predicate)
                if dt == "float32":
                    out[arch, "params"] = _numpy_tree(params)
                logits, kv = jax.jit(lambda p, t, cfg=cfg: JSV.prefill_with_cache(
                    p, cfg, {"tokens": t}))(params, jnp.asarray(tokens))
                flog, _ = jax.jit(lambda p, t, cfg=cfg: JM.forward(
                    p, cfg, {"tokens": t}))(params, jnp.asarray(tokens))
                out[arch, dt] = {
                    "logits": np.asarray(logits.astype(jnp.float32)),
                    "kv": {k: np.asarray(v.astype(jnp.float32)) for k, v in kv.items()},
                    "forward": np.asarray(flog.astype(jnp.float32))}
        # the GeLU MLP on starcoder2's W8A8 layer-0 weights
        cfg = star.replace(quantize="serve", dtype="bfloat16")
        p = out["starcoder2-15b", "params"]["layers"]["mlp"]
        mlp = {k: jtz.QTensor(jnp.asarray(v.q[0]), jnp.asarray(v.scale[0]))
               for k, v in p.items()}
        out["gelu_mlp"] = np.asarray(jax.jit(lambda m, x: JL.apply_mlp(m, x, cfg))(
            mlp, jnp.asarray(li["x"]).astype(jnp.bfloat16)).astype(jnp.float32))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("configs") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, __file__, str(out)], env=env, check=True, timeout=900)
    with open(out, "rb") as f:
        return pickle.load(f)


def _close(out, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
        return
    scale = np.abs(ref).max()
    d = np.abs(out - ref)
    assert d.max() <= 0.03 * scale, (d.max(), scale)
    assert np.sqrt((d ** 2).mean()) <= 0.005 * scale, (np.sqrt((d ** 2).mean()), scale)


def _within_one_ulp(got, ref):
    """bf16 values at most one bf16 ulp of the reference value apart."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(got - ref) <= ulp).all(), np.abs(got - ref).max()


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", NEW_ARCHS + ["tinyllama-1.1b", "zamba2-7b"] + UNPORTED)
def test_config_fields_equal_the_references(arch):
    ref = dataclasses.asdict(get_config(arch))
    got = P.jax_fields(tget_config(arch))
    assert got == {k: ref[k] for k in got}
    assert set(ref) - set(got) == set()
    assert arch.replace("-", "_").replace(".", "_") in ARCH_IDS
    # the port's own fields: deepseek-moe-16b's published block (a leading
    # dense layer, unrenormalised gates), the JAX package's block elsewhere
    own = {k: getattr(tget_config(arch), k) for k in P.JAX_BLOCK}
    assert own == (PUBLISHED_BLOCK if arch == "deepseek-moe-16b" else P.JAX_BLOCK)


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_configs_name_item_11(arch, capsys):
    """The last three configs, once refused, now build; the CLI and the
    Engine serve xlstm-125m (token input, the recurrent store) and refuse
    the embeds-input seamless-m4t-medium and qwen2-vl-2b with the
    reference's messages."""
    cfg = tget_config(arch)
    assert P.jax_fields(cfg) == dataclasses.asdict(get_config(arch))
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "1",
            "--prompt-len", "4", "--gen", "2", "--slots", "1"]
    if cfg.input_mode == "tokens":
        reqs, stats = tserve.run(argv)
        assert [len(r.tokens) for r in reqs] == [2]
        assert stats["cache"]["backend"] == "recurrent"
        return
    with pytest.raises(SystemExit):
        tserve.run(argv)
    assert (f"--arch {arch} (family={cfg.family}, input_mode=embeds) is not servable "
            f"yet" in capsys.readouterr().err)
    with pytest.raises(ValueError, match=f"serving engine supports token-input "
                                         f"dense/moe/ssm/hybrid archs, got "
                                         f"family={cfg.family} input_mode=embeds"):
        Engine(cfg.smoke(), {}, EngineConfig(max_slots=1, max_seq_len=16), device="cpu")


# ----------------------------------------------------------- layer pieces

@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_pieces_match_jax(reference, dtype):
    li = _layer_inputs()
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(li["x"]).to(tdt)
    star = tget_config("starcoder2-15b").smoke()
    ln = TL.apply_norm({"scale": torch.from_numpy(li["scale"]),
                        "bias": torch.from_numpy(li["bias"])}, x, star)
    hn = TL.rms_head_norm(torch.from_numpy(li["heads"]).to(tdt),
                          torch.from_numpy(li["hscale"]))
    g = TL.gelu(x)
    for name, got in (("layernorm", ln), ("head_norm", hn), ("gelu", g)):
        assert got.dtype == tdt
        got, ref = got.float().numpy(), reference[name, dtype]
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=name)
        elif name == "gelu":
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            _within_one_ulp(got, ref)


def test_gelu_mlp_matches_jax(reference):
    """starcoder2's two-matrix GeLU MLP (no ``wg``) on its W8A8 layer-0
    weights, bf16."""
    cfg = tget_config("starcoder2-15b").smoke().replace(quantize="serve", dtype="bfloat16")
    p = params_from_numpy(reference["starcoder2-15b", "params"], device="cpu")
    mlp = TM.layer_params(p["layers"], 0)["mlp"]
    assert set(mlp) == {"wi", "wo"}
    x = torch.from_numpy(_layer_inputs()["x"]).to(torch.bfloat16)
    _close(TL.apply_mlp(mlp, x, cfg).float().numpy(), reference["gelu_mlp"], "bfloat16")


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_and_prefill_match_jax(reference, arch, dtype):
    cfg = P.jax_block(tget_config(arch).smoke()).replace(quantize="serve", dtype=dtype)
    params = params_from_numpy(reference[arch, "params"], device="cpu")
    ref = reference[arch, dtype]
    tokens = torch.from_numpy(reference["tokens"])
    logits, kv = TSV.prefill_with_cache(params, cfg, tokens)
    _close(logits.float().numpy(), ref["logits"], dtype)
    assert set(kv) == set(ref["kv"])
    for name in kv:
        assert kv[name].shape == ref["kv"][name].shape
        _close(kv[name].float().numpy(), ref["kv"][name], dtype)
    flog, hidden = TM.forward(params, cfg, tokens, return_hidden=True)
    assert hidden.shape == tokens.shape + (cfg.d_model,)
    pairs = [(logits, ref["logits"])]
    if dtype == "float32":
        _close(flog.float().numpy(), ref["forward"], dtype)
        pairs.append((flog, ref["forward"]))
    # greedy tokens wherever the reference's top-2 margin is clear
    for got, want in pairs:
        top2 = np.sort(want, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > LOGIT_TOL[dtype]
        assert clear.sum() >= want.shape[0] * want.shape[1] // 2
        np.testing.assert_array_equal(got.float().numpy().argmax(-1)[clear],
                                      want.argmax(-1)[clear])


# -------------------------------------------- weights: build, carry, quantize

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b", "starcoder2-15b",
                                  "qwen3-14b"])
def test_streamed_build_is_bitwise_init_then_quantize(arch):
    cfg = tget_config(arch).smoke().replace(quantize="serve")
    whole = tz.quantize_params(TM.init_model(cfg, torch.Generator().manual_seed(3)),
                               predicate=quant_predicate)
    streamed = TM.init_model_quantized(cfg, torch.Generator().manual_seed(3),
                                       quant_predicate)

    def same(a, b, path=()):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], path + (k,))
        elif isinstance(a, tz.QTensor):
            assert isinstance(b, tz.QTensor), path
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale), path
            assert b.meta_shape == tuple(b.q.shape), path
        else:
            assert not isinstance(b, tz.QTensor) and torch.equal(a, b), path
    same(whole, streamed)


def test_params_from_numpy_carries_a_moe_tree(reference):
    cfg = P.jax_block(tget_config("deepseek-moe-16b").smoke())
    p = params_from_numpy(reference["deepseek-moe-16b", "params"], device="cpu")
    moe = p["layers"]["moe"]
    L, E, D, F = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    assert isinstance(moe["router"], torch.Tensor) and moe["router"].shape == (L, D, E)
    for name, shape in (("wi", (L, E, D, F)), ("wg", (L, E, D, F)), ("wo", (L, E, F, D))):
        assert isinstance(moe[name], tz.QTensor), name
        assert moe[name].q.shape == shape and moe[name].q.dtype == torch.int8
        assert moe[name].scale.shape == shape[:2] + (1, shape[3])
    shared = moe["shared"]
    assert set(shared) == {"wi", "wg", "wo"}
    assert shared["wi"].q.shape == (L, D, cfg.n_shared_experts * F)
    # a layer's slice keeps the (E, ...) leading axis of the expert QTensors
    lp = TM.layer_params(p["layers"], 1)["moe"]
    assert lp["wi"].q.shape == (E, D, F) and torch.equal(lp["wi"].q, moe["wi"].q[1])
    # and the carried tree serves: one decode step of a MoE engine
    eng = Engine(cfg.replace(quantize="serve"), p, EngineConfig(max_slots=2, max_seq_len=32),
                 device="cpu")
    req = eng.submit(np.arange(1, 6, dtype=np.int32), 3)
    eng.run_until_complete()
    eng.close()
    assert len(req.tokens) == 3


@pytest.mark.parametrize("arch", NEW_ARCHS + ["tinyllama-1.1b", "zamba2-7b"])
def test_quant_predicate_agrees_with_the_references(arch):
    """The port's serve predicate against the reference's on every leaf
    path of the arch's tree, and on the reference's skip set."""
    cfg = get_config(arch).smoke()
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        params = jax.eval_shape(lambda: init_model(cfg, jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert leaves
    for path, leaf in leaves:
        keys = tuple(k.key for k in path)
        assert quant_predicate(keys, leaf) == _quant_predicate(path, leaf), keys
    for name in ("conv_w", "wup", "wdown", "rz", "ri", "rf", "ro", "wq", "lm_head",
                 "router", "scale"):
        path = (jax.tree_util.DictKey("layers"), jax.tree_util.DictKey(name))
        assert quant_predicate(("layers", name), None) == _quant_predicate(path, None), name


# ------------------------------------------------------ the Engine and the CLI

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-14b", "starcoder2-15b",
                                  "granite-20b"])
def test_cli_serves_the_new_archs(arch, capsys):
    reqs, stats = tserve.run(["--arch", arch, "--smoke", "--device", "cpu", "--quantize",
                              "serve", "--cache-backend", "paged", "--paged-native",
                              "--paged-kernel", "--requests", "3", "--prompt-len", "8",
                              "--gen", "8", "--slots", "2", "--stagger-steps", "1"])
    assert all(r.done and len(r.tokens) == 8 for r in reqs)
    assert stats["completed"] == 3
    out = capsys.readouterr().out
    assert "Tensorizer W8A8" in out and "sustained" in out


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference(), f)
