"""MoE parity: the port's ``apply_moe`` (repro_torch.models.moe) against
the JAX package's ``apply_moe`` on the same weights (JAX's init carried by
``params_from_numpy``) and the same inputs (a numpy seed), on
moonshot-v1-16b-a3b's and deepseek-moe-16b's smoke configs, in all three
capacity modes: the decode ``active`` mask, row-isolated prefill, and the
shared, dropping capacity (also at capacity_factor 0.5, where tokens are
dropped).

The reference runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (tests/test_torch_model.py
says why), under an Auto-axis mesh. Tolerances:
  * float weights, f32: ``y`` within 1e-5 absolute (the f32 contraction
    order of XLA's dot and torch's bmm differ in the last bits; measured
    5.4e-7);
  * W8A8, bf16 (the served dtype): ``y`` within 1% of its absolute max,
    RMS within 0.1% (a last-bit difference of an expert product moves a
    bf16 rounding, and in the shared experts one int8 activation code;
    measured 0.22% and 0.023%);
  * ``aux`` within 1e-5 relative in both (measured 1.2e-7).
The dispatch decision (experts, queue positions, keep mask) is compared
EXACTLY on the reference's own router scores, the gates within 1e-6.

In process: the top-k tie order against ``jax.lax.top_k``, the combine's
bf16 addition order against the reference's ``_combine_local`` on values
whose sum depends on it, and the idle-mask isolation test of
tests/test_serving.py ported to the port's ``apply_moe``.
"""

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
from repro.models import moe as JMOE
from repro_torch.configs import get_config as tget_config
from repro_torch.core import tensorizer as tz
from repro_torch.launch.serve import quant_predicate
from repro_torch.models import moe as TMOE
from repro_torch.models import init_model as tinit
from repro_torch.testing.params import params_from_numpy

ARCHS = ["moonshot-v1-16b-a3b", "deepseek-moe-16b"]
# mode -> (apply_moe knobs, config fields)
MODES = {
    "active": ({"active": [True, False, True]}, {}),
    "row_isolated": ({"row_isolated": True}, {}),
    "shared": ({}, {}),
    "dropping": ({}, {"capacity_factor": 0.5}),
}
WEIGHTS = {"float32": "float", "bfloat16": "w8a8"}
SHAPE = (3, 8, 64)        # B, S, D at the smoke width


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, jtz.QTensor):
        return types.SimpleNamespace(q=np.asarray(tree.q), scale=np.asarray(tree.scale))
    return np.asarray(tree)


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    if isinstance(tree, jtz.QTensor):
        return jtz.QTensor(tree.q[0], tree.scale[0])
    return tree[0]


def _x():
    return np.random.default_rng(11).standard_normal(SHAPE).astype(np.float32)


def _reference():
    out = {}
    x = _x()
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        for arch in ARCHS:
            cfg0 = get_config(arch).smoke()
            params = init_model(cfg0, jax.random.PRNGKey(1))
            trees = {"float32": _layer0(params["layers"])["moe"],
                     "bfloat16": _layer0(jtz.quantize_params(
                         params, predicate=_quant_predicate)["layers"])["moe"]}
            for dtype, p in trees.items():
                out[arch, dtype, "params"] = _numpy_tree(p)
                for mode, (kw, fields) in MODES.items():
                    cfg = cfg0.replace(dtype=dtype, **fields)
                    kw = {k: jnp.asarray(v) for k, v in kw.items() if k == "active"} | {
                        k: v for k, v in kw.items() if k != "active"}
                    y, aux = jax.jit(lambda p, x, cfg=cfg, kw=kw: JMOE.apply_moe(
                        p, x, cfg, **kw))(p, jnp.asarray(x).astype(dtype))
                    out[arch, dtype, mode] = (np.asarray(y.astype(jnp.float32)),
                                              float(aux))
            # the dispatch decision on the reference's own router scores
            scores = np.asarray(jnp.asarray(x).reshape(-1, cfg0.d_model)
                                @ trees["float32"]["router"], np.float32)
            T = scores.shape[0]
            cap = int(np.ceil(T * cfg0.topk / cfg0.n_experts * 0.5))
            _, (_, local_c, pos, keep, gate) = JMOE._dispatch_local(
                jnp.zeros((T, cfg0.d_model)), jnp.asarray(scores), cfg0.n_experts,
                cfg0.n_experts, 0, cfg0.topk, cap, cfg0)
            out[arch, "dispatch"] = {"scores": scores, "capacity": cap,
                                     "ids": np.asarray(local_c), "pos": np.asarray(pos),
                                     "keep": np.asarray(keep), "gate": np.asarray(gate)}
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, __file__, str(out)], env=env, check=True, timeout=600)
    with open(out, "rb") as f:
        return pickle.load(f)


def _port(reference, arch, dtype, mode):
    kw, fields = MODES[mode]
    cfg = tget_config(arch).smoke().replace(dtype=dtype, **fields)
    p = params_from_numpy(reference[arch, dtype, "params"], device="cpu")
    if "active" in kw:
        kw = dict(kw, active=torch.tensor(kw["active"]))
    x = torch.from_numpy(_x()).to(getattr(torch, dtype))
    return TMOE.apply_moe(p, x, cfg, **kw), cfg, p, x


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", list(WEIGHTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(reference, arch, dtype, mode):
    (y, aux), cfg, p, x = _port(reference, arch, dtype, mode)
    ref_y, ref_aux = reference[arch, dtype, mode]
    assert y.dtype == getattr(torch, dtype) and y.shape == SHAPE
    got = y.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref_y, rtol=0, atol=1e-5)
    else:
        scale = np.abs(ref_y).max()
        d = np.abs(got - ref_y)
        assert d.max() <= 0.01 * scale, (d.max(), scale)
        assert np.sqrt((d ** 2).mean()) <= 0.001 * scale
    np.testing.assert_allclose(float(aux), ref_aux, rtol=1e-5)
    if mode == "dropping":
        # the case has teeth: slots were dropped
        T = SHAPE[0] * SHAPE[1]
        scores = TMOE.router_scores(p["router"], x.reshape(T, -1))
        cap = max(cfg.topk, int(np.ceil(T * cfg.topk / cfg.n_experts * cfg.capacity_factor)))
        _, _, keep = TMOE.dispatch(scores[None], cfg.topk, cap)
        assert int(keep.sum()) < T * cfg.topk


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_decision_is_the_references(reference, arch):
    """Experts, keep mask and gates of the dropping dispatch, from the same
    router scores, against the reference's ``_dispatch_local``."""
    ref = reference[arch, "dispatch"]
    cfg = tget_config(arch).smoke()
    T = ref["scores"].shape[0]
    ids, gate, keep = TMOE.dispatch(torch.from_numpy(ref["scores"])[None], cfg.topk,
                                    ref["capacity"])
    np.testing.assert_array_equal(ids.reshape(-1).numpy(), ref["ids"])
    np.testing.assert_array_equal(keep.reshape(-1).numpy(), ref["keep"])
    np.testing.assert_allclose(gate.reshape(-1).numpy(), ref["gate"], rtol=0, atol=1e-6)
    assert 0 < int(keep.sum()) < T * cfg.topk


def test_top_k_tie_order_matches_jax():
    """Equal scores: the lower expert index first, as ``jax.lax.top_k``."""
    scores = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.5],
                       [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                       [-1.0, 5.0, -1.0, 5.0, 0.0, -1.0],
                       [0.0, -0.0, 0.0, 1.0, 1.0, 0.0]], np.float32)
    for k in (1, 2, 3, 4, 6):
        jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
        tv, ti = TMOE.top_k(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_combine_order_matches_reference():
    """Each token's k contributions are added in slot order in bf16, the
    reference's scatter-add order: with contributions (1, 2^-8, 2^-8) the
    sum is 1 in that order and 1 + 2^-7 in any other grouping."""
    T, k, D = 4, 3, 8
    vals = np.zeros((T, k, D), np.float32)
    vals[:, 0], vals[:, 1], vals[:, 2] = 1.0, 2.0 ** -8, 2.0 ** -8
    vals[1] = vals[1, ::-1]                      # the other order: 1 + 2^-7
    vals[2, :, ::2] *= -3.0
    keep = np.ones((T, k), bool)
    keep[3, 1] = False                           # a dropped slot adds nothing
    gate = np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [0.5, 0.25, 0.25],
                     [1.0, 1.0, 1.0]], np.float32)
    # reference: slot (t, j) occupies expert j, queue position t
    y_buf = jnp.asarray(np.transpose(vals, (1, 0, 2))).astype(jnp.bfloat16)
    meta = (jnp.repeat(jnp.arange(T), k), jnp.tile(jnp.arange(k), T),
            jnp.repeat(jnp.arange(T), k), jnp.asarray(keep.reshape(-1)),
            jnp.asarray(gate.reshape(-1)))
    ref = np.asarray(JMOE._combine_local(y_buf, meta, T, D).astype(jnp.float32))
    got = TMOE.combine(torch.from_numpy(vals).to(torch.bfloat16), torch.from_numpy(gate),
                       torch.from_numpy(keep)).float().numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] == 1.0 and got[1, 0] == 1.0 + 2.0 ** -7


def test_moe_idle_mask_restores_isolation():
    """tests/test_serving.py::test_moe_idle_mask_restores_isolation on the
    port: four identical tokens pick the same experts, so the shared
    capacity ceil(4 * topk / E * cf) = 3 drops the last row's slots; masked
    idle, its batchmates leave it routing exactly as the first row alone,
    and the dropless decode capacity keeps it so with all four active."""
    cfg = tget_config("moonshot-v1-16b-a3b").smoke()
    params = tinit(cfg, torch.Generator().manual_seed(1))
    p = {k: (v[0] if not isinstance(v, dict) else {n: t[0] for n, t in v.items()})
         for k, v in params["layers"]["moe"].items()}
    x = torch.randn((1, 1, cfg.d_model), generator=torch.Generator().manual_seed(3))
    x4 = x.expand(4, 1, cfg.d_model).to(torch.bfloat16)
    y_shared, _ = TMOE.apply_moe(p, x4, cfg)
    y_masked, _ = TMOE.apply_moe(p, x4, cfg, active=torch.tensor([False, False, False, True]))
    y_first, _ = TMOE.apply_moe(p, x4, cfg, active=torch.tensor([True, False, False, False]))
    assert torch.equal(y_masked[3], y_first[0])
    assert not torch.equal(y_shared[3], y_masked[3])
    y_active, _ = TMOE.apply_moe(p, x4, cfg, active=torch.ones(4, dtype=torch.bool))
    assert torch.equal(y_active[3], y_first[0])


@pytest.mark.parametrize("n_tokens", [1, 5, 40, 100])
def test_expert_rows_keep_their_bits_at_any_batch(n_tokens):
    """A token's MoE output is bitwise the same alone and among others, in
    every dropless mode: the expert products run at one call shape (E,
    EXPERT_ROWS, D) and the router at ROUTER_ROWS rows, whatever T, so also
    past EXPERT_ROWS tokens (several passes) and past ROUTER_ROWS."""
    cfg = tget_config("deepseek-moe-16b").smoke().replace(quantize="serve")
    params = tz.quantize_params(tinit(cfg, torch.Generator().manual_seed(4)),
                                predicate=quant_predicate)
    p = {k: v[0] if not isinstance(v, dict) else {n: t[0] for n, t in v.items()}
         for k, v in params["layers"]["moe"].items()}
    x = torch.randn((n_tokens, 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(n_tokens)).to(torch.bfloat16)
    batched, _ = TMOE.apply_moe(p, x, cfg, active=torch.ones(n_tokens, dtype=torch.bool))
    rows, _ = TMOE.apply_moe(p, x.reshape(1, n_tokens, -1), cfg, row_isolated=True)
    for i in sorted({0, n_tokens // 2, n_tokens - 1}):
        alone, _ = TMOE.apply_moe(p, x[i:i + 1], cfg, active=torch.ones(1, dtype=torch.bool))
        assert torch.equal(batched[i], alone[0])
        assert torch.equal(rows[0, i], alone[0, 0])


def test_dequantized_experts_are_the_references_rounding():
    """``q * scale`` in f32, then one rounding to bf16: the reference's
    ``QTensor.dequantize().astype(bf16)``, computed in one pass."""
    w = torch.randn((4, 64, 128), generator=torch.Generator().manual_seed(2))
    qt = tz.quantize(w, axis=-2)
    want = (qt.q.to(torch.float32) * qt.scale).to(torch.bfloat16)
    assert torch.equal(TMOE._dequant(qt, torch.bfloat16), want)
    ref = jtz.QTensor(jnp.asarray(qt.q.numpy()), jnp.asarray(qt.scale.numpy()))
    np.testing.assert_array_equal(
        want.float().numpy(), np.asarray(ref.dequantize().astype(jnp.bfloat16)
                                         .astype(jnp.float32)))


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(_reference(), f)
