"""The harness's mixture-of-experts configuration on the CPU: the keys it
reads and the ones it refuses, the port config contract for the two
published departures (``sut.differences`` against a stand-in config, so
that a change to the port's config edits no test), the tree handed to the
port, and the plain MoE reference against a per-token loop."""

import dataclasses
import types

import pytest
import torch

import pbtest

from portbench import sut
from portbench import weights as W
from portbench.model import Model
from portbench.reference import decoder as D
from portbench.reference import moe as RM

PUBLISHED = pbtest.fixture("published-deepseek-moe-16b")


def test_the_published_keys_load():
    m = Model.from_config(PUBLISHED)
    assert (m.family, m.n_layers, m.d_model, m.n_heads, m.n_kv, m.head_dim, m.vocab) == (
        "moe", 28, 2048, 16, 16, 128, 102400)
    assert (m.n_experts, m.n_shared, m.topk, m.expert_ff) == (64, 2, 6, 1408)
    assert (m.first_k_dense, m.d_ff, m.norm_topk_prob, m.n_moe_layers) == (1, 10944, False, 27)
    dense, moe = W.layer_shapes(m, 0), W.layer_shapes(m, 1)
    assert dense["mlp.wi"] == ((2048, 10944), 2048) and not any(k.startswith("moe.") for k in dense)
    assert moe["moe.router"] == ((2048, 64), 2048)
    assert moe["moe.wo"] == ((64, 1408, 2048), 1408)
    assert moe["moe.shared.wi"] == ((2048, 2816), 2048)
    assert not any(k.startswith("mlp.") for k in moe)


def test_the_port_without_the_published_fields_is_refused_by_name():
    with pytest.raises(ValueError) as err:
        sut.port_config(PUBLISHED)
    for field in ("first_k_dense", "dense_d_ff", "norm_topk_prob"):
        assert field in str(err.value)


@pytest.mark.parametrize("key, value", [
    ("kv_lora_rank", 512), ("q_lora_rank", 1536), ("topk_method", "noaux_tc"),
    ("n_group", 8), ("topk_group", 4), ("routed_scaling_factor", 2.5),
    ("scoring_func", "sigmoid"), ("moe_layer_freq", 2)])
def test_an_unmodelled_key_is_refused_by_name(key, value):
    with pytest.raises(ValueError, match=key):
        Model.from_config(dict(PUBLISHED, **{key: value}))


def test_the_modelled_values_of_those_keys_load():
    same = dict(PUBLISHED, kv_lora_rank=None, q_lora_rank=None, topk_method="greedy",
                n_group=1, topk_group=1, routed_scaling_factor=1.0)
    assert Model.from_config(same) == Model.from_config(PUBLISHED)


def _stand_in(c, **fields):
    """A port config for file ``c`` as the port's present MoE config has
    it (no leading dense layer, no gate field), plus ``fields``."""
    m = Model.from_config(c)
    return types.SimpleNamespace(**{**dict(
        family=m.family, n_layers=m.n_layers, d_model=m.d_model, n_heads=m.n_heads,
        n_kv=m.n_kv, hd=m.head_dim, vocab=m.vocab, qk_norm=m.qk_norm,
        rope_theta=m.rope_theta, rope_kind="rope", act="swiglu", norm="rmsnorm",
        input_mode="tokens", tie_embeddings=False, dtype="bfloat16",
        kv_cache_dtype="bfloat16", d_ff=m.expert_ff, n_experts=m.n_experts,
        n_shared_experts=m.n_shared, topk=m.topk), **fields})


SMOKE = pbtest.fixture("moe-smoke")
SMOKE_PUBLISHED = dict(SMOKE, first_k_dense_replace=1, norm_topk_prob=False)


@pytest.mark.parametrize("c, fields, differing", [
    (SMOKE, {}, set()),
    (SMOKE_PUBLISHED, {}, {"first_k_dense", "dense_d_ff", "norm_topk_prob"}),
    (SMOKE_PUBLISHED, dict(first_k_dense=1, dense_d_ff=128, norm_topk_prob=False), set()),
    (SMOKE_PUBLISHED, dict(first_k_dense=2, dense_d_ff=128, norm_topk_prob=False),
     {"first_k_dense"}),
    (SMOKE, dict(first_k_dense=0, norm_topk_prob=False), {"norm_topk_prob"}),
    (SMOKE, dict(n_experts=8, topk=1), {"n_experts", "topk"}),
], ids=["present", "published_absent", "published_present", "wrong_k", "wrong_gates",
        "wrong_routing"])
def test_the_port_config_contract(c, fields, differing):
    m = Model.from_config(c)
    assert set(sut.differences(_stand_in(c, **fields), m, c)) == differing


def test_a_dense_file_fixes_no_expert_field():
    c = pbtest.smoke_cell(pbtest.CELLS[0]).config
    exp = sut._expected(Model.from_config(c), c)
    assert not {"n_experts", "topk", "first_k_dense", "norm_topk_prob"} & set(exp)


def test_the_tree_handed_to_the_port():
    from repro_torch.core.tensorizer import QTensor
    m = Model.from_config(SMOKE_PUBLISHED)
    m = dataclasses.replace(m, n_layers=3)
    cpu = torch.device("cpu")
    params = sut.port_params(m, types.SimpleNamespace(vocab_padded=m.vocab), 5, cpu)
    dense, moe = params["dense_layers"], params["layers"]
    assert set(dense) == {"ln1", "attn", "ln2", "mlp"} and set(moe) == {"ln1", "attn", "ln2", "moe"}
    assert set(moe["moe"]) == {"router", "wi", "wg", "wo", "shared"}
    assert not isinstance(moe["moe"]["router"], QTensor)            # the serve path's float router
    assert moe["moe"]["router"].shape == (2, 64, 4)
    wi = moe["moe"]["wi"]
    assert wi.q.shape == (2, 4, 64, 128) and wi.scale.shape == (2, 4, 1, 128)
    assert dense["mlp"]["wi"].q.shape == (1, 64, 128)
    # layer 2 is the second stacked MoE layer, drawn as layer 2
    codes, _ = D.quantize_weight(W.layer(m, 5, 2, cpu)["moe.wo"], 8)
    assert torch.equal(moe["moe"]["wo"].q[1].to(torch.float32), codes)
    assert torch.equal(moe["moe"]["router"][1], W.layer(m, 5, 2, cpu)["moe.router"])


def _loop_block(m, x, leaves, bits):
    """The MoE block token by token: the softmax over all experts, the k
    largest (the lower index first on equal probabilities), the gates
    (renormalised where the model says so), each expert's SwiGLU on its
    dequantized weights, the shared MLP."""
    q = {n: D.quantize_weight(leaves[f"moe.{n}"], bits) for n in ("wi", "wg", "wo")}
    shared = {k: D.quantize_weight(v, bits) for k, v in leaves.items() if "shared" in k}
    rows = []
    for t in range(x.shape[0]):
        xt = x[t]
        p = torch.softmax(xt @ leaves["moe.router"], dim=-1).tolist()
        top = sorted(range(m.n_experts), key=lambda e: (-p[e], e))[: m.topk]
        gates = [p[e] for e in top]
        if m.norm_topk_prob:
            gates = [g / sum(gates) for g in gates]
        y = torch.zeros_like(xt)
        for e, g in zip(top, gates):
            wi, wg, wo = (q[n][0][e] * q[n][1][e] for n in ("wi", "wg", "wo"))
            y = y + g * ((torch.nn.functional.silu(xt @ wi) * (xt @ wg)) @ wo)
        if shared:
            y = y + D._mlp(xt[None], shared, "moe.shared.")[0]
        rows.append(y)
    return torch.stack(rows)


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("bits", [8, 4])
def test_the_reference_block_is_the_per_token_loop(norm, n_shared, bits):
    m = dataclasses.replace(Model.from_config(SMOKE), norm_topk_prob=norm, n_shared=n_shared,
                            n_experts=6, topk=3)
    cpu = torch.device("cpu")
    leaves = W.layer(m, 17, 0, cpu)
    x = torch.randn((40, m.d_model), generator=torch.Generator().manual_seed(3))
    q = D._quantized({k: v for k, v in leaves.items() if k.startswith("moe.shared.")}, bits)
    got = RM.moe_block(m, x, leaves, q, bits)
    want = _loop_block(m, x, leaves, bits)
    # the same products summed in another order, in f32
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), (got - want).abs().max()


def test_equal_probabilities_take_the_lower_expert():
    m = dataclasses.replace(Model.from_config(SMOKE), n_experts=6, topk=3)
    gen = torch.Generator().manual_seed(4)
    # integer logits, exact in f32: ties are frequent
    x = torch.randint(-2, 3, (64, m.d_model), generator=gen).to(torch.float32)
    router = torch.randint(-1, 2, (m.d_model, 6), generator=gen).to(torch.float32)
    router[:, 4] = router[:, 1]
    experts, gates = RM.route(m, x, router)
    for t in range(x.shape[0]):
        logits = (x[t] @ router).tolist()
        want = sorted(range(6), key=lambda e: (-logits[e], e))[:3]
        assert experts[t].tolist() == want
    assert torch.allclose(gates.sum(dim=-1), torch.ones(64))
