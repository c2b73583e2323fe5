"""deepseek-moe-16b's published block on the port (a leading dense layer,
then MoE layers whose gates are the softmax over all experts, not
renormalised), at reduced sizes on the CPU, held to the benchmark's plain
reference (portbench/reference/moe.py: f32 with TF32 off, one layer at a
time, no capacity) on the same seeded weights (portbench/weights.py; the
port quantizes them on its own path, portbench/sut.py):

  * the full-sequence forward (the fused prefill's K/V path);
  * fused prefill, then paged decode through the Engine (the kernel
    route, its plain version here);
  * chunked prefill;
  * the speculative verify window (the target as its own draft, every
    proposal accepted).

Each is read as the benchmark reads a served run (portbench/check.py): at
each position, the reference's best logit minus its logit of the port's
greedy token, compared on the mean and on the 90th percentile. The port's
bf16 path against the f32 reference sits near 0 on both; the reference
read with the port's former block, renormalised gates or no dense layer,
lands well above the limits on the port's tokens. Also: ``dispatch``'s
unrenormalised gates are the softmax over all experts at the chosen ids,
and the parameter count and the dry run's tree take the dense layer at
``dense_d_ff``.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import check, spec, sut  # noqa: E402
from portbench.model import Model  # noqa: E402
from portbench.reference import moe as RM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import steps as ST  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

PUBLISHED = spec.load_json(ROOT / "portbench" / "configs" / "deepseek-moe-16b.json")
# the published file at ArchConfig.smoke()'s widths, 1 dense + 2 MoE layers
SMALL = dict(PUBLISHED, smoke=True, num_hidden_layers=3, hidden_size=64,
             num_attention_heads=4, num_key_value_heads=4, vocab_size=256,
             intermediate_size=128, moe_intermediate_size=128, n_routed_experts=4,
             num_experts_per_tok=2)
M = Model.from_config(SMALL)
CFG = get_config("deepseek-moe-16b").smoke().replace(n_layers=3, quantize="serve")
SEED = 3_000_000_019
CPU = torch.device("cpu")
# The port computes in bf16 with W8A8 projections and bf16 experts; the
# reference in f32 from the same int8 codes. At these sizes the port's
# greedy token is the reference's best at nearly every served position:
# mean gap 0.002, 90th percentile 0, widest 0.07 on each engine path. Read
# with renormalised gates the same tokens give a mean of 0.024 and a 90th
# percentile of 0.11, without the dense layer 2.1 and 3.4. A token whose
# experts score within rounding of a tie can take other experts, which
# moves a few gaps, so the widest is not compared.
LIMITS = {"mean_gap": 0.05, "p90_gap": 0.05}
DEPARTURES = {"renormalised_gates": {"norm_topk_prob": True},
              "no_dense_layer": {"first_k_dense": 0}}


@pytest.fixture(scope="module")
def params():
    return sut.port_params(M, CFG, SEED, CPU)


def _gaps(samples, m=M):
    """The served-token gaps of (prompt, tokens) pairs, read by the
    reference with the sizes ``m``."""
    return check.served_gaps(check.reference_logits(SMALL, m, SEED, samples, CPU), samples)


def _within(gaps):
    return {k: check.READINGS[k](gaps) <= v for k, v in LIMITS.items()}


def _holds(samples):
    """The port's tokens pass the limits under the published reference and
    fail them under each departure."""
    assert all(_within(_gaps(samples)).values()), check.READINGS["p90_gap"](_gaps(samples))
    for name, fields in DEPARTURES.items():
        gaps = _gaps(samples, dataclasses.replace(M, **fields))
        assert not all(_within(gaps).values()), (name, gaps.mean())


def test_the_port_config_is_the_published_files():
    assert sut.differences(CFG, M, SMALL) == {}
    assert (CFG.first_k_dense, CFG.dense_d_ff, CFG.norm_topk_prob) == (1, 128, False)
    full = get_config("deepseek-moe-16b").replace(quantize="serve", rope_theta=10000.0)
    assert sut.differences(full, Model.from_config(PUBLISHED), PUBLISHED) == {}


def test_the_tree_has_the_dense_layer_apart(params):
    assert set(params["dense_layers"]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(params["layers"]) == {"ln1", "attn", "ln2", "moe"}
    assert params["dense_layers"]["mlp"]["wi"].q.shape == (1, 64, 128)
    assert params["layers"]["moe"]["wi"].q.shape == (2, 4, 64, 128)
    init = TM.init_model(CFG, torch.Generator().manual_seed(0))
    assert set(init) >= {"dense_layers", "layers"}
    assert init["dense_layers"]["mlp"]["wg"].shape == (1, 64, CFG.dense_d_ff)


def test_the_forward_holds_to_the_reference(params):
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, M.vocab, (3, 32)).astype(np.int32))
    logits, kv = TM.forward(params, CFG, tokens)
    assert kv["k"].shape[0] == CFG.n_layers
    picks = logits.float().argmax(-1)

    def gaps(m):
        ref = RM.logits(m, SEED, [row.long() for row in tokens], [32] * 3, 8, CPU)
        return np.concatenate([(r.max(-1).values - r.gather(1, pk[:, None])[:, 0]).numpy()
                               for r, pk in zip(ref, picks)]).astype(np.float64)
    assert all(_within(gaps(M)).values())
    for name, fields in DEPARTURES.items():
        assert not all(_within(gaps(dataclasses.replace(M, **fields))).values()), name


ROUTE = dict(cache_backend="paged", block_size=8, paged_native=True)
ENGINES = {
    "fused_then_paged_decode": dict(ROUTE, paged_kernel=True),
    "chunked": dict(ROUTE, paged_kernel=True, prefill_chunk=8),
    "verify": dict(ROUTE, speculative=True, spec_k=3),
}


@pytest.mark.parametrize("path", list(ENGINES))
def test_served_tokens_hold_to_the_reference(params, path):
    ecfg = dict(max_slots=4, max_seq_len=64, **ENGINES[path])
    if ecfg.get("speculative"):
        ecfg["draft"] = CFG
    eng = Engine(CFG, params, EngineConfig(**ecfg), device="cpu",
                 draft_params=params if ecfg.get("speculative") else None)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, M.vocab, (n,)).astype(np.int32) for n in (5, 17, 24, 11, 30)]
    reqs = [eng.submit(p, 16) for p in prompts]
    eng.run_until_complete()
    stats = eng.stats()
    eng.close()
    if path == "chunked":
        assert any(f.startswith("prefill_chunked/") for f in stats["opq"]["flags"])
    if path == "verify":
        assert stats["spec_rounds"] > 0 and stats["accepted_tokens"] > 0
    samples = [(p.astype(np.int64), np.asarray(r.tokens)) for p, r in zip(prompts, reqs)]
    assert sum(len(t) for _, t in samples) == 5 * 16
    _holds(samples)


def test_unrenormalised_gates_are_the_softmax_over_all_experts():
    scores = torch.randn((2, 10, 6), generator=torch.Generator().manual_seed(3))
    ids, gate, keep = TMOE.dispatch(scores, 3, 30, norm_topk_prob=False)
    want = torch.softmax(scores, dim=-1).gather(-1, ids)
    assert torch.equal(gate, want) and bool(keep.all())
    assert bool((gate.sum(-1) < 1).all())
    ids_n, gate_n, _ = TMOE.dispatch(scores, 3, 30)
    assert torch.equal(ids_n, ids)
    torch.testing.assert_close(gate_n, gate / gate.sum(-1, keepdim=True), rtol=1e-6, atol=0)


def _norm_scales(tree, path=()):
    """Size of the norm scales in a tree (what ``param_count`` leaves out)."""
    if isinstance(tree, dict):
        return sum(_norm_scales(v, path + (k,)) for k, v in tree.items())
    return tree.numel() if path[-1] == "scale" else 0


def test_the_parameter_count_takes_the_dense_layer():
    cfg = get_config("deepseek-moe-16b").smoke().replace(n_layers=3)
    tree = TM.init_model(cfg, torch.Generator().manual_seed(1))
    leaves = sum(t.numel() for t in _leaves(tree))
    assert cfg.param_count() == leaves - _norm_scales(tree)
    moe_mlp = (cfg.n_experts - cfg.topk) * 3 * cfg.d_model * cfg.d_ff
    assert cfg.active_param_count() == cfg.param_count() - cfg.n_moe_layers * moe_mlp
    full = get_config("deepseek-moe-16b")
    assert full.param_count() - full.replace(first_k_dense=0).param_count() == (
        3 * 2048 * 10944 - ((64 + 2) * 3 * 2048 * 1408 + 2048 * 64))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("quantize", ["off", "serve"])
def test_the_dry_run_tree_and_specs_take_the_dense_layer(quantize):
    cfg = get_config("deepseek-moe-16b").replace(quantize=quantize)
    with shd.use_mesh(shd.Mesh((16, 16), ("data", "model"))):
        params, specs = ST.param_sds(cfg)
    assert set(params) == set(specs) >= {"dense_layers", "layers"}
    # the dense MLP shards as every MLP does: its width over model
    assert getattr(specs["dense_layers"]["mlp"]["wi"], "q", specs["dense_layers"]["mlp"]["wi"]
                   ) == (None, None, "model")
    wi = params["dense_layers"]["mlp"]["wi"]
    assert tuple(getattr(wi, "q", wi).shape) == (1, 2048, 10944)
    assert tuple(getattr(params["layers"]["moe"]["wi"], "q", params["layers"]["moe"]["wi"])
                 .shape) == (27, 64, 2048, 1408)
    if quantize == "off":
        n = sum(t.numel() for t in _leaves(params))
        assert cfg.param_count() == n - _norm_scales(params)
