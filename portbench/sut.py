"""The system under test: the port's serving engine, built from a
configuration file and the seeded weights.

The benchmark hands the port float weights (``portbench/weights.py``) and
lets it quantize them on its own path (``tensorizer.quantize_params``).
The port's own registry config for the architecture must equal the
configuration file number for number, so a config changed in the program
cannot change what a cell measures without the run failing. Two fields
are the harness's to set: the serving quantization (W8A8), and RoPE's
base, which the port's registry config keeps at its default and the
configuration file states as published.

The program surface used: ``repro_torch.configs.get_config``,
``repro_torch.core.tensorizer`` (``quantize_params``, ``QTensor``) and
``repro_torch.serving.engine`` (``Engine``, ``EngineConfig``; ``submit``,
``step``, the request's ``tokens`` and ``done``, ``metrics``,
``store.memory_stats()``, ``scheduler.buckets``, ``close``).

A mixture-of-experts file (``family`` moe) also fixes the port's
``n_experts``, ``n_shared_experts``, ``topk`` and ``d_ff`` (one expert's
width). Its layers are the port's ``moe`` subtree (``models/moe.py``
``init_moe``: ``router``, ``wi``, ``wg``, ``wo``, ``shared``), quantized as
the port's serve path quantizes them: every projection int8, the router
float. The two published departures of DeepSeek-MoE from the port's MoE
block are checked, not assumed:

* leading dense layers: where the file has ``first_k_dense_replace`` k >
  0, the harness passes the first k layers (attention and the SwiGLU MLP
  of width ``intermediate_size``) stacked under ``params["dense_layers"]``
  and the rest under ``params["layers"]``, and the port's config must have
  ``first_k_dense == k`` and ``dense_d_ff == intermediate_size``;
* the gates: the port's ``norm_topk_prob`` must equal the file's (true:
  the k gates renormalised to sum to 1; false: the softmax over all
  experts kept as it is).

A port config without one of these fields counts as the port's present
behaviour (``ABSENT``: no leading dense layer, renormalised gates), so a
file that states the published values fails, naming the field, until the
port gains it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench import weights as W
from portbench.model import Model


# what a port config that lacks the field does (module doc)
ABSENT = {"first_k_dense": 0, "dense_d_ff": None, "norm_topk_prob": True}


def _expected(m: Model, c: Dict) -> Dict:
    """The port ArchConfig fields a configuration file fixes."""
    serving = c["serving"]
    exp = {
        "family": m.family, "n_layers": m.n_layers, "d_model": m.d_model,
        "n_heads": m.n_heads, "n_kv": m.n_kv, "hd": m.head_dim, "vocab": m.vocab,
        "qk_norm": m.qk_norm, "rope_theta": m.rope_theta, "rope_kind": "rope",
        "act": "swiglu", "norm": "rmsnorm", "input_mode": "tokens",
        "tie_embeddings": bool(c.get("tie_word_embeddings", False)),
        "dtype": serving["compute_dtype"], "kv_cache_dtype": serving["kv_cache_dtype"],
    }
    if m.family != "moe":
        exp["d_ff"] = m.d_ff
        return exp
    exp.update(d_ff=m.expert_ff, n_experts=m.n_experts, n_shared_experts=m.n_shared,
               topk=m.topk, first_k_dense=m.first_k_dense, norm_topk_prob=m.norm_topk_prob)
    if m.first_k_dense:
        exp["dense_d_ff"] = m.d_ff
    return exp


def differences(cfg, m: Model, c: Dict) -> Dict:
    """(port, file) of every field of ``_expected`` in which the port's
    config ``cfg`` differs from file ``c`` (a missing field read as
    ``ABSENT`` says)."""
    exp = _expected(m, c)
    got = {k: getattr(cfg, k, ABSENT.get(k)) for k in exp}
    return {k: (got[k], v) for k, v in exp.items() if got[k] != v}


def port_config(c: Dict):
    """The port's ArchConfig of configuration file ``c`` (``arch``; with
    ``smoke`` true, the port's reduced CPU-test config of that arch),
    quantized for serving, with the file's RoPE base; raises if any other
    number differs from the file."""
    from repro_torch.configs import get_config
    cfg = get_config(c["arch"])
    if c.get("smoke"):
        cfg = cfg.smoke()
    m = Model.from_config(c)
    cfg = cfg.replace(quantize="serve", rope_theta=m.rope_theta)
    wrong = differences(cfg, m, c)
    if wrong:
        raise ValueError(f"the port's {c['arch']} config differs from "
                         f"{c['name']}'s file (port, file): {wrong}")
    return cfg


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def _layer_tree(m: Model, leaves: Dict[str, torch.Tensor], device) -> Dict:
    """One layer in the port's tree: norms (unit scales), attention and
    the MLP or the ``moe`` block, nested from the leaves' dotted names."""
    ones = lambda n: torch.ones((n,), dtype=torch.float32, device=device)  # noqa: E731
    tree = _nest(leaves)
    tree["ln1"] = {"scale": ones(m.d_model)}
    tree["ln2"] = {"scale": ones(m.d_model)}
    if m.qk_norm:
        tree["attn"]["q_norm"] = ones(m.head_dim)
        tree["attn"]["k_norm"] = ones(m.head_dim)
    return tree


def _quantize(tree: Dict) -> Dict:
    """The port's quantization of every projection: each >= 2-D leaf but
    the MoE router (the serve path's float leaves are the norms, the
    embedding and the router)."""
    from repro_torch.core import tensorizer as tz
    return tz.quantize_params(tree, lambda path, leaf: path[-1] != "router")


def _stacked_like(tree, n: int):
    from repro_torch.core.tensorizer import QTensor
    if isinstance(tree, dict):
        return {k: _stacked_like(v, n) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        q = tree.q.new_empty((n,) + tuple(tree.q.shape))
        return QTensor(q, tree.scale.new_empty((n,) + tuple(tree.scale.shape)), tuple(q.shape))
    return tree.new_empty((n,) + tuple(tree.shape))


def _put(stacked, tree, i: int) -> None:
    from repro_torch.core.tensorizer import QTensor
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(stacked[k], v, i)
    elif isinstance(tree, QTensor):
        stacked.q[i].copy_(tree.q)
        stacked.scale[i].copy_(tree.scale)
    else:
        stacked[i].copy_(tree)


def port_params(m: Model, cfg, seed: int, device) -> Dict:
    """The port's W8A8 serving params from the seeded float weights, made
    and quantized one layer at a time on ``device``; an MoE file's leading
    dense layers stacked apart under ``dense_layers`` (module doc)."""
    from repro_torch.core import tensorizer as tz
    pad = cfg.vocab_padded - m.vocab
    emb = W.embedding(m, seed, device)
    head = W.lm_head(m, seed, device)
    if pad:
        # padded rows and columns are zero; the port masks their logits
        emb = torch.cat([emb, emb.new_zeros((pad, m.d_model))])
        head = torch.cat([head, head.new_zeros((m.d_model, pad))], dim=1)
    params = {"embed": emb,
              "final_ln": {"scale": torch.ones((m.d_model,), dtype=torch.float32,
                                               device=device)},
              "lm_head": tz.quantize(head, axis=-2)}
    del head
    k = m.first_k_dense
    for key, first, end in (("dense_layers", 0, k), ("layers", k, m.n_layers)):
        stacked = None
        for i in range(first, end):
            layer = _quantize(_layer_tree(m, W.layer(m, seed, i, device), device))
            if stacked is None:
                stacked = _stacked_like(layer, end - first)
            _put(stacked, layer, i - first)
            del layer
        if stacked is not None:
            params[key] = stacked
    return params


def engine(cfg, params: Dict, store: Dict, engine_spec: Dict, device):
    """The port's Engine with the configuration's store route and the
    cell's engine settings."""
    from repro_torch.serving.engine import Engine, EngineConfig
    ecfg = EngineConfig(**store, **engine_spec)
    return Engine(cfg, params, ecfg, device=device)


def pool_blocks(eng) -> Optional[tuple]:
    """(blocks in use, blocks in the pool) from the store's own census."""
    ms = eng.store.memory_stats()
    if "blocks_used" not in ms:
        return None
    return ms["blocks_used"], ms["blocks_total"]
