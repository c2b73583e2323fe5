"""Training parity, and the shared harness of the per-family files
(test_torch_train_{moe,vlm,hybrid,xlstm,encdec}.py, one family each, so
that their references run side by side): the same params and batches
through the JAX package's training forward, ``loss_fn``'s value and grad
and three ``make_train_step`` steps (run in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``, on an Auto-axis mesh;
its code generated at LLVM optimization level 0, which halves the compile
time and moves results by an ulp where products and sums would have been
contracted into FMAs), and through the port's ``train_forward``,
``loss_fn`` and ``make_train_step`` on the CPU. This file holds the dense
family, tinyllama-1.1b, and ``layers.bf16_grad``'s vjp against the
reference's backward rule.

The params are the reference's init (``PRNGKey``, jit-compiled), carried
into the port by ``params_from_numpy``; the batches come from a numpy
seed. Tolerances (the f32 rule): logits within F32["logits"] of the
reference's absolute max, the loss and the MoE aux within rtol
F32["loss"], each grad leaf within F32["leaf"] in relative L2 norm, the
leaf's norm floored at LEAF_FLOOR of the whole gradient's: a leaf whose
true gradient is 0 (the sLSTM's input-gate bias: the stabilized cell is
invariant to a shift of its input-gate pre-activation) holds only
rounding noise, some 1e-10 against 1e-2 for its neighbours. At the
configs' bf16, the loss within 2e-2, logits and grad leaves within 5e-2
(bf16 roundings in another order, carried through every layer).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

import _torch_parity as P

F32 = {"logits": 1e-4, "loss": 1e-5, "leaf": 1e-4}
BF16 = {"logits": 5e-2, "loss": 2e-2, "leaf": 5e-2}
RULES = {"float32": F32, "bfloat16": BF16}
DTYPES = list(RULES)
B, S = 2, 16
LEAF_FLOOR = 1e-6
TRAIN_STEPS = (5, 6, 7)        # the reference's test_arch_train_step starts at 5


def batch_for(cfg, seed=0):
    """A numpy batch of ``cfg``'s family: tokens and labels (the same
    stream), the encdec's frame embeddings, the vlm's patch embeddings and
    (t, h, w) positions."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.family == "encdec":
        batch["embeds"] = rng.standard_normal((B, S // cfg.enc_len_ratio, cfg.d_model),
                                              dtype=np.float32)
    elif cfg.family == "vlm":
        batch = {"embeds": rng.standard_normal((B, S, cfg.d_model), dtype=np.float32),
                 "labels": tokens}
        side = int(S ** 0.5)
        grid = np.stack([np.zeros(S), np.arange(S) // side, np.arange(S) % side])
        batch["positions3"] = np.ascontiguousarray(
            np.broadcast_to(grid[:, None], (3, B, S)).astype(np.int32))
    return batch


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if tree is None:
        return None
    return np.asarray(tree, dtype=np.float32) if tree.dtype.name == "bfloat16" \
        else np.asarray(tree)


def run_reference(archs):
    """Every arch's smoke config through the JAX package: params, and per
    dtype the forward's logits and aux, the loss, ce and grads; at f32 the
    metrics of three train steps. Runs in the subprocess."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.distributed import sharding as shd
    from repro.models import init_model
    from repro.models import model as JM
    from repro.models import steps as JST
    from repro.optim import adamw_init
    out = {}
    with shd.use_mesh(jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))):
        for i, arch in enumerate(archs):
            base = get_config(arch).smoke()
            # jit'd: quicker than op by op (other bits; the port gets these)
            params = jax.jit(init_model, static_argnums=0)(base, jax.random.PRNGKey(i + 1))
            out[arch, "params"] = _np_tree(params)
            batch = {k: jnp.asarray(v) for k, v in batch_for(base).items()}
            for dtype in DTYPES:
                cfg = base.replace(dtype=dtype)

                def both(p, b):     # one executable: XLA shares the forward
                    return (JM.forward(p, cfg, b), jax.value_and_grad(
                        lambda p: JST.loss_fn(p, cfg, b), has_aux=True)(p))
                (logits, aux), ((loss, m), grads) = jax.jit(both)(params, batch)
                out[arch, dtype] = {"logits": _np_tree(logits), "aux": float(aux),
                                    "loss": float(loss), "ce": float(m["ce"]),
                                    "grads": _np_tree(grads)}
            cfg = base.replace(dtype="float32")
            step = jax.jit(JST.make_train_step(cfg))
            p, o, rows = params, adamw_init(params), []
            for s in TRAIN_STEPS:
                p, o, m = step(p, o, batch, jnp.asarray(s, jnp.int32))
                rows.append({k: float(m[k]) for k in ("loss", "gnorm", "lr", "aux")})
            out[arch, "steps"] = rows
    return out


def reference_in_subprocess(test_file, out_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false --xla_backend_optimization_level=0")
    subprocess.run([sys.executable, test_file, str(out_path)], env=env, check=True,
                   timeout=900)
    with open(out_path, "rb") as f:
        return pickle.load(f)


def main(archs):
    with open(sys.argv[1], "wb") as f:
        pickle.dump(run_reference(archs), f)


# ------------------------------------------------------------ the port side

def port_batch(cfg, device="cpu"):
    import torch
    return {k: torch.from_numpy(v).to(device) for k, v in batch_for(cfg).items()}


def port_loss_and_grads(params, cfg, batch):
    """(logits f32 numpy, aux, loss, ce, grads in JAX's leaf order) of the
    port: ``train_forward`` under no_grad, then the train step's own
    ``forward_for_grads`` and ``grads_of``."""
    import torch
    from repro_torch import tree as T
    from repro_torch.models import model as M
    from repro_torch.models import steps as ST
    with torch.no_grad():
        logits, aux = M.train_forward(params, cfg, batch)
    loss, m = ST.forward_for_grads(params, cfg, batch)
    grads = T.leaves(ST.grads_of(loss, params))
    return (logits.to(torch.float32).numpy(), float(aux), float(loss.detach()),
            float(m["ce"]), [g.numpy() for g in grads])


def rel_l2(got, ref, floor=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    den = max(float(np.linalg.norm(ref)), floor)
    num = float(np.linalg.norm(got - ref))
    return num / den if den else num


def check_against(ref, got, dtype, label):
    """Hold the port's (logits, aux, loss, ce, grads) to the reference's by
    ``dtype``'s rule; returns the worst grad leaf's relative L2."""
    from repro_torch import tree as T
    rule = RULES[dtype]
    logits, aux, loss, ce, grads = got
    d = float(np.abs(logits - ref["logits"]).max()) / float(np.abs(ref["logits"]).max())
    assert d <= rule["logits"], (label, dtype, "logits", d)
    assert abs(loss - ref["loss"]) <= rule["loss"] * abs(ref["loss"]), (
        label, dtype, loss, ref["loss"])
    assert abs(ce - ref["ce"]) <= rule["loss"] * abs(ref["ce"]), (label, dtype, ce, ref["ce"])
    assert abs(aux - ref["aux"]) <= rule["loss"] * abs(ref["aux"]), (
        label, dtype, aux, ref["aux"])
    ref_leaves = T.leaves(ref["grads"])
    assert len(ref_leaves) == len(grads), (label, len(ref_leaves), len(grads))
    floor = LEAF_FLOOR * float(np.sqrt(sum(np.sum(np.square(r, dtype=np.float64))
                                           for r in ref_leaves)))
    worst = 0.0
    for i, (g, r) in enumerate(zip(grads, ref_leaves)):
        assert g.shape == r.shape, (label, i, g.shape, r.shape)
        e = rel_l2(g, r, floor)
        assert e <= rule["leaf"], (label, dtype, "grad leaf", i, r.shape, e)
        worst = max(worst, e)
    return worst


# ------------------------------------------------------------ the tests

def parity_tests(arch, test_file):
    """The tests of one arch's parity file, by name (its module namespace
    takes them): the reference fixture (``test_file`` run as a script in
    the subprocess), the forward, loss and grads against the reference at
    f32 and bf16, three train steps from step 5 at f32, and remat on and
    off bitwise in the port."""
    from repro_torch.configs import get_config
    from repro_torch.models import steps as ST
    from repro_torch.optim import adamw_init
    from repro_torch.testing.params import params_from_numpy

    @pytest.fixture(scope="module")
    def reference(tmp_path_factory):
        return reference_in_subprocess(test_file,
                                       tmp_path_factory.mktemp("train") / "ref.pkl")

    def setup(reference, dtype):
        # the JAX package's MoE block (deepseek-moe-16b states the published one)
        cfg = P.jax_block(get_config(arch).smoke()).replace(dtype=dtype)
        return cfg, params_from_numpy(reference[arch, "params"], device="cpu")

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_forward_loss_and_grads_match_jax(reference, dtype):
        cfg, params = setup(reference, dtype)
        worst = check_against(reference[arch, dtype],
                              port_loss_and_grads(params, cfg, port_batch(cfg)), dtype, arch)
        print(f"{arch} {dtype}: worst grad leaf {worst:.2e}")

    def test_train_steps_match_jax(reference):
        """Three make_train_step steps from step 5 at f32: each step's loss
        and aux within the rule, the grad norm within the leaf rule, the lr
        within rtol 1e-6; one optimizer step each."""
        cfg, params = setup(reference, "float32")
        step = ST.make_train_step(cfg)
        opt = adamw_init(params)
        batch = port_batch(cfg)
        for s, ref in zip(TRAIN_STEPS, reference[arch, "steps"]):
            params, opt, m = step(params, opt, batch, s)
            assert abs(float(m["loss"]) - ref["loss"]) <= F32["loss"] * abs(ref["loss"])
            assert abs(float(m["aux"]) - ref["aux"]) <= F32["loss"] * abs(ref["aux"])
            assert abs(float(m["gnorm"]) - ref["gnorm"]) <= F32["leaf"] * ref["gnorm"]
            np.testing.assert_allclose(float(m["lr"]), ref["lr"], rtol=1e-6)
        assert int(opt.step) == len(TRAIN_STEPS)

    def test_remat_on_and_off_bitwise(reference):
        cfg, params = setup(reference, "bfloat16")
        batch = port_batch(cfg)
        on = port_loss_and_grads(params, cfg, batch)
        off = port_loss_and_grads(params, cfg.replace(remat=False), batch)
        assert on[1:4] == off[1:4]
        np.testing.assert_array_equal(on[0], off[0])
        for a, b in zip(on[4], off[4]):
            np.testing.assert_array_equal(a, b)

    return {"reference": reference,
            "test_forward_loss_and_grads_match_jax": test_forward_loss_and_grads_match_jax,
            "test_train_steps_match_jax": test_train_steps_match_jax,
            "test_remat_on_and_off_bitwise": test_remat_on_and_off_bitwise}


# ------------------------------------------------------------ the dense family

ARCH = "tinyllama-1.1b"
globals().update(parity_tests(ARCH, __file__))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_grad_vjp_is_the_reference_rule(dtype):
    """The port's vjp is bitwise the reference's backward rule
    (``_bf16_grad_bwd``: the cotangent cast to bf16 and back), over
    cotangents from 1e-30 to 1e30. The reference's ``custom_vjp`` itself
    cannot be differentiated: its forward keeps ``x.dtype``, not an array,
    as the residual, which ``jax.vjp`` refuses (nothing in the reference
    calls it)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    g = (rng.standard_normal((6, 40)) * np.logspace(-30, 30, 40)).astype(np.float32)
    jx, jg = (jnp.asarray(a).astype(dtype) for a in (x, g))
    with pytest.raises(TypeError, match="not a valid JAX type"):
        jax.vjp(JL.bf16_grad, jx)
    (ref,) = JL._bf16_grad_bwd(jx.dtype, jg)
    assert ref.dtype == jx.dtype
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    ty = L.bf16_grad(tx)
    assert torch.equal(ty.detach(), tx.detach()) and ty.dtype == tx.dtype
    (got,) = torch.autograd.grad(ty, tx, torch.from_numpy(g).to(getattr(torch, dtype)))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert not np.array_equal(np.asarray(ref.astype(jnp.float32)),
                              np.asarray(jg.astype(jnp.float32))) or dtype == "bfloat16"


if __name__ == "__main__":
    main([ARCH])
