"""Training parity of the MoE family: deepseek-moe-16b at its smoke config
(4 routed experts, top-2, a shared expert), the port's training forward,
loss (its aux too), grads and train steps against the JAX package's
(tests/test_torch_train.py), and the MoE block under autograd.
"""

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.testing.params import params_from_numpy

import test_torch_train as TP

ARCH = "deepseek-moe-16b"
globals().update(TP.parity_tests(ARCH, __file__))


def test_moe_training_autograd_takes_several_expert_passes(reference, monkeypatch):
    """At 4 rows of 16 tokens (64 tokens, top-2 over 4 experts) an expert's
    queue exceeds EXPERT_ROWS = 32, so the expert products run in more than
    one pass (a host read of the longest queue); the grads still match a
    one-pass product of the same (token, expert) pairs, and the float
    experts never reach the int8 dequantization (whose ``out=`` autograd
    refuses)."""
    cfg = get_config(ARCH).smoke().replace(dtype="float32")
    params = params_from_numpy(reference[ARCH, "params"], device="cpu")
    lp = M.layer_params(params["layers"], 0)
    for p in T.leaves(lp):
        p.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)).requires_grad_(True)

    def run():
        y, aux = MOE.apply_moe(lp["moe"], x, cfg)
        loss = (y * y).mean() + aux
        return loss, torch.autograd.grad(loss, [x] + T.leaves(lp["moe"]))
    passes = []
    real = MOE.expert_outputs

    def counted(p, xs, experts, n_tokens, c):
        counts = torch.bincount(experts, minlength=c.n_experts)
        passes.append(-(-int(counts.max()) // MOE.EXPERT_ROWS))
        return real(p, xs, experts, n_tokens, c)
    monkeypatch.setattr(MOE, "expert_outputs", counted)
    monkeypatch.setattr(MOE, "_dequant", lambda w, dtype: (
        pytest.fail("float experts reached _dequant's int8 path")
        if not isinstance(w, torch.Tensor) else w.to(dtype)))
    loss, grads = run()
    assert passes and passes[0] > 1
    monkeypatch.setattr(MOE, "EXPERT_ROWS", 64 * cfg.topk)
    passes.clear()
    loss1, grads1 = run()
    assert passes == [1]
    assert torch.equal(loss, loss1)
    for a, b in zip(grads, grads1):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


if __name__ == "__main__":
    TP.main([ARCH])
