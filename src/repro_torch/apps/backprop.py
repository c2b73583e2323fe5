"""Backprop (paper §7.2.5): one training step of a plain feed-forward
network: FullyConnected layers and activations, tpuGemm for the weight-delta
products, and ``sub`` for the update, per the paper's instruction mapping."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps.common import register
from repro_torch.core import instr as I
from repro_torch.core.gemm import tpu_gemm

HIDDEN = 64
LR = 0.1


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


@register("backprop")
def run(n: int, quantized: bool = True, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 16)).astype(np.float32)
    y = (X.sum(axis=1, keepdims=True) > 0).astype(np.float32)
    W1 = rng.normal(size=(16, HIDDEN)).astype(np.float32) * 0.5
    W2 = rng.normal(size=(HIDDEN, 1)).astype(np.float32) * 0.5

    def train_step_gptpu():
        fc = I.fully_connected_quant if quantized else I.fully_connected_fp
        gemm = tpu_gemm if quantized else torch.matmul
        Xt, yt, W1t, W2t = (torch.from_numpy(v).to(dev) for v in (X, y, W1, W2))
        h = 1.0 / (1.0 + torch.exp(-fc(Xt, W1t)))
        o = 1.0 / (1.0 + torch.exp(-fc(h, W2t)))
        d_o = (o - yt) * o * (1 - o)
        d_h = fc(d_o, W2t.T) * h * (1 - h)
        gW2 = gemm(h.T, d_o) / n
        gW1 = gemm(Xt.T, d_h) / n
        W2n = I.sub_fp(W2t, LR * gW2)      # update via add/sub
        W1n = I.sub_fp(W1t, LR * gW1)
        return W1n.cpu().numpy(), W2n.cpu().numpy()

    W1g, W2g = train_step_gptpu()
    out = np.concatenate([W1g.ravel(), W2g.ravel()]).astype(np.float64)

    def ref():
        h = _sigmoid(X @ W1)
        o = _sigmoid(h @ W2)
        d_o = (o - y) * o * (1 - o)
        d_h = (d_o @ W2.T) * h * (1 - h)
        gW2 = h.T @ d_o / n
        gW1 = X.T @ d_h / n
        return np.concatenate([(W1 - LR * gW1).ravel(),
                               (W2 - LR * gW2).ravel()]).astype(np.float64)

    return out, ref
