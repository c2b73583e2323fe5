"""HotSpot3D (paper §7.2.2): thermal simulation, a 3x3 stencil per layer (the
paper's conv2D mapping) plus z-coupling and power terms as pairwise adds.

Both variants reach the stencil kernel: the fp one directly, the quantized
one through the conv2D instruction on a Tensorizer-quantized field."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps.common import register
from repro_torch.core import instr as I
from repro_torch.kernels.stencil3x3 import stencil3x3

ITERS = 8
NZ = 4

W = np.array([[0.05, 0.10, 0.05],
              [0.10, 0.30, 0.10],
              [0.05, 0.10, 0.05]], np.float32)
CZ = 0.05          # coupling to layers above/below
AMB = 0.05         # ambient leak


def _step_fp(T, P):
    out = np.empty_like(T)
    for z in range(T.shape[0]):
        field = T[z]
        pad = np.pad(field, 1)
        acc = np.zeros_like(field)
        for p in range(3):
            for q in range(3):
                acc += W[p, q] * pad[p:p + field.shape[0], q:q + field.shape[1]]
        up = T[z - 1] if z > 0 else field
        dn = T[z + 1] if z < T.shape[0] - 1 else field
        out[z] = acc * (1 - 2 * CZ - AMB) + CZ * up + CZ * dn + P[z]
    return out


@register("hotspot3d")
def run(n: int, quantized: bool = True, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    T0 = (rng.uniform(40, 80, (NZ, n, n))).astype(np.float32)
    P = (rng.uniform(0, 1.0, (NZ, n, n))).astype(np.float32)

    T = torch.from_numpy(T0).to(dev)
    Pt = torch.from_numpy(P).to(dev)
    w = torch.from_numpy(W).to(dev)
    # Residual-form stencil: conv(T, W) = mean * mass + conv(T - mean, W).
    # conv2D then quantizes the residual field (range ~ +-20) instead of the
    # absolute temperatures (~40-80): finer int8 resolution, and the error
    # stays relative to the residual (the Tensorizer's §6.2.2 rule).
    # ``mass`` is the position-dependent stencil mass (the boundary cells see
    # fewer taps).
    mass = I.conv2d_fp(torch.ones((n, n), device=dev), w)
    for _ in range(ITERS):
        new = []
        for z in range(NZ):
            if quantized:
                mu = torch.mean(T[z])
                acc = I.conv2d_quant(T[z] - mu, w) + mu * mass
            else:
                acc = stencil3x3(T[z], w)
            up = T[z - 1] if z > 0 else T[z]
            dn = T[z + 1] if z < NZ - 1 else T[z]
            new.append(acc * (1 - 2 * CZ - AMB) + CZ * up + CZ * dn + Pt[z])
        T = torch.stack(new)

    def ref():
        Td = T0.astype(np.float64)
        for _ in range(ITERS):
            Td = _step_fp(Td, P.astype(np.float64))
        return Td

    return T.cpu().numpy(), ref
