"""Mamba2 (SSD) blocks and the chunked linear recurrence: the port of
``repro.models.ssm``.

The recurrence, per head with a scalar decay,

    h_t = a_t * h_{t-1} + X_t (x) B_t,        y_t = C_t . h_t,

runs in two forms. Decode (one position, the serving path) updates the state
(B, H, P, N) in f32 and reads it out. The chunked form (a whole sequence:
the embedding forward) computes the intra-chunk terms as decay-masked Gram
products and carries the state across chunks in a short loop, the
reference's algebra (``chunked_linear_recurrence``).

Row bits on the card: a decode row's result must not depend on how many
rows share the call (a request alone, the decode batch and an admission
bucket run the same body at 1, ``max_slots`` and B rows). Every op of the
decode form is elementwise except three: the projections (qgemm: exact
int32 sums), the readout ``C . h`` over N, which runs as a fixed tree of
halving adds (:func:`readout`) where ``einsum`` would become a batched
product whose plan follows the row count, and the gated RMSNorm over
d_inner, one ``F.rms_norm`` (row-count invariant, models/layers.py
``apply_norm``) where ``torch.mean`` would pick its plan by the row count.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

CONV_W = 4  # mamba2 causal depthwise conv width


def _segsum(l: torch.Tensor) -> torch.Tensor:
    """l: (..., Q) log-decays -> (..., Q, Q) with out[t, s] = sum_{r=s+1..t}
    l_r for s <= t, -inf otherwise (the decay matrix exponent)."""
    Q = l.shape[-1]
    cs = torch.cumsum(l, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=l.device))
    return torch.where(mask, diff, torch.full_like(diff, float("-inf")))


def chunked_linear_recurrence(log_a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                              X: torch.Tensor, chunk: int,
                              h0: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Y, h_final)``: Y[t] = C_t . h_t with h_t = a_t h_{t-1} + X_t (x) B_t.

    log_a (B, T, H) per-step log decay (<= 0); Bm, Cm (B, T, H, N); X
    (B, T, H, P); h0 (B, H, P, N) the initial state (zeros when None). T
    must be a multiple of ``chunk``, as the reference asserts. All math in
    f32; every exponent is a difference bounded above by 0."""
    Bsz, T, H = log_a.shape
    N, Pd = Bm.shape[-1], X.shape[-1]
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of chunk {chunk}")
    nc, Q = T // chunk, chunk
    f32 = torch.float32
    la = log_a.reshape(Bsz, nc, Q, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, Q, H, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, Q, H, N).to(f32)
    Xc = X.reshape(Bsz, nc, Q, H, Pd).to(f32)

    lah = la.movedim(-1, 2)                                 # (B, nc, H, Q)
    decay_M = torch.exp(_segsum(lah))                       # masked decay matrix
    # intra-chunk: Y_inner[t] = sum_s M[t, s] (C_t . B_s) X_s
    G = torch.einsum("bnqhi,bnshi->bnhqs", Cc, Bc)
    Y_inner = torch.einsum("bnhqs,bnshp->bnqhp", G * decay_M, Xc)

    # chunk-final states: S_n = sum_s exp(L_end - L_s) X_s (x) B_s
    Lend = torch.sum(lah, dim=-1, keepdim=True)             # (B, nc, H, 1)
    Lcum = torch.cumsum(lah, dim=-1)                        # L_s (inclusive)
    decay_out = torch.exp(Lend - Lcum)                      # (B, nc, H, Q)
    S_chunk = torch.einsum("bnhq,bnqhp,bnqhi->bnhpi", decay_out, Xc, Bc)

    # inter-chunk: h_n = exp(Lend_n) h_{n-1} + S_n, the state entering each
    # chunk kept
    a_chunk = torch.exp(Lend[..., 0])                       # (B, nc, H)
    h = (torch.zeros((Bsz, H, Pd, N), dtype=f32, device=log_a.device) if h0 is None
         else h0.to(f32))
    h_in = []
    for n in range(nc):
        h_in.append(h)
        h = a_chunk[:, n, :, None, None] * h + S_chunk[:, n]
    h_in = torch.stack(h_in, dim=1)                         # (B, nc, H, P, N)

    # inter-chunk contribution: C_t . (exp(L_t) h_in)
    decay_in = torch.exp(Lcum)                              # (B, nc, H, Q)
    Y_inter = torch.einsum("bnqhi,bnhq,bnhpi->bnqhp", Cc, decay_in, h_in)
    return (Y_inner + Y_inter).reshape(Bsz, T, H, Pd), h


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg: ArchConfig) -> int:
    return d_inner(cfg) // cfg.ssm_headdim


def conv_channels(cfg: ArchConfig) -> int:
    """x, B and C go through the conv: d_inner + 2 * ssm_state channels."""
    return d_inner(cfg) + 2 * cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, device=None) -> Dict:
    """A mamba2 block's params with the reference's tree, shapes and
    distributions, drawn in the order wz, wxbc, wdt, conv_w, wo: projections
    LeCun-normal, conv taps N(0, 0.2^2), ``A_log`` the deterministic
    ``log(linspace(1, H, H))``, dt bias and conv bias 0, D skip and the norm
    scale 1."""
    D, H = cfg.d_model, n_ssm_heads(cfg)
    di, C = d_inner(cfg), conv_channels(cfg)

    def const(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=device)
    p = {"wz": L.dense_init(gen, (D, di), device=device),
         "wxbc": L.dense_init(gen, (D, C), device=device),
         "wdt": L.dense_init(gen, (D, H), device=device),
         "dt_bias": const(H, 0.0)}
    p["conv_w"] = torch.randn((CONV_W, C), generator=gen, dtype=torch.float32,
                              device=device) * 0.2
    p["conv_b"] = const(C, 0.0)
    p["A_log"] = torch.log(torch.linspace(1.0, float(H), H, dtype=torch.float32,
                                          device=device))
    p["Dskip"] = const(H, 1.0)
    p["norm"] = const(di, 1.0)
    p["wo"] = L.dense_init(gen, (di, D), device=device)
    return p


def mamba2_specs(cfg: ArchConfig) -> Dict:
    """Partition specs of :func:`init_mamba2`'s leaves."""
    return {
        "wz": (None, "model"), "wxbc": (None, None), "wdt": (None, "model"),
        "dt_bias": ("model",), "conv_w": (None, None), "conv_b": (None,),
        "A_log": ("model",), "Dskip": ("model",), "norm": ("model",),
        "wo": ("model", None),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width CONV_W as shifted adds. x: (B, T, C);
    ``state`` (B, CONV_W - 1, C) the previous inputs, in x's dtype (the
    cache dtype). The taps are summed in order i = 0..3 in f32, then the
    bias, then cast to x's dtype. Returns (y, new_state): the state is the
    last CONV_W - 1 inputs."""
    B, T, C = x.shape
    if state is None:
        state = x.new_zeros((B, CONV_W - 1, C))
    xp = torch.cat([state.to(x.dtype), x], dim=1)             # (B, T + W - 1, C)
    y = xp[:, 0:T] * w[0]
    for i in range(1, CONV_W):
        y = y + xp[:, i:i + T] * w[i]
    return (y + b).to(x.dtype), xp[:, T:]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))``. ``F.softplus`` returns x itself above a threshold
    of 20 and rounds otherwise."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def readout(c: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``einsum("bhn,bhpn->bhp", c, h)`` in f32 as a fixed tree of
    elementwise halving adds over N (zero-padded to a power of two): each
    output's sum runs in one order whatever the number of rows."""
    t = c[:, :, None, :] * h
    n = t.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        t = torch.cat([t, t.new_zeros(t.shape[:-1] + (width - n,))], dim=-1)
    while t.shape[-1] > 1:
        half = t.shape[-1] // 2
        t = t[..., :half] + t[..., half:]
    return t[..., 0]


def ssm_step(h0: torch.Tensor, log_a: torch.Tensor, X: torch.Tensor, Bv: torch.Tensor,
             Cv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode position of the recurrence, in f32: the state update
    ``h = exp(log_a) h0 + X (x) B`` (h0 (B, H, P, N), log_a (B, H), X
    (B, H, P), B and C (B, H, N)) and the readout ``C . h``. Returns
    ``(y (B, H, P), h)``."""
    a = torch.exp(log_a)
    h = a[..., None, None] * h0 + X[..., :, None] * Bv[:, :, None, :]
    return readout(Cv, h), h


def apply_mamba2(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                 conv_state: Optional[torch.Tensor] = None,
                 ssm_state: Optional[torch.Tensor] = None,
                 decode: bool = False) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x: (B, T, D). ``decode=False``: the chunked SSD form over the
    sequence (chunk ``min(cfg.ssm_chunk, T)``); ``decode=True``: T == 1,
    the state update and readout. Returns ``(y, (conv_state, ssm_state))``,
    new tensors (the inputs are not written)."""
    B, T, _ = x.shape
    di, H, N, Pd = d_inner(cfg), n_ssm_heads(cfg), cfg.ssm_state, cfg.ssm_headdim
    f32 = torch.float32
    z = L.pdot(x, p["wz"], cfg)
    xbc = L.pdot(x, p["wxbc"], cfg)
    dt = softplus(L.pdot(x, p["wdt"], cfg).to(f32) + p["dt_bias"])    # (B, T, H)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = L.silu(xbc)
    xs = xbc[..., :di].reshape(B, T, H, Pd)
    # B and C are shared by the heads: the reference broadcasts them by a
    # product with ones, which is exact
    Bm = xbc[..., di:di + N][:, :, None, :].expand(B, T, H, N)
    Cm = xbc[..., di + N:][:, :, None, :].expand(B, T, H, N)

    A = -torch.exp(p["A_log"])                                  # (H,) negative
    log_a = dt * A                                              # (B, T, H)
    X = xs.to(f32) * dt[..., None]

    if decode:
        if T != 1:
            raise ValueError(f"decode takes one position, got {T}")
        h0 = (ssm_state if ssm_state is not None
              else torch.zeros((B, H, Pd, N), dtype=f32, device=x.device))
        y, ssm_state = ssm_step(h0, log_a[:, 0], X[:, 0], Bm[:, 0].to(f32), Cm[:, 0].to(f32))
        y = y[:, None]
    else:
        y, ssm_state = chunked_linear_recurrence(log_a, Bm, Cm, X, min(cfg.ssm_chunk, T),
                                                 h0=ssm_state)

    y = y + xs.to(f32) * p["Dskip"][None, None, :, None]
    y = y.reshape(B, T, di).to(x.dtype)
    # gated RMSNorm (mamba2's norm before the out-projection)
    y = (y * L.silu(z)).to(f32)
    y = F.rms_norm(y, (di,), p["norm"].to(f32), 1e-6).to(x.dtype)
    return L.pdot(y, p["wo"], cfg), (conv_state, ssm_state)
