"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory with
recurrent gating): the port of ``repro.models.xlstm`` (Beck et al. 2024,
arXiv:2405.04517).

  * mLSTM: the matrix-memory recurrence C_t = f~_t C_{t-1} + i~_t v_t k_t^T
    is Mamba2's algebra (a scalar decay per head, an outer-product
    increment), so the full-sequence form runs models/ssm.py's chunked
    linear recurrence with (B, C, X) := (k, q, i~ * v), once for the
    numerator and once for the normalizer. The exponential-gating
    stabilizer has the closed form m_t = F_t + cummax_s(log i_s - F_s),
    F_t = cumsum(log f) (:func:`_stabilizer`).
  * sLSTM: sequential (h_{t-1} feeds the gates through the block-diagonal
    recurrent R), a loop over positions.

Row bits: a request alone, the decode batch and an admission bucket run
the decode body at 1, ``max_slots`` and B rows, so every contraction in it
keeps a row's bits whatever the row count: the mLSTM's readout and
normalizer over the head dim run as models/ssm.py's fixed tree of halving
adds (``readout``) where ``einsum`` would become a batched product whose
plan follows the row count; the sLSTM's recurrent product and its block's
float up/down projections run through ``layers.matmul_fixed_rows``, in
calls of exactly FIXED_ROWS rows. The projections of the serve predicate
(qgemm) sum exactly. Everything else is elementwise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tensorizer as tz
from repro_torch.models import layers as L
from repro_torch.models.ssm import chunked_linear_recurrence, readout, softplus

# The stabilizer's "no history" sentinel. Not -inf or -1e30: the chunked
# form runs the decays through a cumsum, where -1e30 + x == -1e30 in f32
# would absorb every later decay term; exp(-60) is zero beside any real
# term while -60 + x stays exact.
M_INIT = -60.0
# the sLSTM's initial normalizer and stabilizer
N_INIT = 1e-6
SM_INIT = -1e30
# rows per call of the fixed-row float products (module doc)
FIXED_ROWS = 64
GATES = ("z", "i", "f", "o")


def heads(cfg: ArchConfig) -> Tuple[int, int]:
    """(heads, head dim): xlstm-125m has 4 heads of 192."""
    return cfg.n_heads, cfg.d_model // cfg.n_heads


def _const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``c`` rounded to x's dtype first, as JAX casts a Python scalar."""
    return torch.full((), c, dtype=x.dtype, device=x.device)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)`` with softplus as
    ``logaddexp(x, 0)`` (models/ssm.py)."""
    return -softplus(-x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` op by op (the logistic's expansion)."""
    return 1 / (1 + torch.exp(-x))


def fdot(x: torch.Tensor, w, cfg: ArchConfig) -> torch.Tensor:
    """``layers.pdot`` whose float branch runs in calls of FIXED_ROWS rows:
    a QTensor goes through qgemm (exact sums), a float weight through
    ``matmul_fixed_rows`` in the compute dtype."""
    if isinstance(w, tz.QTensor):
        return L.pdot(x, w, cfg)
    return L.matmul_fixed_rows(x, w.to(L.cdtype(cfg)), FIXED_ROWS)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg: ArchConfig, device=None) -> Dict:
    """The reference's tree, drawn in the order wq, wk, wv, wi, wf,
    wo_gate, wo (LeCun-normal); ``b_i`` 0 and ``b_f`` 3 (a bias toward
    remembering)."""
    D = cfg.d_model
    H, hd = heads(cfg)
    p = {n: L.dense_init(gen, (D, s), device=device)
         for n, s in (("wq", H * hd), ("wk", H * hd), ("wv", H * hd), ("wi", H),
                      ("wf", H))}
    p["b_i"] = torch.zeros((H,), dtype=torch.float32, device=device)
    p["b_f"] = torch.full((H,), 3.0, dtype=torch.float32, device=device)
    p["wo_gate"] = L.dense_init(gen, (D, H * hd), device=device)
    p["wo"] = L.dense_init(gen, (H * hd, D), device=device)
    return p


def mlstm_specs(cfg: ArchConfig) -> Dict:
    """Partition specs of :func:`init_mlstm`'s leaves."""
    m = "model" if cfg.shard_heads else None
    return {
        "wq": (None, m), "wk": (None, m), "wv": (None, m),
        "wi": (None, m), "wf": (None, m), "b_i": (m,), "b_f": (m,),
        "wo_gate": (None, m), "wo": (m, None),
    }


def _stabilizer(log_f: torch.Tensor, log_i: torch.Tensor) -> torch.Tensor:
    """m_t = max(log f_t + m_{t-1}, log i_t) with m_{-1} = M_INIT, in its
    max-plus closed form over (B, T, H): F + max(cummax(log_i - F), init),
    where ``init = M_INIT + log_f_0 - F_0`` folds in the sentinel (it can
    win only at t = 0, the decays being negative)."""
    F = torch.cumsum(log_f, dim=1)
    base = torch.cummax(log_i - F, dim=1).values
    init = M_INIT + log_f[:, :1] - F[:, :1]
    return F + torch.maximum(base, init)


def mlstm_state(batch: int, cfg: ArchConfig, device=None) -> Tuple[torch.Tensor, ...]:
    """A pristine mLSTM state (C (B, H, hd, hd), n (B, H, hd), m (B, H))."""
    H, hd = heads(cfg)
    f32 = torch.float32
    return (torch.zeros((batch, H, hd, hd), dtype=f32, device=device),
            torch.zeros((batch, H, hd), dtype=f32, device=device),
            torch.full((batch, H), M_INIT, dtype=f32, device=device))


def mlstm_step(state: Tuple[torch.Tensor, ...], log_i: torch.Tensor, log_f: torch.Tensor,
               q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One decode position of the mLSTM, in f32: gates (B, H), q, k, v
    (B, H, hd). The stabilized update of (C, n, m), the readout C q and the
    normalizer max(|n . q|, exp(-m)), both over hd as the fixed tree.
    Returns ``(h (B, H, hd), (C, n, m))``."""
    C0, n0, m0 = state
    m = torch.maximum(log_f + m0, log_i)
    f_t = torch.exp(log_f + m0 - m)
    i_t = torch.exp(log_i - m)
    C = f_t[..., None, None] * C0 + i_t[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = f_t[..., None] * n0 + i_t[..., None] * k
    num = readout(q, C)
    den = torch.maximum(torch.abs(readout(q, n[:, :, None, :])[..., 0]), torch.exp(-m))
    return num / den[..., None], (C, n, m)


def apply_mlstm(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[Tuple[torch.Tensor, ...]] = None,
                decode: bool = False) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """x (B, T, D). ``decode``: T == 1, one step from ``state`` (C, n, m)
    (pristine when None); else the chunked full-sequence form from a
    pristine state (chunk ``min(ssm_chunk, T)``, or T when that does not
    divide T). Returns ``(y (B, T, D), state)``; the state is new tensors."""
    B, T, _ = x.shape
    H, hd = heads(cfg)
    f32 = torch.float32
    q = L.pdot(x, p["wq"], cfg).reshape(B, T, H, hd)
    k = L.pdot(x, p["wk"], cfg).reshape(B, T, H, hd)
    k = k * _const(k, hd ** -0.5)
    v = L.pdot(x, p["wv"], cfg).reshape(B, T, H, hd)
    log_i = L.pdot(x, p["wi"], cfg).to(f32) + p["b_i"]
    log_f = log_sigmoid(L.pdot(x, p["wf"], cfg).to(f32) + p["b_f"])
    if decode:
        if T != 1:
            raise ValueError(f"decode takes one position, got {T}")
        state = state if state is not None else mlstm_state(B, cfg, x.device)
        h, state = mlstm_step(state, log_i[:, 0], log_f[:, 0], q[:, 0].to(f32),
                              k[:, 0].to(f32), v[:, 0].to(f32))
        h = h[:, None]
    else:
        m = _stabilizer(log_f, log_i)
        m_prev = torch.cat([torch.full((B, 1, H), M_INIT, dtype=f32, device=x.device),
                            m[:, :-1]], dim=1)
        log_fs = log_f + m_prev - m                 # stabilized decay (<= 0)
        i_s = torch.exp(log_i - m)                  # stabilized input gate
        kf, qf = k.to(f32), q.to(f32)
        chunk = min(cfg.ssm_chunk, T)
        if T % chunk:
            chunk = T
        num, C_last = chunked_linear_recurrence(log_fs, kf, qf, v.to(f32) * i_s[..., None],
                                                chunk)
        den_raw, n_last = chunked_linear_recurrence(log_fs, kf, qf, i_s[..., None], chunk)
        den = torch.maximum(torch.abs(den_raw[..., 0]), torch.exp(-m))
        h = num / den[..., None]
        state = (C_last, n_last[:, :, 0], m[:, -1])
    gate = L.pdot(x, p["wo_gate"], cfg).reshape(B, T, H, hd).to(f32)
    h = h * sigmoid(gate)
    return L.pdot(h.reshape(B, T, H * hd).to(x.dtype), p["wo"], cfg), state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ArchConfig, device=None) -> Dict:
    """The reference's tree: per gate g in (z, i, f, o) ``w{g}`` (D, D)
    LeCun-normal, ``r{g}`` (H, hd, hd) N(0, 1/hd) and ``b{g}`` (1 for the
    forget gate, else 0); the block's ``wup`` (D, 2D) and ``wdown`` (D, D).
    Drawn gate by gate (w, r, b), then wup and wdown."""
    D = cfg.d_model
    H, hd = heads(cfg)
    p = {}
    for g in GATES:
        p[f"w{g}"] = L.dense_init(gen, (D, D), device=device)
        p[f"r{g}"] = torch.randn((H, hd, hd), generator=gen, dtype=torch.float32,
                                 device=device) * (hd ** -0.5)
        p[f"b{g}"] = torch.full((D,), 1.0 if g == "f" else 0.0, dtype=torch.float32,
                                device=device)
    p["wup"] = L.dense_init(gen, (D, 2 * D), device=device)
    p["wdown"] = L.dense_init(gen, (D, D), device=device)
    return p


def slstm_specs(cfg: ArchConfig) -> Dict:
    """Partition specs of :func:`init_slstm`'s leaves."""
    p = {}
    for g in ("z", "i", "f", "o"):
        p[f"w{g}"] = (None, None)
        p[f"r{g}"] = (None, None, None)
        p[f"b{g}"] = (None,)
    p["wup"] = (None, "model")
    p["wdown"] = (None, None)
    return p


def slstm_state(batch: int, cfg: ArchConfig, device=None) -> Tuple[torch.Tensor, ...]:
    """A pristine sLSTM state (c, n, h, m), each (B, D): 0, N_INIT, 0,
    SM_INIT."""
    D, f32 = cfg.d_model, torch.float32
    return (torch.zeros((batch, D), dtype=f32, device=device),
            torch.full((batch, D), N_INIT, dtype=f32, device=device),
            torch.zeros((batch, D), dtype=f32, device=device),
            torch.full((batch, D), SM_INIT, dtype=f32, device=device))


def recurrent_weights(p: Dict) -> torch.Tensor:
    """The four gates' R side by side per head: (H, hd, 4 * hd), f32."""
    return torch.cat([p[f"r{g}"].to(torch.float32) for g in GATES], dim=-1)


def slstm_step(state: Tuple[torch.Tensor, ...], xg: Tuple[torch.Tensor, ...],
               R: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One position of the sLSTM in f32: the gates' input parts ``xg`` (z,
    i, f, o pre-activations, (B, D) each) plus the block-diagonal
    recurrent product of h_{t-1} (each head's (hd,) row times its
    (hd, 4 hd) slice of ``R``, FIXED_ROWS rows a call), then the
    stabilized update. Returns ``(h, (c, n, h, m))``."""
    c, n, h, m = state
    B, D = h.shape
    H, hd = R.shape[0], R.shape[1]
    hh = h.reshape(B, H, hd)
    rec = torch.stack([L.matmul_fixed_rows(hh[:, j], R[j], FIXED_ROWS) for j in range(H)],
                      dim=1).reshape(B, H, len(GATES), hd)
    rz, ri, rf, ro = (rec[:, :, i].reshape(B, D) for i in range(len(GATES)))
    xz, xi, xf, xo = xg
    z = torch.tanh(xz + rz)
    li = xi + ri
    lf = log_sigmoid(xf + rf)
    o = sigmoid(xo + ro)
    m_new = torch.maximum(lf + m, li)
    i_s = torch.exp(li - m_new)
    f_s = torch.exp(lf + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_new = o * c_new / torch.clamp_min(n_new, N_INIT)
    return h_new, (c_new, n_new, h_new, m_new)


def apply_slstm(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[Tuple[torch.Tensor, ...]] = None,
                decode: bool = False) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """x (B, T, D): the sequential scan over T from ``state`` (c, n, h, m)
    (pristine when None), then the block's GeGLU up/down projection
    (``gelu(a) * b @ wdown`` with ``a, b`` the halves of ``h @ wup``; the
    tanh-form GeLU, ``layers.gelu``). ``decode`` changes nothing: one
    position is a scan of one. Returns ``(y (B, T, D), state)``."""
    B, T, _ = x.shape
    f32 = torch.float32
    xg = [L.pdot(x, p[f"w{g}"], cfg).to(f32) + p[f"b{g}"] for g in GATES]
    state = state if state is not None else slstm_state(B, cfg, x.device)
    R = recurrent_weights(p)
    hs = []
    for t in range(T):
        h, state = slstm_step(state, tuple(g[:, t] for g in xg), R)
        hs.append(h)
    h_seq = torch.stack(hs, dim=1).to(x.dtype)
    up = fdot(h_seq, p["wup"], cfg)
    a, b = torch.chunk(up, 2, dim=-1)
    return fdot(L.gelu(a) * b, p["wdown"], cfg), state
