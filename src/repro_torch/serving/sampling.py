"""Batch-invariant sampling: per-request stochastic decoding on the engine —
the port of ``repro.serving.sampling``.

Per-request parameters (temperature, top-k, top-p nucleus, repetition
penalty, stop sequences, seed) are stacked per batch and applied by ONE
masked, batched step that every greedy/sampled mix shares. Randomness is
counter-style: each row's Gumbel noise is a pure function of
``(request seed, absolute position)``, derived exactly as the JAX package
derives it (``fold_in(PRNGKey(seed), position)`` and ``gumbel`` over the
padded vocab, threefry2x32 with ``jax_threefry_partitionable``), bit for
bit, with integer torch ops: torch's own RNG is never used. So a seeded
request emits the same stream whatever batchmates share its steps, which
slot it lands in and which cache store holds its K/V, and the same stream
as the JAX package's engine.

Stop sequences are matched on the host over the generated tokens only (the
prompt never triggers a stop), by suffix each step, so a stop spanning a
step boundary or a speculative window fires at its last token.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "SamplingParams", "GREEDY", "stack_params", "sample_tokens",
    "choose_tokens", "stop_match", "logprob_info", "TOP_LOGPROBS",
    "sampling_to_wire", "sampling_from_wire", "threefry2x32", "fold_in",
    "random_bits", "uniform", "gumbel",
]

# Device-side top-K width of the per-token logprob capture; requests asking
# for more are rejected at the door.
TOP_LOGPROBS = 5

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _norm_stop(stop) -> Tuple[Tuple[int, ...], ...]:
    """Normalize stop sequences to a tuple of non-empty int tuples."""
    if stop is None:
        return ()
    if isinstance(stop, (int, np.integer)):
        stop = ((int(stop),),)
    out = []
    for seq in stop:
        if isinstance(seq, (int, np.integer)):
            seq = (int(seq),)
        seq = tuple(int(t) for t in seq)
        if not seq:
            raise ValueError("empty stop sequence")
        out.append(seq)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters.

    ``temperature <= 0`` means greedy (argmax), the default. ``top_k <= 0``
    disables top-k; ``top_p >= 1.0`` disables nucleus filtering;
    ``repetition_penalty == 1.0`` is a no-op. ``stop`` is a sequence of
    token-id sequences matched against generated tokens."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    seed: int = 0
    stop: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.repetition_penalty <= 0:
            raise ValueError(
                f"repetition_penalty must be > 0, got {self.repetition_penalty}")
        object.__setattr__(self, "stop", _norm_stop(self.stop))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


def stack_params(sps: Sequence[Optional[SamplingParams]],
                 presence: np.ndarray) -> Dict:
    """Stack per-slot SamplingParams into the host arrays ``sample_tokens``
    consumes (the engine places them on its device with the step's other
    inputs). ``presence`` is the (B, vocab_padded) bool array of token ids
    each slot has seen (prompt + generated), the repetition penalty's input.
    ``None`` entries are greedy. ``sampled`` is a host bool, True when any
    row samples: the JAX package's ``lax.cond`` on the device, decided here
    from the requests without reading the device."""
    sps = [sp if sp is not None else GREEDY for sp in sps]
    return {
        "temperature": np.asarray([sp.temperature for sp in sps], np.float32),
        "top_k": np.asarray([sp.top_k for sp in sps], np.int64),
        "top_p": np.asarray([sp.top_p for sp in sps], np.float32),
        "rep_penalty": np.asarray([sp.repetition_penalty for sp in sps], np.float32),
        # uint32 values held in int64 (torch's uint32 is partial on CUDA)
        "seed": np.asarray([sp.seed & _MASK for sp in sps], np.int64),
        "greedy": np.asarray([sp.greedy for sp in sps], bool),
        "presence": np.asarray(presence, bool),
        "sampled": not all(sp.greedy for sp in sps),
    }


# ---------------------------------------------------------------------------
# threefry2x32, fold_in and gumbel: jax.random's derivation, bit for bit
# ---------------------------------------------------------------------------

def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2) under
    the key (k1, k2), as ``jax._src.prng._threefry2x32_lowering`` computes
    it. Every operand is an int64 tensor holding uint32 values (any
    broadcastable shapes); each sum and left shift is masked back to 32
    bits."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(seed: torch.Tensor, position: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in(jax.random.PRNGKey(seed), position)`` for uint32
    ``seed`` and non-negative ``position`` (int tensors of one shape): the
    raw key of a uint32 seed is (0, seed), and folding in ``d`` hashes the
    counter pair (0, d) under it. Returns the new key's two words."""
    seed = seed.to(torch.int64) & _MASK
    position = position.to(torch.int64) & _MASK
    zero = torch.zeros_like(seed)
    return threefry2x32(zero, seed, zero, position)


def random_bits(key: Tuple[torch.Tensor, torch.Tensor], vocab: int) -> torch.Tensor:
    """``jax.random.bits(key, (vocab,), uint32)`` for a batch of keys
    ((B,) words each) -> (B, vocab) int64 holding uint32 values: the
    partitionable threefry draws counter (0, j) for column j and returns the
    XOR of the hash's two words."""
    k1, k2 = (k[..., None] for k in key)
    cols = torch.arange(vocab, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(cols), cols)
    return b1 ^ b2


def uniform(key: Tuple[torch.Tensor, torch.Tensor], vocab: int) -> torch.Tensor:
    """``jax.random.uniform(key, (vocab,), float32, minval=tiny, maxval=1)``,
    batched: the top 23 bits as the mantissa of a float in [1, 2), minus 1,
    scaled into [tiny, 1)."""
    bits = random_bits(key, vocab)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = f.new_full((), _F32_TINY)
    return torch.maximum(tiny, f * (1.0 - tiny) + tiny)


def gumbel(key: Tuple[torch.Tensor, torch.Tensor], vocab: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (vocab,), float32)`` (mode "low"), batched:
    ``-log(-log(u))``. Equal to JAX's within the last bits of ``log``."""
    return -torch.log(-torch.log(uniform(key, vocab)))


def _gumbel_rows(seed: torch.Tensor, position: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B,) seed x (B,) position -> (B, vocab) Gumbel noise, a pure function
    of each row's (seed, position): the batch-invariance keystone."""
    return gumbel(fold_in(seed, position), vocab)


# ---------------------------------------------------------------------------
# the batched sampler
# ---------------------------------------------------------------------------

def sample_tokens(logits: torch.Tensor, sp: Dict, positions: torch.Tensor) -> torch.Tensor:
    """One batched, batch-invariant sampling step.

    logits: (B, vocab_padded); sp: ``stack_params`` on the logits' device;
    positions: (B,) absolute position of the token being emitted, the
    randomness counter.

    Greedy rows take a plain f32 argmax of the raw logits. Sampled rows
    apply the repetition penalty, temperature, top-k and top-p, then
    Gumbel-max with counter-derived noise. When no row samples (``sampled``
    False) the sampled pipeline is skipped."""
    logits = logits.to(torch.float32)
    V = logits.shape[-1]
    greedy_tok = torch.argmax(logits, dim=-1)
    if not sp["sampled"]:
        return greedy_tok
    # repetition penalty (CTRL-style) over the presence mask
    rep = sp["rep_penalty"][:, None]
    pen = torch.where(logits > 0, logits / rep, logits * rep)
    l = torch.where(sp["presence"], pen, logits)
    l = l / torch.clamp(sp["temperature"], min=1e-6)[:, None]
    # sort once; top-k and top-p in sorted space
    srt = torch.sort(l, dim=-1, descending=True).values
    col = torch.arange(V, device=l.device)[None, :]
    k = torch.clamp(sp["top_k"], 0, V)[:, None]
    in_k = (k <= 0) | (col < k)
    probs = torch.softmax(torch.where(in_k, srt, torch.full_like(srt, -torch.inf)), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    top_p = sp["top_p"][:, None]
    keep = in_k & (((cum - probs) < top_p) | (top_p >= 1.0))
    keep[:, 0] = True
    # back to unsorted space: allowed = logit >= the smallest kept
    thresh = torch.where(keep, srt, torch.full_like(srt, torch.inf)).amin(dim=-1, keepdim=True)
    allowed = l >= thresh
    g = _gumbel_rows(sp["seed"], positions, V)
    tok = torch.argmax(torch.where(allowed, l + g, torch.full_like(l, -torch.inf)), dim=-1)
    return torch.where(sp["greedy"], greedy_tok, tok)


def choose_tokens(row: torch.Tensor, sampling: Optional[Dict], positions) -> torch.Tensor:
    """Logits row -> token for the step builders: greedy argmax when no
    sampling state is given, the batched sampler otherwise. ``positions``
    may be a scalar (broadcast over the batch)."""
    if sampling is None:
        return torch.argmax(row.to(torch.float32), dim=-1)
    positions = torch.as_tensor(positions, device=row.device)
    if positions.ndim == 0:
        positions = positions.expand(row.shape[0])
    return sample_tokens(row, sampling, positions)


def logprob_info(row: torch.Tensor, chosen: torch.Tensor, vocab: int) -> Dict:
    """The log-softmax probability of the CHOSEN token plus the top
    ``TOP_LOGPROBS`` alternatives, from the logits row the choice used.
    row: (..., vocab_padded); chosen: (...,). Padded vocab columns are
    masked to -inf before the softmax. Returns {"lp": (...,) f32,
    "top_ids": (..., K) int, "top_lps": (..., K) f32}. Tied values may list
    their ids in another order than ``jax.lax.top_k``."""
    row = row.to(torch.float32)
    real = torch.arange(row.shape[-1], device=row.device) < vocab
    lp = torch.log_softmax(torch.where(real, row, torch.full_like(row, -torch.inf)), dim=-1)
    chosen_lp = torch.gather(lp, -1, chosen[..., None].long())[..., 0]
    top = torch.topk(lp, TOP_LOGPROBS, dim=-1)
    return {"lp": chosen_lp, "top_ids": top.indices, "top_lps": top.values}


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

def sampling_to_wire(sp: Optional[SamplingParams]) -> Optional[Dict]:
    """SamplingParams -> plain JSON/msgpack-able dict (transport frames)."""
    if sp is None:
        return None
    return {
        "temperature": sp.temperature, "top_k": sp.top_k, "top_p": sp.top_p,
        "repetition_penalty": sp.repetition_penalty, "seed": sp.seed,
        "stop": [list(seq) for seq in sp.stop],
    }


def sampling_from_wire(d: Optional[Dict]) -> Optional[SamplingParams]:
    """Inverse of :func:`sampling_to_wire`."""
    if d is None:
        return None
    return SamplingParams(
        temperature=float(d.get("temperature", 0.0)),
        top_k=int(d.get("top_k", 0)), top_p=float(d.get("top_p", 1.0)),
        repetition_penalty=float(d.get("repetition_penalty", 1.0)),
        seed=int(d.get("seed", 0)),
        stop=tuple(tuple(int(t) for t in seq) for seq in d.get("stop", ())))


def stop_match(tokens: Sequence[int],
               stop: Tuple[Tuple[int, ...], ...]) -> Optional[Tuple[int, ...]]:
    """Suffix-match generated tokens against stop sequences; returns the
    matched sequence (or None)."""
    if not stop:
        return None
    toks = tuple(tokens)
    for seq in stop:
        n = len(seq)
        if n <= len(toks) and toks[-n:] == seq:
            return seq
    return None
