"""What decides ``correct``: the tokens the timed path served, judged by
the plain reference.

Once the window has closed and the program's state is freed, a sample of
the requests the engine finished, drawn from the seed and always holding
the longest, is run once through the reference that the configuration
file's ``reference`` key names (``reference/decoder.py``, dense;
``reference/moe.py``, mixture of experts),
teacher-forced over each prompt and its served tokens. For every served
token the gap by which the reference's logit of that token lies below the
reference's best logit at that position is read. The widest gap of the
sample (``logit_gap``), the mean gap over its tokens (``mean_gap``) and the
90th percentile of the gaps (``p90_gap``) are compared with the cell's
limits, each where the cell's file sets one. A greedy server that computes
what the configuration states serves the reference's best token, or one
within rounding of it. In a mixture of experts, rounding can also change
which experts a token takes where two of them score within rounding of
each other, and such a position's gap is that of another function: it
moves the widest gap, and a few of them the mean, but not a percentile
below their share.

The control (``control_gaps``, read by ``calibrate.py`` and the tests, never
by a benchmark run) puts the reference in the program's place at the
precision below the configuration's, int4 weights: at each of the same
positions the token that the int4 reference ranks first is read against
the int8 reference the same way.
"""

from __future__ import annotations

import importlib
from pathlib import PurePosixPath
from types import ModuleType
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import stats
from portbench.loop import Record, served_tokens
from portbench.model import Model

SAMPLE_TOKENS = 320          # served tokens the sample holds at least

# the numbers a cell's limits may name, each read from the served-token gaps
READINGS = {
    "logit_gap": lambda g: float(np.max(g)),
    "mean_gap": lambda g: float(np.mean(g)),
    "p90_gap": lambda g: float(stats.nearest_rank(list(g), 90)),
}


def sample(rec: Record, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(prompt, served tokens) of the sampled finished requests: the one
    with the most served tokens, then others in an order drawn from the
    seed, until the sample holds SAMPLE_TOKENS tokens (or every finished
    request)."""
    done = [s for s in rec.served if s.finished is not None]
    if not done:
        return []
    done.sort(key=lambda s: (-len(s.req.tokens), s.k))
    rest = done[1:]
    order = np.random.default_rng([int(seed) & ((1 << 64) - 1), 3]).permutation(len(rest))
    picked = [done[0]] + [rest[i] for i in order]
    out, total = [], 0
    for s in picked:
        if total >= SAMPLE_TOKENS:
            break
        toks = served_tokens(s)
        out.append((np.asarray(s.req.prompt, dtype=np.int64), toks))
        total += len(toks)
    return out


def reference(c: Dict) -> ModuleType:
    """The plain reference module that configuration file ``c`` names: its
    ``reference`` key, a ``.py`` file under ``portbench/reference/``."""
    path = PurePosixPath(c["reference"])
    if path.parent != PurePosixPath("portbench/reference") or path.suffix != ".py":
        raise ValueError(f"{c['name']}: reference {c['reference']!r} is not a module "
                         f"under portbench/reference/")
    return importlib.import_module(f"portbench.reference.{path.stem}")


def reference_logits(c: Dict, m: Model, seed: int, samples, device, bits: int = 8):
    """The logits of configuration file ``c``'s reference, read with the
    sizes ``m``, at every served token's position of each sampled request,
    teacher-forced over its prompt and served tokens."""
    seqs = [torch.as_tensor(np.concatenate([p, t[:-1]]), device=device) for p, t in samples]
    return reference(c).logits(m, seed, seqs, [len(t) for _, t in samples], bits, device)


def served_gaps(ref, samples) -> np.ndarray:
    """Per served token: the reference's best logit minus its logit of the
    served token."""
    gaps = []
    for lg, (_, toks) in zip(ref, samples):
        t = torch.as_tensor(toks, device=lg.device)
        gaps.append((lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0]).cpu())
    return torch.cat(gaps).numpy().astype(np.float64)


def control_gaps(ref, low) -> np.ndarray:
    """The control's gaps: at each scored position, the int8 reference's
    best logit minus its logit of the token that the lower-precision
    reference's logits ``low`` rank first."""
    out = []
    for r, lo in zip(ref, low):
        pick = lo.argmax(dim=-1, keepdim=True)
        out.append((r.max(dim=-1).values - r.gather(1, pick)[:, 0]).cpu())
    return torch.cat(out).numpy().astype(np.float64)


def judge(c: Dict, m: Model, seed: int, rec: Record, limits: Dict, device) -> Dict:
    """The numbers compared, each beside its limit, the gaps read against
    configuration file ``c``'s reference with the sizes ``m``: ``READINGS``
    (``logit_gap``, the widest served-token gap; ``mean_gap``, the mean
    one; ``p90_gap``), each at most its limit in ``limits`` where it has
    one; ``served_tokens`` (the sample's size, at least SAMPLE_TOKENS or
    every finished request's tokens); ``failed`` (requests of the window
    that were refused or got no first token, at most 0)."""
    samples = sample(rec, seed)
    n_tok = int(sum(len(t) for _, t in samples))
    need = min(SAMPLE_TOKENS, int(sum(len(s.req.tokens) for s in rec.served
                                      if s.finished is not None)))
    gaps = (served_gaps(reference_logits(c, m, seed, samples, device), samples)
            if samples else np.asarray([np.inf]))
    out = {name: {"value": read(gaps), "max": float(limits[name])}
           for name, read in READINGS.items() if name in limits}
    out["served_tokens"] = {"value": n_tok, "min": max(need, 1)}
    out["failed"] = {"value": int(sum(s.failed for s in rec.arrivals())), "max": 0}
    return out


def passed(checks: Dict) -> bool:
    return all(("max" not in c or c["value"] <= c["max"])
               and ("min" not in c or c["value"] >= c["min"]) for c in checks.values())
