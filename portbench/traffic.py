"""The one traffic generator: a mix file's parameters and ``--seed`` in,
requests out. The program receives only the prompts and output budgets.

A mix file (``traffic/<name>.json``) holds:

* ``loop``: ``"closed"``, ``clients`` users each sending its next request
  as soon as the last one finished, started ``ramp_wave`` at a time, one
  wave an engine step;
* ``prompt_len`` and ``output_len``: ``{"dist": "lognormal", "median",
  "sigma", "lo", "hi"}`` in tokens, a log-normal truncated to [lo, hi];
* ``source``: where the distributions come from.

Every seed sends the same sizes in the same order: the seed draws the
token ids, never the amount of work or its order. Client ``c`` sends
request ``c`` of every round, round ``j`` holding each client's ``j``-th
request, and every round covers both distributions once, at the
midpoints of ``clients`` equally likely strata, the prompt and output
strata dealt to the clients by permutations that are the same for every
seed. In a closed loop on a full pool the window serves some tens of
requests, about one round, and which of them it serves follows from every
size and arrival before it: sizes drawn anew for every seed moved the
window's work, and its rate, by some 15% from seed to seed, far more than
the host's noise does, and an order drawn anew would move it too. The
run's seed also draws
every token id (uniform over the configuration's vocabulary) and,
elsewhere, the weights.

Every request is greedy. Each client's first request, sent in the ramp,
is set-up traffic: the first round's request with the budget cut to a
share (i + 1/2) / clients of it, the shares dealt to the clients by a
permutation that is the same for every seed, so the first requests end
spread out as they would in a loop that had been running, and the window
can open as soon as every client has been admitted. Prompts are not cut:
the first requests fill the pool as the window's will.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

_SEED_MASK = (1 << 64) - 1
_NORMAL = NormalDist()
_DEAL = 0x5EED       # the stream of the deals that every seed shares


def stratified(dist: Dict, u: np.ndarray) -> np.ndarray:
    """Lengths at the points ``u`` in [0, 1) of the truncated
    distribution's probability: ``u`` = 0 is ``lo`` and ``u`` -> 1 is
    ``hi``."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    lo, hi = float(dist["lo"]), float(dist["hi"])
    mu, sigma = math.log(float(dist["median"])), float(dist["sigma"])
    f_lo, f_hi = (_NORMAL.cdf((math.log(x) - mu) / sigma) for x in (lo, hi))
    q = np.clip(f_lo + np.asarray(u, dtype=np.float64) * (f_hi - f_lo), 1e-12, 1 - 1e-12)
    v = np.exp(mu + sigma * np.array([_NORMAL.inv_cdf(float(x)) for x in q]))
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


class Traffic:
    """The requests of one mix for one seed, by index: request ``k`` is
    client ``k % clients``'s request of round ``k // clients``; its size is
    the same for every seed, its token ids in every run of that seed."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        if mix.get("loop") != "closed":
            raise ValueError(f"unknown loop {mix.get('loop')!r}")
        self.mix = mix
        self.vocab = vocab
        self.seed = int(seed) & _SEED_MASK
        self.clients = n = int(mix["clients"])
        self.ramp_wave = int(mix.get("ramp_wave", n))
        mid = (np.arange(n) + 0.5) / n
        self._lengths = (stratified(mix["prompt_len"], mid), stratified(mix["output_len"], mid))
        self._rounds: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._shares = np.random.default_rng([_DEAL, 4]).permutation(n)

    def prompt_range(self) -> Tuple[int, int]:
        """(shortest, longest) prompt the mix can send."""
        d = self.mix["prompt_len"]
        return int(d["lo"]), int(d["hi"])

    def key(self, client: int, j: int) -> int:
        """The index of ``client``'s ``j``-th request (0 is its first)."""
        return j * self.clients + client

    def sizes(self, k: int) -> Tuple[int, int]:
        """(prompt length, output budget) of request ``k``."""
        j, c = divmod(k, self.clients)
        deal = self._rounds.get(j)
        if deal is None:
            rng = np.random.default_rng([_DEAL, 5, j])
            deal = self._rounds[j] = (rng.permutation(self.clients),
                                      rng.permutation(self.clients))
        prompts, outputs = self._lengths
        return int(prompts[deal[0][c]]), int(outputs[deal[1][c]])

    def request(self, k: int) -> Tuple[np.ndarray, int]:
        """Request ``k``: its prompt (int32 token ids) and output budget."""
        p, o = self.sizes(k)
        ids = np.random.default_rng([self.seed, 1, k]).integers(0, self.vocab, p)
        return ids.astype(np.int32), o

    def ramp_request(self, k: int) -> Tuple[np.ndarray, int]:
        """Request ``k`` of the first round, its budget cut (module doc)."""
        prompt, budget = self.request(k)
        share = self._shares[k % self.clients]
        return prompt, max(1, int(budget * (share + 0.5) / self.clients))

    def warmup_prompt(self, length: int, i: int) -> np.ndarray:
        """A prompt for set-up only, from its own stream."""
        ids = np.random.default_rng([self.seed, 2, i]).integers(0, self.vocab, length)
        return ids.astype(np.int32)


def warmup_lengths(buckets: List[int], lo: int, hi: int) -> List[int]:
    """One prompt length for each prefill bucket that prompts of ``lo`` to
    ``hi`` tokens can reach (a prompt takes the first bucket at least its
    length): the longest such prompt in that bucket."""
    buckets = sorted(buckets)
    if hi > buckets[-1]:
        raise ValueError(f"prompt of {hi} tokens exceeds every bucket {buckets}")
    out, below = [], 0
    for b in buckets:
        if b >= lo and below < hi:
            out.append(min(b, hi))
        below = b
    return out
