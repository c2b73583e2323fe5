"""The one traffic generator: a mix file's parameters and ``--seed`` in,
requests out. The program receives only the prompts and output budgets.

A mix file (``traffic/<name>.json``) holds:

* ``loop``: ``"closed"``, ``clients`` users each sending its next request
  as soon as the last one finished, started ``ramp_wave`` at a time, one
  wave an engine step;
* ``prompt_len`` and ``output_len``: ``{"dist": "lognormal", "median",
  "sigma", "lo", "hi"}`` in tokens, a log-normal truncated to [lo, hi];
* ``block``: the sizes are drawn in blocks of this many requests;
* ``source``: where the distributions come from.

Every size is drawn from the run's seed, stratified: in each block,
request ``i``'s prompt length is drawn inside the ``i``-th of ``block``
equally likely strata of the prompt distribution, its output length
inside a stratum of the output distribution that a permutation drawn from
the seed pairs with it, and the block is sent in an order drawn from the
seed. So every seed sends its own sizes, tails included, while each block
covers both distributions once: in a closed loop the window serves some
tens of requests, and independent draws would change its work from seed
to seed by far more than the host's noise does. The run's seed also draws
every token id (uniform over the configuration's vocabulary) and,
elsewhere, the weights.

Every request is greedy. Each client's first request, sent in the ramp,
is set-up traffic: the mix's request with its budget cut to a share
(i + 1/2) / clients of it, the shares in an order drawn from the seed, so
the first requests end spread out as they would in a loop that had been
running, and the window can open as soon as every client has been
admitted. Prompts are not cut: the first requests fill the pool as the
window's will.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

_SEED_MASK = (1 << 64) - 1
_NORMAL = NormalDist()


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
    """The requests of one mix for one seed, by index: request ``k`` has
    the same size and token ids in every run of that seed."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        if mix.get("loop") != "closed":
            raise ValueError(f"unknown loop {mix.get('loop')!r}")
        self.mix = mix
        self.vocab = vocab
        self.seed = int(seed) & _SEED_MASK
        self.clients = int(mix["clients"])
        self.ramp_wave = int(mix.get("ramp_wave", self.clients))
        self.block = int(mix["block"])
        self._blocks: Dict[int, np.ndarray] = {}
        self._shares = np.random.default_rng([self.seed, 4]).permutation(self.clients)

    def prompt_range(self) -> Tuple[int, int]:
        """(shortest, longest) prompt the mix can send."""
        d = self.mix["prompt_len"]
        return int(d["lo"]), int(d["hi"])

    def _sizes(self, b: int) -> np.ndarray:
        """Block ``b``'s (prompt, output) sizes in the order they are sent."""
        sizes = self._blocks.get(b)
        if sizes is None:
            n = self.block
            rng = np.random.default_rng([self.seed, 5, b])
            strata = np.arange(n)
            prompts = stratified(self.mix["prompt_len"], (strata + rng.random(n)) / n)
            outputs = stratified(self.mix["output_len"], (strata + rng.random(n)) / n)
            sizes = np.stack([prompts, outputs[rng.permutation(n)]], axis=1)
            sizes = sizes[rng.permutation(n)]
            self._blocks[b] = sizes
        return sizes

    def sizes(self, k: int) -> Tuple[int, int]:
        """(prompt length, output budget) of request ``k``."""
        b, i = divmod(k, self.block)
        p, o = self._sizes(b)[i]
        return int(p), int(o)

    def request(self, k: int) -> Tuple[np.ndarray, int]:
        """Request ``k``: its prompt (int32 token ids) and output budget."""
        p, o = self.sizes(k)
        ids = np.random.default_rng([self.seed, 1, k]).integers(0, self.vocab, p)
        return ids.astype(np.int32), o

    def ramp_request(self, k: int, client: int) -> Tuple[np.ndarray, int]:
        """Request ``k`` as ``client``'s first, cut (module doc)."""
        prompt, budget = self.request(k)
        return prompt, max(1, int(budget * (self._shares[client] + 0.5) / self.clients))

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
