"""The arithmetic of rates and tails, on the harness's own host stamps."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from portbench.loop import Record


def nearest_rank(values: Sequence[float], pct: float) -> Optional[float]:
    """The ``pct`` percentile by nearest rank: the smallest value with at
    least ``pct`` percent of the values at or below it. None when empty."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(pct / 100.0 * len(v)) - 1)]


def output_tok_s(rec: Record) -> float:
    """Output tokens over exactly the window's ``seconds``: every token of
    the steps that end inside it, and of the step that crosses its end the
    share of its tokens that its part inside the window is of its length
    (a step can last seconds, so whether it ends just inside or just
    outside would otherwise move the rate by its whole length). A window
    that its work closed takes its whole length, so all of its tokens
    count."""
    end = rec.t0 + rec.seconds
    tokens = 0.0
    for st in rec.steps:
        if st.end <= end:
            tokens += st.tokens
        elif st.start < end:
            tokens += st.tokens * (end - st.start) / (st.end - st.start)
    return tokens / rec.seconds


def ttfts_s(rec: Record) -> List[float]:
    """Time to first token of every request due inside the window, from
    when it was due; a failed request counts as infinitely late."""
    return [s.stamps[0] - s.due if s.stamps and not s.failed else math.inf
            for s in rec.arrivals()]


def itls_s(rec: Record) -> List[float]:
    """Every gap between consecutive output tokens of a request that ends
    inside the window, over all requests (tokens seen in one step are 0
    apart)."""
    return [b - a for s in rec.served for a, b in zip(s.stamps, s.stamps[1:])
            if rec.in_window(b)]
