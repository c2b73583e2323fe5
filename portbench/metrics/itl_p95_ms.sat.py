"""Engine (serving/engine.py) as a caller feels it: the 95th percentile
(nearest rank) of the gaps between consecutive output tokens, in ms, over
every gap that ends inside the window. A per-layer reading because the
cell's closed loop runs above capacity (clients queue on a full pool),
where a tail swings with the smallest change."""

from portbench import stats


def read(rec):
    v = stats.nearest_rank(stats.itls_s(rec), 95)
    return None if v is None else 1e3 * v
