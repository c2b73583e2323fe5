"""Admission as the host paces it: the 90th percentile (nearest rank) of
time to first token, in ms, over the requests due in the window, where
the cell's traced device is idle most of the window or fewer than 100
requests arrive in it."""

from portbench import stats


def read(rec):
    v = stats.nearest_rank(stats.ttfts_s(rec), 90)
    return None if v is None else 1e3 * v
