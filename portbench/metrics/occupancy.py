"""Scheduler (serving/scheduler.py): the mean number of slots in flight
over the window's engine steps (``occupancy_sum`` over ``steps``)."""


def read(rec):
    n = rec.counters.get("steps", 0)
    return rec.counters["occupancy_sum"] / n if n else None
