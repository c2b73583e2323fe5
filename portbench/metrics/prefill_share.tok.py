"""Admission (``Engine._admit``, models/serve.py prefill): the engine's own
wall time blocked on prefills in the window (``prefill_wait_s``), as a
share of the window."""


def read(rec):
    return 100.0 * rec.counters.get("prefill_wait_s", 0.0) / rec.window_s
