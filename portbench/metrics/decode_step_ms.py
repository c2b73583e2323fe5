"""Engine (serving/engine.py): the window's seconds over the decode steps
the engine counted in it (``EngineMetrics.decode_steps``), in ms. A step's
admission prefill is inside it."""


def read(rec):
    n = rec.counters.get("decode_steps", 0)
    return 1e3 * rec.window_s / n if n else None
