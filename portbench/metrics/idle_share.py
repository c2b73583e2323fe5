"""Device (H100): the share of the traced window in which no operation ran
on the device (torch.profiler's CUDA activity)."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
