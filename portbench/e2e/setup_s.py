"""Seconds from the process's start to the window's start: loading, the
kernel builds of a first run, weights, warm-up and the ramp."""


def read(rec):
    return rec.setup_s
