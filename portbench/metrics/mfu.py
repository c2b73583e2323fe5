"""Model step (models/serve.py, model.py, attention.py): the least time the
window's model work needs at the published peaks (portbench/work.py: int8
projections at the int8 peak, attention at the bf16 peak, no padding
rows), as a share of the window."""


def read(rec):
    return 100.0 * rec.work.least_s / rec.window_s
