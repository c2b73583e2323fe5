"""Model step (models/serve.py, model.py, moe.py) in the MoE cell: the
least time the window's model work needs at the published peaks
(portbench/work.py: the int8 projections, the shared experts' among them,
at the int8 peak; attention, the router and the routed experts at the
bf16 peak; no padding rows), as a share of the window. ``mfu``'s
yardstick, read in the cells that ``mfu`` does not list."""


def read(rec):
    return 100.0 * rec.work.least_s / rec.window_s
