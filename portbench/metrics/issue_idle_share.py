"""Host issue (core/opq.py lane, models/serve.py and model.py forwards):
the share of the traced window in which the device was idle while the
host was inside an instruction's issue, the idle gaps whose innermost
program span is ``opq.issue`` or a forward span (``fwd.*``;
``portbench/progspans.py``). Part of ``idle_share``."""

from portbench import progspans


def read(rec):
    idle = progspans.idle_by_span(rec)
    if idle is None or rec.trace.window_s <= 0:
        return None
    s = sum(v for name, v in idle.items() if name == "opq.issue" or name.startswith("fwd."))
    return 100.0 * s / rec.trace.window_s
