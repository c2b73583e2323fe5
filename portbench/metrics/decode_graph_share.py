"""Host issue (core/opq.py lane, models/serve.py and model.py forwards):
the share of the window's decode instructions (``opq.run`` spans flagged
``decode`` that start inside the window) whose issue replayed the decode
step as one CUDA graph (a ``fwd.graph`` span under the instruction's
``opq.issue``), in %. Silent without the program's spans, and for a
program that has no graphed decode step (no
``repro_torch.models.decode_graph``)."""

import importlib.util

from portbench import progspans


def read(rec):
    spans = progspans.spans(rec)
    if spans is None or importlib.util.find_spec("repro_torch.models.decode_graph") is None:
        return None
    lo, hi = int(rec.t0 * 1e9), int(rec.t_stop * 1e9)
    runs = {s.span_id for s in spans if s.name == "opq.run"
            and s.attrs.get("flags") == "decode" and lo <= s.start_ns < hi}
    if not runs:
        return None
    run_of_issue = {s.span_id: s.parent_id for s in spans if s.name == "opq.issue"}
    replayed = {run_of_issue.get(s.parent_id) for s in spans if s.name == "fwd.graph"}
    return 100.0 * len(runs & replayed) / len(runs)
