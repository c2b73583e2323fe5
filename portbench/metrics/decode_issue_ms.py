"""Host issue (core/opq.py lane, models/serve.py and model.py forwards):
the mean time the OPQ lane spends issuing a decode instruction's forward
and sampling from the host (the program's ``opq.issue`` spans under an
``opq.run`` flagged ``decode``), over the decode instructions that start
inside the window, in ms. The lane's completion wait (``opq.sync``) is not
in it."""

from portbench import progspans


def read(rec):
    spans = progspans.spans(rec)
    if spans is None:
        return None
    runs = {s.span_id for s in spans if s.name == "opq.run" and s.attrs.get("flags") == "decode"}
    lo, hi = int(rec.t0 * 1e9), int(rec.t_stop * 1e9)
    issue = [s.end_ns - s.start_ns for s in spans
             if s.name == "opq.issue" and s.parent_id in runs and lo <= s.start_ns < hi]
    return 1e-6 * sum(issue) / len(issue) if issue else None
