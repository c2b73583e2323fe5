"""Host issue (models/moe.py): the values the MoE block read back to the
host in a decode step (the ``host_reads`` counter of the program's
``moe.experts`` spans: the sizing of ``torch.bincount`` and the longest
expert queue, each a wait for the device on a card), summed over the
spans under the window's decode instructions (``opq.run`` spans flagged
``decode`` that start inside the window) and divided by the number of
those instructions. Silent without the program's spans, and where no
decode instruction of the window holds an ``moe.experts`` span (a dense
model, or a program without the MoE spans)."""

from portbench import progspans


def read(rec):
    spans = progspans.spans(rec)
    if spans is None:
        return None
    lo, hi = int(rec.t0 * 1e9), int(rec.t_stop * 1e9)
    runs = {s.span_id for s in spans if s.name == "opq.run"
            and s.attrs.get("flags") == "decode" and lo <= s.start_ns < hi}
    parent = {s.span_id: s.parent_id for s in spans}
    reads = 0
    found = False
    for s in spans:
        if s.name != "moe.experts":
            continue
        up = s.parent_id
        while up is not None and up not in runs:
            up = parent.get(up)
        if up is not None:
            reads += s.attrs.get("host_reads", 0)
            found = True
    return reads / len(runs) if found else None
