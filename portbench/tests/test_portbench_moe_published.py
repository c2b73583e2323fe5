"""The MoE cell's readers on synthetic records (``mfu.moe``,
``expert_roofline``, ``moe_syncs_per_step``), each silent where its trace
or spans are absent, and the cell's reduced case on the CPU read with the
port's former MoE block (renormalised gates, or no leading dense layer):
the comparison takes neither."""

import dataclasses
import types

import pytest
import torch

import pbtest

from portbench import check, spec
from portbench.loop import Record
from portbench.model import Model
from portbench.run import execute
from portbench.work import Work
from repro_torch.tracing import Span

CELL = "deepseek-moe-16b.chat"
M = Model(family="moe", n_layers=2, d_model=8, n_heads=1, n_kv=1, head_dim=8, vocab=16,
          d_ff=8, n_experts=4, n_shared=1, topk=2, expert_ff=8, first_k_dense=1)
MS = 1_000_000
SEED = 3_100_000_007


def _reader(name):
    return spec.reader("metrics", name)


def _record(spans=None, ops=None, work=None):
    """A window of 1 s from t = 1 s; ``ops`` (name, start_ns, end_ns)
    device operations on the host's clock; ``spans`` the program's."""
    rec = Record(model=M, t0=1.0, seconds=1.0, t_stop=2.0)
    rec.work = work or Work()
    if spans is not None or ops is not None:
        ops = ops or []
        rec.trace = types.SimpleNamespace(
            ops=ops, offset_ns=0, window_s=1.0, program_spans=spans,
            device_s=lambda match, phase=None: sum(b - a for n, a, b in ops if match(n)) / 1e9)
    return rec


def test_the_cell_reports_the_new_metrics():
    names = {e["name"] for e in spec.cell(CELL).per_layer}
    assert {"mfu.moe", "expert_roofline", "moe_syncs_per_step"} <= names
    for e in spec.manifest()["per_layer"]:
        if e["name"] in ("mfu.moe", "expert_roofline", "moe_syncs_per_step"):
            assert e["workloads"] == [CELL]


def test_mfu_moe_is_the_least_time_over_the_window():
    work = Work(int8_ops=1979e12 * 0.01, float_flops=989e12 * 0.02)
    assert _reader("mfu.moe")(_record(work=work)) == pytest.approx(3.0)


def _expert_ops():
    roof = _reader("expert_roofline").__globals__["KERNELS"]
    ops = [(name, 1_100 * MS + 10 * MS * i, 1_100 * MS + 10 * MS * i + 4 * MS)
           for i, name in enumerate(roof)]
    ops.append(("void moe_expert_gemm<64>", 1_500 * MS, 1_504 * MS))
    ops.append(("void qgemm_kernel<4, 2>", 1_600 * MS, 1_640 * MS))
    return ops, 4e-3 * (len(roof) + 1)


def test_expert_roofline_is_the_bound_over_the_expert_kernels():
    ops, busy = _expert_ops()
    rec = _record(spans=[], ops=ops, work=Work(expert_least_s=busy / 4))
    assert _reader("expert_roofline")(rec) == pytest.approx(25.0)


def test_expert_roofline_is_silent_without_a_trace_or_expert_work():
    read = _reader("expert_roofline")
    assert read(_record(work=Work(expert_least_s=1.0))) is None
    assert read(_record(spans=[], ops=[("void qgemm_kernel<4, 2>", 0, MS)])) is None


def _decode_step(out, ids, a, flags, reads, moe_layers=1):
    """An instruction at ``a`` ms: opq.run > opq.issue > fwd.layer (the
    dense one, then ``moe_layers`` MoE ones) > fwd.ffn > fwd.moe >
    moe.experts carrying ``reads`` host reads."""
    r, i = next(ids), next(ids)
    t = a * MS
    out.append(Span("opq.run", t, t + 40 * MS, r, None, 1, {"flags": flags}))
    out.append(Span("opq.issue", t + MS, t + 30 * MS, i, r, 1, {}))
    for layer in range(1 + moe_layers):
        lid, fid = next(ids), next(ids)
        out.append(Span("fwd.layer", t + 2 * MS, t + 3 * MS, lid, i, 1, {"i": layer}))
        out.append(Span("fwd.ffn", t + 2 * MS, t + 3 * MS, fid, lid, 1, {}))
        if layer:
            mid = next(ids)
            out.append(Span("fwd.moe", t + 2 * MS, t + 3 * MS, mid, fid, 1, {}))
            out.append(Span("moe.experts", t + 2 * MS, t + 3 * MS, next(ids), mid, 1,
                            {"pairs": 12, "passes": 1, "host_reads": reads}))


def _spans():
    out, ids = [], iter(range(1, 10_000))
    _decode_step(out, ids, 900, "decode", 7)                # before the window
    for k in range(4):
        _decode_step(out, ids, 1_000 + 60 * k, "decode", 2, moe_layers=27)
    _decode_step(out, ids, 1_300, "prefill/1024", 9)       # an admission
    return out


def test_moe_syncs_per_step_counts_the_reads_of_the_windows_decode_steps():
    assert _reader("moe_syncs_per_step")(_record(spans=_spans())) == 54.0


def test_moe_syncs_per_step_is_silent_without_spans_or_moe_blocks():
    read = _reader("moe_syncs_per_step")
    assert read(_record()) is None
    assert read(_record(spans=[])) is None
    dense = [s for s in _spans() if not s.name.startswith(("moe.", "fwd.moe"))]
    assert read(_record(spans=dense)) is None


@pytest.mark.parametrize("former", [{"norm_topk_prob": True}, {"first_k_dense": 0}],
                         ids=["renormalised_gates", "no_dense_layer"])
def test_the_former_block_does_not_take_the_served_tokens(former):
    cpu = torch.device("cpu")
    cell = pbtest.smoke_cell(CELL)
    rec, _, checks = execute(cell, SEED, 2.0, False, cpu)
    assert check.passed(checks), checks
    m = dataclasses.replace(Model.from_config(cell.config), **former)
    assert not check.passed(check.judge(cell.config, m, SEED, rec, cell.limits, cpu))
