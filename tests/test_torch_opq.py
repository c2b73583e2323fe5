"""The port's OPQ runtime (repro_torch.core.opq) beside the JAX package's
(repro.core.opq): the counterparts of tests/test_opq.py for what the port's
serving subset has — ``invoke_operator`` with buffer-affinity scheduling,
FCFS onto the least-loaded lane, backup re-issue of a straggler, the
post-hoc straggler detector and the ``stats``/``flag_counts`` audit trail.
The reference's task API (``enqueue``/``wait``/``sync``, ``track``) is not
in the port, and neither are its tests.

Results are held to numpy and to the reference's instruction on the same
inputs (elementwise f32: bitwise); scheduling counters to the reference
OPQ's on the same instruction sequence (exactly).
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.core import instr as JI
from repro.core.opq import OPQ as JOPQ, Buffer as JBuffer
from repro_torch.core import instr as TI
from repro_torch.core.opq import OPQ, Buffer, Instruction, _StragglerTimeout

CPU = torch.device("cpu")


def _mats(n=16, k=2, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, n)).astype(np.float32) for _ in range(k)]


def _affinity_run(opq_cls, buf_cls, kw, op, n_follow):
    """One first touch of a buffer pair, then ``n_follow`` instructions on
    the now-resident pair, each run to completion; returns the stats."""
    a, b = (buf_cls(m) for m in _mats())
    q = opq_cls(**kw)
    futs = [q.invoke_operator(op, a, b)]
    futs[0].result()
    for _ in range(n_follow):
        futs.append(q.invoke_operator(op, a, b))
        futs[-1].result()
    stats = dict(q.stats)
    q.shutdown()
    return stats


@pytest.mark.parametrize("n_follow", [1, 5])
def test_affinity_hit_accounting_matches_reference(n_follow):
    """issued/affinity_hits reconcile, as the reference's do: the first
    touch of a buffer pair is a miss, every follow-up on the now-resident
    pair a hit."""
    got = _affinity_run(OPQ, Buffer, {"devices": [CPU]}, TI.mul_fp, n_follow)
    ref = _affinity_run(JOPQ, JBuffer, {}, JI.mul_fp, n_follow)
    assert got["issued"] == ref["issued"] == 1 + n_follow
    assert got["affinity_hits"] == ref["affinity_hits"] == n_follow


@pytest.mark.parametrize("name", ["add_fp", "sub_fp", "mul_fp"])
def test_invoke_operator_results_match_reference(name):
    """An instruction through the port's OPQ returns what the reference's
    instruction returns on the same inputs, bitwise, and the numpy result."""
    x, y = _mats()
    q = OPQ([CPU])
    got = q.invoke_operator(getattr(TI, name), Buffer(x), Buffer(y)).result()
    q.shutdown()
    ref = np.asarray(getattr(JI, name)(x, y))
    np.testing.assert_array_equal(got.numpy(), ref)
    want = {"add_fp": x + y, "sub_fp": x - y, "mul_fp": x * y}[name]
    np.testing.assert_array_equal(got.numpy(), want)


def test_fcfs_least_loaded():
    """Without affinity the policy picks a lane, and the least loaded one."""
    q = OPQ([CPU, CPU])
    q.lanes[0].pending = 3
    lane, aff = q._pick_lane(Instruction(TI.add_fp, tuple(Buffer(m) for m in _mats())))
    assert lane is q.lanes[1] and aff is False
    q.shutdown()


def test_affinity_pins_to_the_resident_device():
    """A buffer already resident on a device pins the instruction there."""
    q = OPQ([CPU])
    a = Buffer.resident(torch.ones(4), CPU, name="a")
    lane, aff = q._pick_lane(Instruction(TI.add_fp, (a, Buffer(torch.ones(4)))))
    assert lane is q.lanes[0] and aff is True
    q.shutdown()


def test_straggler_backup_reissue():
    """An injected straggling executor triggers the backup re-issue: the
    result is right and the instruction ran twice."""
    calls = {"n": 0}

    def flaky(ins: Instruction, device):
        calls["n"] += 1
        if calls["n"] == 1:
            raise _StragglerTimeout()
        return OPQ._default_executor(ins, device)

    x, y = _mats()
    q = OPQ([CPU], executor=flaky)
    out = q.invoke_operator(TI.add_fp, Buffer(x), Buffer(y)).result()
    np.testing.assert_array_equal(out.numpy(), x + y)
    assert q.stats["backups_issued"] == 1 and calls["n"] == 2
    q.shutdown()


def test_backup_reissue_result_correct_under_repeated_straggling():
    """Every instruction straggles on its first attempt; the backup path
    still returns the right result for each."""
    attempts = {}
    held = []                                   # keep ids from being reused
    lock = threading.Lock()

    def flaky(ins: Instruction, device):
        with lock:
            held.append(ins)
            attempts[id(ins)] = attempts.get(id(ins), 0) + 1
            first = attempts[id(ins)] == 1
        if first:
            raise _StragglerTimeout()
        return OPQ._default_executor(ins, device)

    q = OPQ([CPU], executor=flaky)
    pairs = [_mats(seed=s) for s in range(4)]
    futs = [q.invoke_operator(TI.sub_fp, Buffer(a), Buffer(b)) for a, b in pairs]
    for fut, (a, b) in zip(futs, pairs):
        np.testing.assert_array_equal(fut.result().numpy(), a - b)
    assert q.stats["backups_issued"] == 4
    q.shutdown()


def test_straggler_detection_with_injected_slow_executor():
    """A wall-clock-slow executor on a two-lane queue trips the post-hoc
    detector: fast instructions warm the lane's service-time EMA, then one
    takes far longer than ``straggler_factor`` times it."""
    calls = {"n": 0}

    def slow_once(ins: Instruction, device):
        calls["n"] += 1
        if calls["n"] == 8:
            time.sleep(0.25)
        return OPQ._default_executor(ins, device)

    q = OPQ([CPU, CPU], straggler_factor=2.0, executor=slow_once)
    a, b = (Buffer(m) for m in _mats(4))
    for _ in range(8):
        q.invoke_operator(TI.add_fp, a, b).result()
    assert q.stats.get("stragglers_detected", 0) >= 1
    assert q.stats["issued"] == 8
    q.shutdown()


def test_flag_counts_audit_trail():
    """Every instruction is counted under its flags, as the serving
    engine's dispatch audit reads them."""
    q = OPQ([CPU])
    a, b = (Buffer(m) for m in _mats())
    for flags in ("prefill/16", "decode", "decode"):
        q.invoke_operator(TI.add_fp, a, b, flags=flags).result()
    assert dict(q.flag_counts) == {"prefill/16": 1, "decode": 2}
    q.shutdown()


def test_opq_without_card_needs_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        OPQ()

