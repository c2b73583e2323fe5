"""The GPETPU runtime's operation queue (OPQ), over torch devices.

The port of ``repro.core.opq``'s serving subset: ``Buffer`` placement with
per-device copies, one execution lane per device, buffer-affinity
scheduling (an instruction
whose input is already resident on a device runs there), FCFS onto the
least-loaded lane otherwise, backup re-issue of a straggler on the fastest
lane, and the ``stats`` / ``flag_counts`` audit trail.

A backup re-issue runs an instruction a second time, so instructions must be
idempotent: the serving engine's decode step returns its advanced index as a
new tensor and its in-place pool writes rewrite the same cells with the same
values.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing


def device_key(device: torch.device) -> str:
    device = torch.device(device)
    return f"{device.type}:{device.index or 0}"


def to_device(tree: Any, device: torch.device) -> Any:
    """Place a pytree of tensors / numpy arrays on ``device`` (numpy arrays
    become tensors; tensors already there are returned as they are)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    if hasattr(tree, "to"):
        return tree.to(device)
    return tree


@dataclasses.dataclass
class Buffer:
    """``openctpu_buffer``: host data + a placement map keyed by device."""

    data: Any
    name: str = ""
    _on_device: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_device(self, device) -> Any:
        key = device_key(device)
        if key not in self._on_device:
            self._on_device[key] = to_device(self.data, torch.device(device))
        return self._on_device[key]

    @property
    def resident_devices(self) -> List[str]:
        return list(self._on_device)

    @classmethod
    def resident(cls, data: Any, device, name: str = "") -> "Buffer":
        """Wrap a pytree already living on ``device`` (no transfer), so the
        affinity policy pins follow-up work to the device that holds it."""
        buf = cls(data, name)
        buf._on_device[device_key(device)] = data
        return buf


@dataclasses.dataclass
class Instruction:
    fn: Callable
    buffers: Tuple[Buffer, ...]
    flags: str = ""
    span_parent: Optional[int] = None      # the span that issued it (tracing)


@dataclasses.dataclass
class _Lane:
    device: torch.device
    pending: int = 0
    ema_service_s: float = 1e-3

    def observe(self, dt: float) -> None:
        self.ema_service_s = 0.9 * self.ema_service_s + 0.1 * dt


class OPQ:
    """The operation-queue runtime over a set of torch devices (default:
    every CUDA card)."""

    def __init__(self, devices: Optional[Sequence[Any]] = None, *,
                 straggler_factor: float = 8.0, enable_backup_tasks: bool = True,
                 executor: Optional[Callable[[Instruction, Any], Any]] = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("OPQ: no CUDA card; pass devices= explicitly")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in devices]
        self.lanes = [_Lane(d) for d in self.devices]
        self.straggler_factor = straggler_factor
        self.enable_backup_tasks = enable_backup_tasks
        self._executor = executor or self._default_executor
        self._pool = ThreadPoolExecutor(max_workers=max(2, len(self.devices)))
        self._lock = threading.Lock()
        self.stats = {"issued": 0, "backups_issued": 0, "affinity_hits": 0}
        self.flag_counts: Dict[str, int] = defaultdict(int)

    # ------------------------------------------------------------------ API

    def invoke_operator(self, fn: Callable, *buffers: Buffer,
                        flags: str = "") -> Future:
        """Issue one instruction (``openctpu_invoke_operator``) and return
        its future; the caller owns the result."""
        return self._schedule(Instruction(fn, tuple(buffers), flags, tracing.current()))

    # ------------------------------------------------------------ scheduling

    def _pick_lane(self, ins: Instruction) -> Tuple[_Lane, bool]:
        for b in ins.buffers:
            for key in b.resident_devices:
                for lane in self.lanes:
                    if device_key(lane.device) == key:
                        return lane, True
        return min(self.lanes, key=lambda l: l.pending), False

    def _schedule(self, ins: Instruction) -> Future:
        lane, affinity = self._pick_lane(ins)
        with self._lock:
            self.stats["issued"] += 1
            self.flag_counts[ins.flags] += 1
            if affinity:
                self.stats["affinity_hits"] += 1
            lane.pending += 1
        return self._pool.submit(self._run_with_backup, ins, lane)

    def _run_with_backup(self, ins: Instruction, lane: _Lane):
        with tracing.span("opq.run", parent=ins.span_parent, flags=ins.flags):
            t0 = time.perf_counter()
            deadline = lane.ema_service_s * self.straggler_factor
            try:
                result = self._executor(ins, lane.device)
            except _StragglerTimeout:
                with self._lock:
                    self.stats["backups_issued"] += 1
                backup = min(self.lanes, key=lambda l: l.ema_service_s)
                result = self._executor(ins, backup.device)
            finally:
                with self._lock:
                    lane.pending -= 1
            dt = time.perf_counter() - t0
            lane.observe(dt)
            if self.enable_backup_tasks and dt > deadline and len(self.lanes) > 1:
                with self._lock:
                    self.stats["stragglers_detected"] = (
                        self.stats.get("stragglers_detected", 0) + 1)
            return result

    # ------------------------------------------------------------- executors

    @staticmethod
    def _default_executor(ins: Instruction, device: torch.device):
        args = [b.to_device(device) for b in ins.buffers]
        with tracing.span("opq.issue"):
            out = ins.fn(*args)
        if device.type == "cuda":
            # the lane's completion point (block_until_ready in the JAX runtime)
            with tracing.span("opq.sync"):
                torch.cuda.synchronize(device)
        return out

    def shutdown(self):
        self._pool.shutdown(wait=True)


class _StragglerTimeout(Exception):
    """Raised by injectable executors (tests) to trigger the backup path."""
