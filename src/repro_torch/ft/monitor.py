"""Fault tolerance: failure detection and elastic re-mesh planning, the
port of ``repro.ft.monitor`` (pure Python).

The failure model: a host stops heartbeating (hardware, preemption) or
straggles (thermal, network). The control loop:

  1. ``HeartbeatMonitor`` detects missing or late heartbeats;
  2. ``plan_elastic_mesh`` computes the largest valid (data, model) mesh
     from the surviving hosts: the model-parallel degree is kept (a model
     shard must still fit), the data axis shrinks to what divides the
     global batch;
  3. the driver rebuilds the mesh, reloads the last checkpoint
     (checkpoint/store.py), restores the data iterator's state and
     resumes, keeping the global batch by raising per-host accumulation
     (``grad_accum``) when the data axis shrank.

Stragglers: the monitor keeps an EMA of each host's step latency and
flags hosts above ``straggler_factor`` times the median, so the driver
can evict them at the next checkpoint boundary rather than let one slow
host gate every all-reduce.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class HostState:
    last_beat: float
    step_ema_s: float = 0.0
    beats: int = 0


class HeartbeatMonitor:
    def __init__(self, hosts: List[str], *, timeout_s: float = 60.0,
                 straggler_factor: float = 3.0, clock=time.monotonic):
        self._clock = clock
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        now = self._clock()
        self.hosts: Dict[str, HostState] = {h: HostState(last_beat=now) for h in hosts}

    def beat(self, host: str, step_latency_s: Optional[float] = None) -> None:
        st = self.hosts[host]
        st.last_beat = self._clock()
        st.beats += 1
        if step_latency_s is not None:
            st.step_ema_s = (0.8 * st.step_ema_s + 0.2 * step_latency_s
                             if st.beats > 1 else step_latency_s)

    def dead_hosts(self) -> List[str]:
        now = self._clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_beat > self.timeout_s]

    def stragglers(self) -> List[str]:
        lat = sorted(st.step_ema_s for st in self.hosts.values() if st.step_ema_s > 0)
        if not lat:
            return []
        median = lat[len(lat) // 2]
        return [h for h, st in self.hosts.items()
                if st.step_ema_s > self.straggler_factor * max(median, 1e-9)]

    def healthy_hosts(self) -> List[str]:
        bad = set(self.dead_hosts()) | set(self.stragglers())
        return [h for h in self.hosts if h not in bad]


def plan_elastic_mesh(
    n_surviving_hosts: int,
    chips_per_host: int,
    model_parallel: int,
    *,
    old_data_parallel: int,
    global_batch: int,
) -> Dict:
    """The largest valid mesh from the survivors, and the accumulation
    factor that keeps the global batch. The model-parallel degree is
    fixed; the data axis becomes the largest size that divides the global
    batch."""
    chips = n_surviving_hosts * chips_per_host
    if chips < model_parallel:
        raise RuntimeError(
            f"not enough chips ({chips}) for model_parallel={model_parallel}")
    new_dp = chips // model_parallel
    while new_dp > 0 and global_batch % new_dp != 0:
        new_dp -= 1
    if new_dp == 0:
        raise RuntimeError("no valid data-parallel size for the global batch")
    grad_accum = max(1, old_data_parallel // new_dp)
    return {
        "mesh_shape": (new_dp, model_parallel),
        "axis_names": ("data", "model"),
        "chips_used": new_dp * model_parallel,
        "chips_idle": chips - new_dp * model_parallel,
        "grad_accum": grad_accum,
        "note": "reload latest checkpoint with checkpoint.load_checkpoint("
                "shardings=<new mesh specs>); restore data iterator state",
    }
