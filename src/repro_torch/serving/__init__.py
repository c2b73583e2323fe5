"""Continuous-batching serving engine on the OPQ runtime (see engine.py)."""

from repro_torch.serving.engine import (  # noqa: F401
    Engine, EngineConfig, QueueFull, Request, RequestState,
)
from repro_torch.serving.metrics import (  # noqa: F401
    EngineMetrics, RequestMetrics, format_memory_stats,
)
from repro_torch.serving.scheduler import Scheduler, bucket_for, default_buckets  # noqa: F401
from repro_torch.serving.store import PagedKVStore, pristine_value  # noqa: F401
