"""Continuous-batching serving engine on the OPQ runtime (see engine.py).

Multi-host: :class:`Router` (router.py) fronts one host per
:class:`HostTransport` (transport.py) with cache-affinity placement,
load-aware spill, drain/handoff, host-loss recovery and prefill/decode
disaggregation. Hosts are in-process engines (``build_inproc_fleet``, the
default) or OS processes (``SubprocessTransport`` with host_main.py workers
speaking framed RPC over a local socket). ``serve_api`` (api.py) fronts an
Engine or a Router over HTTP.
"""

from repro_torch.serving.engine import (  # noqa: F401
    Engine, EngineConfig, QueueFull, Request, RequestState,
)
from repro_torch.serving.metrics import (  # noqa: F401
    EngineMetrics, RequestMetrics, TransportMetrics, format_memory_stats,
    format_router_stats, format_sampling_stats, format_spec_stats,
    format_transport_stats,
)
from repro_torch.serving.transport import (  # noqa: F401
    EngineHost, HostTransport, InProcessTransport, SubprocessTransport,
    TransportError, build_inproc_fleet, build_model_spec, realize_model_spec,
)
from repro_torch.serving.router import (  # noqa: F401
    Router, RouterConfig, RouterRequest,
)
from repro_torch.serving.sampling import (  # noqa: F401
    GREEDY, SamplingParams, sample_tokens, stop_match,
)
from repro_torch.serving.api import ApiServer, serve_api  # noqa: F401
from repro_torch.serving.scheduler import Scheduler, bucket_for, default_buckets  # noqa: F401
from repro_torch.serving.store import (  # noqa: F401
    ContiguousKVStore, PagedKVStore, SlotStore, make_store, pristine_value,
)
