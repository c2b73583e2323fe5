from repro_torch.ft.monitor import HeartbeatMonitor, HostState, plan_elastic_mesh  # noqa: F401
