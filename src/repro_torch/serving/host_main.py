"""Worker entry point of SubprocessTransport: one engine per OS process.

``python -m repro_torch.serving.host_main --socket PATH`` connects back to
the parent's AF_UNIX listener, receives an init frame ({model_spec,
engine_cfg}), rebuilds the weights from the spec (bitwise the parent's on
the same device type, see transport.realize_model_spec) under the mesh of
its ``model_parallel`` (launch/mesh.py) and enters the serve loop.

The loop free-runs the engine: between frames it calls ``pump()`` (one
engine step when there is work), polling the socket with a zero timeout
while busy and a short wait while idle. The Router never drives a worker's
engine step by step; it submits and harvests. Batch invariance is what makes
that safe: a free-running engine's tokens are a function of each request's
prompt and seed only.

Errors split two ways: application errors of a healthy engine (a refused
submit, an unknown preempt id) reply ``{"ok": False, "etype", "err"}`` and
the loop continues; anything that breaks the socket ends the process, and
the parent's TransportError handling takes over.
"""

from __future__ import annotations

import argparse
import os
import select
import socket
import sys


def serve(sock_path: str) -> int:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(sock_path)

    from repro_torch.serving.transport import Channel
    chan = Channel(sock)

    init = chan.recv(timeout=None)
    if init.get("op") != "init":
        chan.send({"seq": init.get("seq"), "ok": False, "etype": "RuntimeError",
                   "err": f"expected init frame, got {init.get('op')!r}"})
        return 2
    spec = init["args"]["model_spec"]

    # heavy imports after the handshake, so a connect failure is fast
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.transport import (
        EngineHost, engine_cfg_from_wire, realize_model_spec,
    )

    device = spec.get("device", "cuda")
    with shd.use_mesh(make_smoke_mesh(int(spec.get("model_parallel", 1)), device)):
        cfg, params, draft_cfg, draft_params = realize_model_spec(spec)
        ecfg = engine_cfg_from_wire(init["args"]["engine_cfg"], draft_cfg=draft_cfg)
        host = EngineHost(Engine(cfg, params, ecfg, device=device,
                                 draft_params=draft_params))
        chan.send({"seq": init.get("seq"), "ok": True, "val": {"pid": os.getpid()}})
        try:
            _loop(chan, host)
        finally:
            host.close()
    return 0


def _loop(chan, host) -> None:
    from repro_torch.serving.transport import TransportError
    while True:
        # busy: a zero-timeout poll between engine steps; idle: a short wait,
        # so an idle worker does not spin a core
        timeout = 0.0 if host.has_work() else 0.05
        ready, _, _ = select.select([chan.sock], [], [], timeout)
        if not ready:
            host.pump()
            continue
        try:
            frame = chan.recv(timeout=None)
        except TransportError:
            return                      # the parent went away
        seq, op = frame.get("seq"), frame.get("op")
        if op == "shutdown":
            try:
                chan.send({"seq": seq, "ok": True, "val": None})
            except TransportError:
                pass                    # the parent may already be gone
            return
        try:
            val = _dispatch(host, op, frame.get("args") or {})
            chan.send({"seq": seq, "ok": True, "val": val})
        except TransportError:
            return
        except Exception as e:          # application error: reply, keep serving
            try:
                chan.send({"seq": seq, "ok": False, "etype": type(e).__name__,
                           "err": str(e)})
            except TransportError:
                return


def _dispatch(host, op: str, args: dict):
    from repro_torch.serving.sampling import sampling_from_wire
    if op == "would_accept":
        return host.would_accept(int(args["plen"]), int(args["gen"]))
    if op == "lease_headroom":
        return host.lease_headroom(int(args["plen"]), int(args["gen"]))
    if op == "load":
        return host.load()
    if op == "submit":
        return host.submit(args["prompt"], int(args["gen"]),
                           sampling=sampling_from_wire(args.get("sampling")),
                           stop_history=tuple(int(t) for t in args.get("stop_history", ())),
                           want_logprobs=args.get("want_logprobs"))
    if op == "poll":
        cursors = {int(k): int(v) for k, v in (args.get("cursors") or {}).items()}
        return host.poll(cursors, drop=args.get("drop") or ())
    if op == "has_work":
        return host.has_work()
    if op == "evict_queued":
        return host.evict_queued(args.get("ids") or ())
    if op == "inflight":
        return host.inflight()
    if op == "preempt":
        return host.preempt(int(args["id"]))
    if op == "ship_blocks":
        return host.ship_blocks(int(args["id"]))
    if op == "recv_blocks":
        return host.recv_blocks(args["entry"])
    if op == "ack_ship":
        return host.ack_ship(args["payload_id"])
    if op == "embed":
        return host.embed(args["prompt"])
    if op == "stats":
        return host.stats()
    if op == "probe":
        return host.probe()
    raise ValueError(f"unknown op {op!r}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--socket", required=True,
                        help="AF_UNIX socket path of the parent's listener")
    args = parser.parse_args(argv)
    return serve(args.socket)


if __name__ == "__main__":
    sys.exit(main())
