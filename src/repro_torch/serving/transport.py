"""HostTransport: the Router<->host boundary as a protocol — the port of
``repro.serving.transport``.

The Router reaches a host only through :class:`HostTransport`. Two backends:

  * :class:`InProcessTransport` — an :class:`EngineHost` wrapping an Engine
    in the caller's address space; the Router drives it one engine step per
    fleet step through ``pump()``.
  * :class:`SubprocessTransport` — one OS process per host running the
    ``serving/host_main.py`` worker loop, speaking length-prefixed
    msgpack-or-JSON frames over an AF_UNIX socket. The worker free-runs its
    engine between requests, which is correct because the engine is
    batch-invariant and greedy or seeded decode is a pure function of the
    token prefix.

Failure semantics: every RPC carries a ``seq`` number and a reply with a
stale seq is discarded. Idempotent calls (door predicates, polls, stats,
probes, the block-shipping trio) retry a bounded number of times with a
fresh seq on timeout; ``submit``, ``evict_queued`` and ``preempt`` never
retry: a failure raises :class:`TransportError`, and the Router marks the
host lost and re-admits its streams from the tokens already harvested.
A token counts as emitted once the Router has polled it, so a killed worker
loses only un-harvested tokens, which determinism regenerates.

Workers rebuild their weights from a *model spec* (arch, smoke, overrides,
quantize, seed, device) the way the port's CLI builds them: a
``torch.Generator`` seeded with the spec's seed on the spec's device, then
W8A8 through the serve predicate — bitwise the parent's weights on the same
device type, so no weights cross the socket. On the card the parent builds
every kernel before it starts a worker; workers load the libraries from
``build/kernels/`` and build nothing themselves.
"""

from __future__ import annotations

import base64
import dataclasses
import itertools
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np

from repro_torch.serving.engine import Engine, EngineConfig, QueueFull, Request, RequestState
from repro_torch.serving.metrics import TransportMetrics, now
from repro_torch.serving.sampling import SamplingParams, sampling_from_wire, sampling_to_wire

try:                                   # optional: frames fall back to JSON
    import msgpack
except ImportError:                    # pragma: no cover - environment-dependent
    msgpack = None

__all__ = [
    "TransportError", "HostTransport", "EngineHost", "InProcessTransport",
    "SubprocessTransport", "Channel", "build_inproc_fleet",
    "build_model_spec", "realize_model_spec",
    "engine_cfg_to_wire", "engine_cfg_from_wire", "QueueFull",
]

MAX_FRAME_BYTES = 64 * 1024 * 1024     # sanity bound on one frame


class TransportError(Exception):
    """Host-level transport failure: timeout, dropped connection, dead
    worker. Application errors of a healthy host re-raise as their own type;
    this one is the Router's cue to mark the host lost."""


# --------------------------------------------------------------------- codec

def _sanitize(x):
    """Python/numpy tree -> plain JSON/msgpack-able tree (ndarrays as
    dtype/shape/base64 triples, numpy scalars as Python scalars)."""
    if isinstance(x, np.ndarray):
        return {"__nd__": True, "dtype": str(x.dtype), "shape": list(x.shape),
                "b64": base64.b64encode(np.ascontiguousarray(x).tobytes()).decode("ascii")}
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, dict):
        return {k: _sanitize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_sanitize(v) for v in x]
    return x


def _restore(x):
    if isinstance(x, dict):
        if x.get("__nd__"):
            arr = np.frombuffer(base64.b64decode(x["b64"]), dtype=np.dtype(x["dtype"]))
            return arr.reshape([int(s) for s in x["shape"]]).copy()
        return {k: _restore(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_restore(v) for v in x]
    return x


def default_codec() -> str:
    return "msgpack" if msgpack is not None else "json"


def encode_frame(obj, codec: Optional[str] = None) -> bytes:
    """Object -> one frame body: 1 codec byte + payload."""
    tree = _sanitize(obj)
    codec = codec or default_codec()
    if codec == "msgpack":
        return b"M" + msgpack.packb(tree, use_bin_type=True)
    return b"J" + json.dumps(tree).encode()


def decode_frame(body: bytes):
    """Inverse of :func:`encode_frame`, dispatching on the codec byte."""
    if body[:1] == b"M":
        if msgpack is None:
            raise TransportError("received a msgpack frame but msgpack is not "
                                 "importable here")
        return _restore(msgpack.unpackb(body[1:], raw=False, strict_map_key=False))
    return _restore(json.loads(body[1:].decode()))


class Channel:
    """Length-prefixed frames over a stream socket: the seam the fault
    injection tests wrap (drop, duplicate or delay frames here)."""

    def __init__(self, sock: socket.socket, codec: Optional[str] = None):
        self.sock = sock
        self.codec = codec or default_codec()

    def send(self, obj) -> None:
        body = encode_frame(obj, self.codec)
        try:
            self.sock.sendall(struct.pack(">I", len(body)) + body)
        except OSError as e:
            raise TransportError(f"frame send failed: {e}") from e

    def recv(self, timeout: Optional[float] = None):
        try:
            self.sock.settimeout(timeout)
            (n,) = struct.unpack(">I", self._read_exact(4))
            if n > MAX_FRAME_BYTES:
                raise TransportError(f"frame of {n} bytes exceeds the "
                                     f"{MAX_FRAME_BYTES} bound")
            return decode_frame(self._read_exact(n))
        except socket.timeout as e:
            raise TransportError(f"frame recv timed out after {timeout}s") from e
        except OSError as e:
            raise TransportError(f"frame recv failed: {e}") from e

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise TransportError("connection closed (EOF)")
            buf += chunk
        return bytes(buf)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------- wire forms

def engine_cfg_to_wire(ecfg: Optional[EngineConfig]) -> Dict:
    """EngineConfig -> plain dict. The ``draft`` ArchConfig is dropped: the
    worker rebuilds it from the model spec's ``draft`` entry."""
    d = dataclasses.asdict(ecfg or EngineConfig())
    d.pop("draft", None)
    if d.get("buckets") is not None:
        d["buckets"] = [int(b) for b in d["buckets"]]
    return d


def engine_cfg_from_wire(d: Dict, draft_cfg=None) -> EngineConfig:
    d = dict(d)
    if d.get("buckets") is not None:
        d["buckets"] = tuple(int(b) for b in d["buckets"])
    return EngineConfig(**d, draft=draft_cfg)


def build_model_spec(arch: str, *, smoke: bool = True, quantize: str = "off",
                     overrides: Optional[Dict] = None, seed: int = 0,
                     draft_arch: Optional[str] = None, model_parallel: int = 1,
                     device=None) -> Dict:
    """The recipe a worker rebuilds its weights from: registry arch name,
    smoke scaling, ArchConfig field overrides, the quantize mode, the
    generator seed, the model axis of the worker's mesh and the device
    (``cuda`` unless the caller names another). Same spec and device type
    => bitwise the same weights. The draft (speculative decode) is built
    from the same seed and quantize mode, as the CLI builds it."""
    spec = {"arch": arch, "smoke": bool(smoke), "quantize": quantize,
            "overrides": dict(overrides or {}), "seed": int(seed),
            "model_parallel": int(model_parallel), "device": str(device or "cuda")}
    if draft_arch:
        spec["draft"] = {"arch": draft_arch, "smoke": bool(smoke), "quantize": quantize,
                         "seed": int(seed)}
    return spec


def _build_weights(entry: Dict, device):
    """(cfg, params) of one spec entry, as ``launch/serve.py`` builds them:
    W8A8 through the streamed build (layer by layer, bitwise the quantized
    whole-model init)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import quant_predicate
    from repro_torch.models import init_model
    from repro_torch.models.model import init_model_quantized
    cfg = get_config(entry["arch"])
    if entry.get("smoke", True):
        cfg = cfg.smoke()
    quantize = entry.get("quantize", "off")
    cfg = cfg.replace(**(entry.get("overrides") or {}), quantize=quantize)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(entry.get("seed", 0)))
    if quantize == "serve":
        return cfg, init_model_quantized(cfg, gen, quant_predicate, device=device)
    return cfg, init_model(cfg, gen, device=device)


def realize_model_spec(spec: Dict):
    """Model spec -> (cfg, params, draft_cfg, draft_params) on the spec's
    device: exactly the objects the port's CLI builds from the same flags."""
    from repro_torch import resolve_device
    device = resolve_device(spec.get("device", "cuda"))
    cfg, params = _build_weights(spec, device)
    draft_cfg = draft_params = None
    if spec.get("draft"):
        draft_cfg, draft_params = _build_weights(spec["draft"], device)
    return cfg, params, draft_cfg, draft_params


# ----------------------------------------------------------------- protocol

class HostTransport(Protocol):
    """The complete Router->host call surface. ``poll`` is cursor-based
    (tokens already received per request), so a duplicated or retried poll
    never double-delivers a token. ``submit``/``evict_queued``/``preempt``
    mutate and are never retried."""

    kind: str
    metrics: TransportMetrics

    def would_accept(self, prompt_len: int, max_new_tokens: int) -> bool: ...
    def lease_headroom(self, prompt_len: int, max_new_tokens: int) -> bool: ...
    def load(self) -> int: ...
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               sampling: Optional[SamplingParams] = None,
               stop_history: Sequence[int] = (),
               want_logprobs: Optional[int] = None) -> Optional[int]: ...
    def pump(self) -> None: ...
    def poll(self, cursors: Dict[int, int],
             drop: Sequence[int] = ()) -> Dict[int, Dict]: ...
    def has_work(self) -> bool: ...
    def evict_queued(self, ids: Sequence[int]) -> List[int]: ...
    def inflight(self) -> List[Dict]: ...
    def preempt(self, req_id: int) -> Optional[Dict]: ...
    def ship_blocks(self, req_id: int) -> Optional[Dict]: ...
    def recv_blocks(self, entry: Dict) -> Optional[int]: ...
    def ack_ship(self, payload_id: str) -> bool: ...
    def embed(self, prompt: Sequence[int]) -> Dict: ...
    def stats(self) -> Dict: ...
    def probe(self) -> bool: ...
    def close(self) -> None: ...


class EngineHost:
    """The host side shared by both backends: an Engine plus the map of
    caller-submitted requests. InProcessTransport calls it directly;
    host_main.py calls it behind the RPC loop."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self._by_id: Dict[int, Request] = {}
        # block shipping: outbound entries by payload id (and the payload id
        # by request id, so a retried ship_blocks returns the same entry),
        # and the inbound dedup map a retried recv_blocks resolves against
        self._shipped: Dict[str, Dict] = {}
        self._ship_pid: Dict[int, str] = {}
        self._imported: Dict[str, int] = {}

    def would_accept(self, prompt_len: int, max_new_tokens: int) -> bool:
        return bool(self.engine.would_accept(prompt_len, max_new_tokens))

    def lease_headroom(self, prompt_len: int, max_new_tokens: int) -> bool:
        return bool(self.engine.lease_headroom(prompt_len, max_new_tokens))

    def load(self) -> int:
        sched = self.engine.scheduler
        return sched.queue_depth + sched.n_active

    def submit(self, prompt, max_new_tokens, sampling=None, stop_history=(),
               want_logprobs=None) -> Optional[int]:
        req = self.engine.submit(np.asarray(prompt, np.int32), int(max_new_tokens),
                                 sampling=sampling, stop_history=tuple(stop_history),
                                 want_logprobs=want_logprobs)
        if req is None:
            return None
        self._by_id[req.id] = req
        return req.id

    def pump(self) -> None:
        if self.engine.has_work():
            self.engine.step()

    def poll(self, cursors: Dict[int, int], drop: Sequence[int] = ()) -> Dict[int, Dict]:
        """Token deltas past each live request's cursor, with done and the
        finish reason once finished. A request's final tokens and its done
        flag travel in the same delta; ``drop`` forgets fully harvested
        requests."""
        for rid in drop:
            self._by_id.pop(int(rid), None)
        out: Dict[int, Dict] = {}
        for rid, n in cursors.items():
            req = self._by_id.get(int(rid))
            if req is None:
                continue
            n = int(n)
            # emission timestamps (monotonic clock, one epoch across the
            # processes of a host): a free-running worker's tokens arrive in
            # bursts, so these measure the engine's cadence, not the polls'
            d: Dict = {"t": [int(t) for t in req.tokens[n:]],
                       "ts": [float(v) for v in req.token_ts[n:]]}
            if req.want_logprobs is not None:
                d["lp"] = [float(v) for v in req.logprobs[n:]]
                d["tl"] = [[[int(t), float(v)] for t, v in row]
                           for row in req.top_logprobs[n:]]
            if req.done:
                d["done"] = True
                d["reason"] = req.finish_reason
            out[int(rid)] = d
        return out

    def has_work(self) -> bool:
        return self.engine.has_work()

    def evict_queued(self, ids: Sequence[int]) -> List[int]:
        """Pull the queue; the caller's requests (``ids``) come back as ids
        for re-placement elsewhere, any other (direct engine submits)
        re-enqueues untouched."""
        own = {int(i) for i in ids}
        evicted: List[int] = []
        for req in self.engine.evict_queued():
            if req.id in own:
                self._by_id.pop(req.id, None)
                evicted.append(req.id)
            else:
                req.state = RequestState.QUEUED
                self.engine.scheduler.enqueue(req)
        return evicted

    def inflight(self) -> List[Dict]:
        return [{"id": req.id, "generated": len(req.tokens)}
                for _, req in sorted(self.engine.scheduler.active.items())
                if req.id in self._by_id]

    def preempt(self, req_id: int) -> Optional[Dict]:
        """Preempt one in-flight request and return its authoritative wire
        form (a free-running worker may be ahead of the caller's last poll);
        None when it already finished (the next poll reports it)."""
        try:
            req = self.engine.preempt(int(req_id))
        except KeyError:
            return None
        self._by_id.pop(int(req_id), None)
        return req.to_wire()

    def ship_blocks(self, req_id: int) -> Optional[Dict]:
        """Export one in-flight request's stream state and its cache blocks
        as a ship entry ``{"payload_id", "wire", "payload"}``, cached under
        the request id so a retried ship returns the same entry. The blocks
        stay on the export ledger until ``ack_ship``. None when the request
        already finished here."""
        pid = self._ship_pid.get(int(req_id))
        if pid is not None:
            return self._shipped[pid]
        try:
            req, payload = self.engine.extract_seeded(int(req_id))
        except KeyError:
            return None
        self._by_id.pop(int(req_id), None)
        entry = {"payload_id": payload["payload_id"], "wire": req.to_wire(),
                 "payload": payload}
        self._shipped[entry["payload_id"]] = entry
        self._ship_pid[int(req_id)] = entry["payload_id"]
        return entry

    def recv_blocks(self, entry: Dict) -> Optional[int]:
        """Adopt a shipped entry (``Engine.submit_seeded``), deduplicated on
        the payload id: a retried recv of an imported payload returns the
        same local request id. None when refused (no free slot, lease
        backpressure); ValueError on a corrupt payload."""
        pid = str(entry["payload_id"])
        if pid in self._imported:
            return self._imported[pid]
        wire = entry["wire"]
        req = self.engine.submit_seeded(
            wire["prompt"], int(wire["max_new_tokens"]), wire["tokens"], entry["payload"],
            sampling=sampling_from_wire(wire.get("sampling")),
            stop_history=tuple(int(t) for t in wire.get("stop_history") or ()),
            want_logprobs=wire.get("want_logprobs"),
            logprobs=wire.get("logprobs") or (),
            top_logprobs=wire.get("top_logprobs") or ())
        if req is None:
            return None
        self._imported[pid] = req.id
        self._by_id[req.id] = req
        return req.id

    def ack_ship(self, payload_id: str) -> bool:
        """Settle one outbound ship on either outcome (imported, or fallen
        back to re-prefill): release the ledger's hold and drop the cached
        entry. Idempotent."""
        pid = str(payload_id)
        entry = self._shipped.pop(pid, None)
        if entry is not None:
            self._ship_pid.pop(int(entry["wire"]["id"]), None)
        return bool(self.engine.release_exported(pid))

    def embed(self, prompt) -> Dict:
        return self.engine.embed(np.asarray(prompt, np.int32))

    def stats(self) -> Dict:
        out = dict(self.engine.stats())
        # the fleet's sustained rate spans the fleet's first to last token,
        # which the summary does not carry (one monotonic epoch per host)
        out["first_token_s"] = self.engine.metrics.first_token_s
        out["last_token_s"] = self.engine.metrics.last_token_s
        return out

    def probe(self) -> bool:
        return True

    def close(self) -> None:
        self.engine.close()


# ------------------------------------------------------------- in-process

class InProcessTransport:
    """An in-process host behind the protocol: host calls are Python calls,
    timed through the same TransportMetrics as the subprocess backend's
    RPCs. ``pump`` drives one engine step: the caller is the step loop."""

    kind = "in-process"

    def __init__(self, host: EngineHost):
        self.host = host
        self.metrics = TransportMetrics()

    @property
    def engine(self) -> Engine:
        return self.host.engine

    def _timed(self, fn, *args, **kwargs):
        t0 = now()
        try:
            return fn(*args, **kwargs)
        finally:
            self.metrics.observe(now() - t0)

    def would_accept(self, prompt_len, max_new_tokens):
        return self._timed(self.host.would_accept, prompt_len, max_new_tokens)

    def lease_headroom(self, prompt_len, max_new_tokens):
        return self._timed(self.host.lease_headroom, prompt_len, max_new_tokens)

    def load(self):
        return self._timed(self.host.load)

    def submit(self, prompt, max_new_tokens, sampling=None, stop_history=(),
               want_logprobs=None):
        return self._timed(self.host.submit, prompt, max_new_tokens, sampling=sampling,
                           stop_history=stop_history, want_logprobs=want_logprobs)

    def pump(self):
        self.host.pump()

    def poll(self, cursors, drop=()):
        return self._timed(self.host.poll, cursors, drop)

    def has_work(self):
        return self.host.has_work()

    def evict_queued(self, ids):
        return self._timed(self.host.evict_queued, ids)

    def inflight(self):
        return self._timed(self.host.inflight)

    def preempt(self, req_id):
        return self._timed(self.host.preempt, req_id)

    def ship_blocks(self, req_id):
        return self._timed(self.host.ship_blocks, req_id)

    def recv_blocks(self, entry):
        return self._timed(self.host.recv_blocks, entry)

    def ack_ship(self, payload_id):
        return self._timed(self.host.ack_ship, payload_id)

    def embed(self, prompt):
        return self._timed(self.host.embed, prompt)

    def stats(self):
        return self._timed(self.host.stats)

    def probe(self):
        return True

    def close(self):
        self.host.close()


def build_inproc_fleet(cfg, params, engine_cfg: Optional[EngineConfig] = None,
                       n_hosts: int = 1, *, draft_params=None,
                       device=None) -> List[InProcessTransport]:
    """N in-process hosts over shared params, each with its own engine, slot
    pool and OPQ runtime, on ``device`` (the card unless the caller names
    the CPU). The default Router fleet."""
    return [InProcessTransport(EngineHost(Engine(cfg, params, engine_cfg, device=device,
                                                 draft_params=draft_params)))
            for _ in range(n_hosts)]


# ------------------------------------------------------------- subprocess

# ops safe to retry after a timeout: read-only predicates and cursor reads,
# and the block-shipping trio, retry-safe by design (ship_blocks caches its
# entry per request, recv_blocks dedups on the payload id, ack_ship releases
# idempotently). submit/evict_queued/preempt mutate: a lost reply leaves the
# mutation's fate unknown, so they raise TransportError instead.
_IDEMPOTENT_OPS = frozenset({
    "would_accept", "lease_headroom", "load", "has_work", "poll",
    "inflight", "stats", "probe", "embed",
    "ship_blocks", "recv_blocks", "ack_ship",
})


class SubprocessTransport:
    """One OS process per host: spawns ``python -m
    repro_torch.serving.host_main`` (``subprocess.Popen``, never a fork of a
    process that may hold a CUDA context) connected over an AF_UNIX socket,
    sends the model spec and engine config in an init frame, then speaks the
    framed RPC protocol. The worker free-runs its engine; ``pump`` is a
    no-op.

    ``connect_timeout_s`` bounds worker boot (imports + weights);
    ``request_timeout_s`` bounds each RPC.
    """

    kind = "subprocess"

    def __init__(self, model_spec: Dict, engine_cfg: Optional[EngineConfig] = None, *,
                 connect_timeout_s: float = 300.0, request_timeout_s: float = 300.0,
                 retries: int = 2):
        self.model_spec = dict(model_spec)
        self.ecfg = engine_cfg or EngineConfig()
        self.request_timeout_s = request_timeout_s
        self.retries = retries
        self.metrics = TransportMetrics()
        self._seq = itertools.count(1)
        self._closed = False
        self.pid = None
        if str(self.model_spec.get("device", "cuda")).startswith("cuda"):
            # workers load what the parent built: none of them races another
            # on build/kernels/
            from repro_torch.kernels import _build
            _build.build_all()
        self._tmpdir = tempfile.mkdtemp(prefix="rhost")
        path = os.path.join(self._tmpdir, "s")
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(path)
        listener.listen(1)
        listener.settimeout(connect_timeout_s)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serving.host_main", "--socket", path],
            env=self._worker_env())
        self.pid = self.proc.pid
        try:
            conn, _ = listener.accept()
        except socket.timeout:
            self._reap()
            raise TransportError(f"worker (pid {self.proc.pid}) did not connect within "
                                 f"{connect_timeout_s}s")
        finally:
            listener.close()
        self.chan = Channel(conn)
        # init is a seq'd request like any other, under the boot timeout: the
        # worker answers once its weights and engine are built
        try:
            ready = self._call("init", {"model_spec": self.model_spec,
                                        "engine_cfg": engine_cfg_to_wire(engine_cfg)},
                               timeout=connect_timeout_s)
        except (TransportError, RuntimeError, ValueError):
            self.close()
            raise
        self.pid = int(ready["pid"])

    @staticmethod
    def _worker_env() -> Dict[str, str]:
        import repro_torch
        env = dict(os.environ)
        src_dir = str(Path(repro_torch.__file__).resolve().parents[1])
        existing = env.get("PYTHONPATH")
        env["PYTHONPATH"] = src_dir + os.pathsep + existing if existing else src_dir
        return env

    # --------------------------------------------------------------- rpc

    def _call(self, op: str, args: Optional[Dict] = None, timeout: Optional[float] = None):
        if self._closed:
            raise TransportError(f"transport to pid {self.pid} is closed")
        timeout = self.request_timeout_s if timeout is None else timeout
        attempts = 1 + (self.retries if op in _IDEMPOTENT_OPS else 0)
        for attempt in range(attempts):
            seq = next(self._seq)
            t0 = now()
            try:
                self.chan.send({"seq": seq, "op": op, "args": args or {}})
                deadline = t0 + timeout
                while True:
                    reply = self.chan.recv(timeout=max(deadline - now(), 0.001))
                    # a retried call's earlier reply, or a duplicated frame,
                    # carries a stale seq: discard it and keep reading
                    if reply.get("seq") == seq:
                        break
            except TransportError as e:
                self.metrics.errors += 1
                if attempt + 1 < attempts:
                    self.metrics.retries += 1
                    continue
                raise TransportError(f"rpc {op!r} to worker pid {self.pid} failed after "
                                     f"{attempts} attempt(s): {e}") from e
            self.metrics.observe(now() - t0)
            if reply.get("ok"):
                return reply.get("val")
            # application error from a healthy host: re-raise in kind
            etype, msg = reply.get("etype"), reply.get("err", "")
            if etype == "ValueError":
                raise ValueError(msg)
            if etype == "KeyError":
                raise KeyError(msg)
            raise RuntimeError(f"remote {etype or 'error'}: {msg}")

    # ---------------------------------------------------------- protocol

    def would_accept(self, prompt_len, max_new_tokens):
        return bool(self._call("would_accept", {"plen": int(prompt_len),
                                                "gen": int(max_new_tokens)}))

    def lease_headroom(self, prompt_len, max_new_tokens):
        return bool(self._call("lease_headroom", {"plen": int(prompt_len),
                                                  "gen": int(max_new_tokens)}))

    def load(self):
        return int(self._call("load"))

    def submit(self, prompt, max_new_tokens, sampling=None, stop_history=(),
               want_logprobs=None):
        val = self._call("submit", {
            "prompt": [int(t) for t in prompt], "gen": int(max_new_tokens),
            "sampling": sampling_to_wire(sampling),
            "stop_history": [int(t) for t in stop_history],
            "want_logprobs": want_logprobs,
        })
        return None if val is None else int(val)

    def pump(self):
        pass                           # the worker's loop steps the engine

    def poll(self, cursors, drop=()):
        val = self._call("poll", {"cursors": {int(k): int(v) for k, v in cursors.items()},
                                  "drop": [int(i) for i in drop]}) or {}
        # JSON frames stringify int dict keys
        return {int(k): v for k, v in val.items()}

    def has_work(self):
        return bool(self._call("has_work"))

    def evict_queued(self, ids):
        return [int(i) for i in (self._call("evict_queued",
                                            {"ids": [int(i) for i in ids]}) or [])]

    def inflight(self):
        return list(self._call("inflight") or [])

    def preempt(self, req_id):
        return self._call("preempt", {"id": int(req_id)})

    def ship_blocks(self, req_id):
        return self._call("ship_blocks", {"id": int(req_id)})

    def recv_blocks(self, entry):
        val = self._call("recv_blocks", {"entry": entry})
        return None if val is None else int(val)

    def ack_ship(self, payload_id):
        return bool(self._call("ack_ship", {"payload_id": str(payload_id)}))

    def embed(self, prompt):
        val = self._call("embed", {"prompt": [int(t) for t in prompt]})
        return {"embedding": np.asarray(val["embedding"]), "logits": np.asarray(val["logits"])}

    def stats(self):
        return self._call("stats")

    def probe(self) -> bool:
        """Liveness: False for a dead or unreachable worker, never raises."""
        if self._closed or self.proc.poll() is not None:
            return False
        try:
            return bool(self._call("probe", timeout=5.0))
        except TransportError:
            return False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self.proc.poll() is None:
                self.chan.send({"seq": next(self._seq), "op": "shutdown", "args": {}})
                self.chan.recv(timeout=5.0)       # let the worker ack and exit
        except TransportError:
            pass
        self.chan.close()
        self._reap()
        try:
            os.unlink(os.path.join(self._tmpdir, "s"))
            os.rmdir(self._tmpdir)
        except OSError:
            pass

    def _reap(self, grace_s: float = 5.0) -> None:
        """No orphans: wait briefly, then terminate, then kill."""
        try:
            self.proc.wait(timeout=grace_s)
            return
        except subprocess.TimeoutExpired:
            pass
        self.proc.terminate()
        try:
            self.proc.wait(timeout=2.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
