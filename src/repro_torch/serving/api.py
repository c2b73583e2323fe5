"""Streaming HTTP serve API over an Engine or Router (standard library
only) — the port of ``repro.serving.api``: a small HTTP server fronting a
single :class:`~repro_torch.serving.engine.Engine` or the multi-host
:class:`~repro_torch.serving.router.Router`, with

  * ``POST /v1/completions`` — token generation, optionally streamed as
    Server-Sent Events (``"stream": true``): one ``data: {"token": t,
    "index": i}`` event per generated token AS IT LANDS (incremental
    delivery is asserted in CI), then a final ``data: {"done": true, ...}``
    and ``data: [DONE]``. Per-request sampling params (temperature, top_k,
    top_p, repetition_penalty, seed, stop) map straight onto
    :class:`~repro_torch.serving.sampling.SamplingParams`. ``"logprobs": true``
    adds each emitted token's log-probability (from the very logits row the
    token choice used — no second forward, no second executable), and
    ``"top_logprobs": k`` (k <= sampling.TOP_LOGPROBS) its k most likely
    alternatives; both ride token events and the non-streamed response, and
    are strictly opt-in — responses without them are byte-identical to
    before.
  * ``POST /v1/embeddings`` / ``POST /v1/classify`` — the non-generative
    endpoints: one fused bucketed forward (``Engine.embed``) returning the
    prompt's last-position hidden state, or a softmax over candidate token
    ids' logits. No slot is leased; classification is zero-shot over the
    LM head.
  * ``GET /v1/stats`` — the engine/fleet telemetry, JSON-sanitized.
  * ``GET /healthz`` — liveness.

Threading model: the Engine/Router are NOT thread-safe (host-side slot
state, OPQ dispatch), so ONE loop thread owns the backend and runs the
serve loop (step + harvest); HTTP handler threads (ThreadingHTTPServer)
talk to it exclusively through a command queue and receive tokens through
per-request stream queues. CUDA's current device is per thread, so the
loop thread makes the backend's device current before its first step.

Requests and responses carry token IDS, not text: tokenization is the
client's business (the repo has no tokenizer dependency), which also keeps
the bit-identity story auditable end to end.
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.engine import Engine
from repro_torch.serving.router import Router
from repro_torch.serving.sampling import SamplingParams

__all__ = ["ApiServer", "serve_api"]

_IDLE_WAIT_S = 0.02          # command-queue poll while the backend is empty
_STREAM_TIMEOUT_S = 120.0    # handler-side wait for the next token event


def _jsonable(obj):
    """Stats trees mix numpy scalars, inf, and tuples — make them JSON."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        f = float(obj)
        return f if np.isfinite(f) else str(f)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _params_from(body: Dict) -> Optional[SamplingParams]:
    """Request-body sampling fields -> SamplingParams (None == plain greedy,
    the engine's zero-cost default). Raises ValueError on bad values — the
    handler turns that into a 400."""
    stop = body.get("stop") or ()
    if isinstance(stop, (int, float)):
        stop = [int(stop)]
    sp = SamplingParams(
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        seed=int(body.get("seed", 0)),
        stop=tuple(tuple(s) if isinstance(s, (list, tuple)) else (int(s),)
                   for s in stop))
    return None if sp == SamplingParams() else sp


class _Backend:
    """Uniform loop-thread view over Engine | Router: submit/step/harvest
    with live per-request token access (Router.progress covers mid-segment
    tokens so a drain mid-stream never stalls the SSE feed)."""

    def __init__(self, target):
        self.target = target
        self.is_router = isinstance(target, Router)

    def device(self) -> Optional[torch.device]:
        """The device the backend's engines step on, with its index: the
        Engine's, or the first in-process host's (a worker process sets its
        own). Called on the caller's thread, whose current CUDA device an
        index-less ``cuda`` names."""
        if isinstance(self.target, Engine):
            dev = self.target.device
        else:
            engines = [t.engine for t in self.target.transports if hasattr(t, "engine")]
            dev = engines[0].device if engines else None
        if dev is not None and dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def submit(self, prompt, max_new_tokens, sampling, want_logprobs=None):
        return self.target.submit(prompt, max_new_tokens, sampling=sampling,
                                  want_logprobs=want_logprobs, strict=True)

    def tokens(self, handle) -> List[int]:
        if self.is_router:
            return self.target.progress(handle)
        return list(handle.tokens)

    @staticmethod
    def logprob_rows(handle):
        """(logprobs, top_logprobs) mirrors — Request and RouterRequest both
        carry them, appended atomically with each token, so slicing by the
        token cursor stays aligned."""
        return handle.logprobs, handle.top_logprobs

    @staticmethod
    def done(handle) -> bool:
        return bool(handle.done)

    @staticmethod
    def finish_reason(handle) -> Optional[str]:
        return getattr(handle, "finish_reason", None)

    def embed(self, prompt):
        return self.target.embed(prompt)

    def step(self):
        self.target.step()

    def has_work(self) -> bool:
        return self.target.has_work()

    def stats(self) -> Dict:
        return self.target.stats()


class _ServeLoop(threading.Thread):
    """The single thread that owns the backend. Commands arrive as
    ``(kind, payload, reply_q)``; generation streams leave through the
    per-request queues as ``("token", (id, logprob_fields|None))`` /
    ``("done", finish_reason)`` / ``("error", message)`` events. A server
    shutdown flushes ``("done", "shutdown")`` to every live stream so no
    SSE consumer is left hanging without a terminal frame."""

    def __init__(self, backend: _Backend):
        super().__init__(daemon=True, name="serve-loop")
        self.backend = backend
        self.device = backend.device()
        self.cmds: "queue.Queue" = queue.Queue()
        # not named _stop: threading.Thread defines an internal _stop()
        # method that join() calls, and shadowing it breaks teardown
        self._halt = threading.Event()
        # live streams: key -> [handle, stream_q, n_tokens_sent]
        self._streams: Dict[int, list] = {}
        self._keys = iter(range(1 << 62))

    # ------------------------------------------------- handler-thread side

    def call(self, kind: str, payload):
        """Execute one command on the loop thread, propagating errors."""
        reply: "queue.Queue" = queue.Queue()
        self.cmds.put((kind, payload, reply))
        ok, val = reply.get(timeout=_STREAM_TIMEOUT_S)
        if not ok:
            raise val
        return val

    def stop(self):
        self._halt.set()
        self.cmds.put(None)          # wake the idle wait

    # ---------------------------------------------------- loop-thread side

    def _handle(self, cmd) -> None:
        kind, payload, reply = cmd
        try:
            if kind == "submit":
                prompt, gen, sampling, want = payload
                handle = self.backend.submit(prompt, gen, sampling, want)
                q: "queue.Queue" = queue.Queue()
                self._streams[next(self._keys)] = [handle, q, 0, want]
                reply.put((True, q))
            elif kind == "embed":
                reply.put((True, self.backend.embed(payload)))
            elif kind == "stats":
                reply.put((True, self.backend.stats()))
            else:
                reply.put((False, ValueError(f"unknown command {kind!r}")))
        except Exception as exc:            # surfaced as the caller's error
            reply.put((False, exc))

    def _harvest(self) -> None:
        for key in list(self._streams):
            handle, q, sent, want = self._streams[key]
            toks = self.backend.tokens(handle)
            lps = tls = ()
            if want is not None:
                lps, tls = self.backend.logprob_rows(handle)
            for j in range(sent, len(toks)):
                extra = None
                if want is not None and j < len(lps):
                    extra = {"logprob": float(lps[j])}
                    if want > 0:
                        extra["top_logprobs"] = [
                            [int(t), float(v)] for t, v in tls[j][:want]]
                q.put(("token", (int(toks[j]), extra)))
            self._streams[key][2] = len(toks)
            if self.backend.done(handle):
                q.put(("done", self.backend.finish_reason(handle)))
                del self._streams[key]

    def run(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._halt.is_set():
            try:
                cmd = self.cmds.get(block=not self.backend.has_work(),
                                    timeout=_IDLE_WAIT_S)
            except queue.Empty:
                cmd = None
            if self._halt.is_set():
                break
            if cmd is not None:
                self._handle(cmd)
                continue             # drain commands before stepping
            if self.backend.has_work():
                try:
                    self.backend.step()
                except Exception as exc:
                    # a failed step poisons every live stream, not the
                    # server: report and keep serving new requests
                    for _, q, _, _ in self._streams.values():
                        q.put(("error", f"{type(exc).__name__}: {exc}"))
                    self._streams.clear()
                self._harvest()
        # graceful shutdown: every stream still live gets a terminal frame
        # (an SSE consumer must never hang waiting on a dead server)
        for _, q, _, _ in self._streams.values():
            q.put(("done", "shutdown"))
        self._streams.clear()


def _make_handler(loop: _ServeLoop):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.0 + Connection: close — SSE needs no chunked framing, the
        # stream ends when the socket does
        protocol_version = "HTTP/1.0"

        def log_message(self, *args):    # quiet: the engine has its own logs
            pass

        # ------------------------------------------------------ plumbing

        def _json(self, code: int, obj) -> None:
            body = json.dumps(_jsonable(obj)).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> Dict:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                return {}
            return json.loads(self.rfile.read(n).decode())

        def _sse_event(self, obj) -> None:
            data = obj if isinstance(obj, str) else json.dumps(obj)
            self.wfile.write(f"data: {data}\n\n".encode())
            self.wfile.flush()

        # ----------------------------------------------------- endpoints

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/v1/stats":
                self._json(200, loop.call("stats", None))
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                body = self._body()
            except (ValueError, json.JSONDecodeError) as exc:
                return self._json(400, {"error": f"bad JSON body: {exc}"})
            try:
                if self.path == "/v1/completions":
                    return self._completions(body)
                if self.path == "/v1/embeddings":
                    return self._embeddings(body)
                if self.path == "/v1/classify":
                    return self._classify(body)
            except Exception as exc:     # engine-door rejections -> 400
                return self._json(400, {"error": f"{type(exc).__name__}: "
                                                 f"{exc}"})
            self._json(404, {"error": f"no route {self.path}"})

        def _completions(self, body: Dict) -> None:
            prompt = body.get("prompt")
            if not prompt:
                return self._json(400, {"error": "prompt (a list of token "
                                                 "ids) is required"})
            gen = int(body.get("max_new_tokens", 16))
            sampling = _params_from(body)
            # logprobs are opt-in: "logprobs": true records each token's
            # log-probability; "top_logprobs": k adds its k alternatives
            # (k bounded by the device-side capture width — the engine's
            # door rejects more with a 400 here)
            want = (int(body.get("top_logprobs", 0))
                    if body.get("logprobs") else None)
            stream_q = loop.call("submit", (prompt, gen, sampling, want))
            if not body.get("stream"):
                toks, lps, tls, reason = [], [], [], None
                while True:
                    kind, val = stream_q.get(timeout=_STREAM_TIMEOUT_S)
                    if kind == "token":
                        tok, extra = val
                        toks.append(tok)
                        if extra is not None:
                            lps.append(extra["logprob"])
                            tls.append(extra.get("top_logprobs", []))
                    elif kind == "done":
                        reason = val
                        break
                    else:
                        return self._json(500, {"error": val})
                out = {"tokens": toks, "finish_reason": reason}
                if want is not None:
                    out["logprobs"] = lps
                    if want > 0:
                        out["top_logprobs"] = tls
                return self._json(200, out)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            i = 0
            while True:
                kind, val = stream_q.get(timeout=_STREAM_TIMEOUT_S)
                if kind == "token":
                    tok, extra = val
                    event = {"token": tok, "index": i}
                    if extra is not None:
                        event.update(extra)
                    self._sse_event(event)
                    i += 1
                elif kind == "done":
                    self._sse_event({"done": True, "finish_reason": val,
                                     "n_tokens": i})
                    self._sse_event("[DONE]")
                    return
                else:
                    self._sse_event({"error": val})
                    self._sse_event("[DONE]")
                    return

        def _embeddings(self, body: Dict) -> None:
            prompt = body.get("prompt")
            if not prompt:
                return self._json(400, {"error": "prompt (a list of token "
                                                 "ids) is required"})
            out = loop.call("embed", prompt)
            emb = out["embedding"]
            self._json(200, {"embedding": [float(x) for x in emb],
                             "dim": len(emb)})

        def _classify(self, body: Dict) -> None:
            prompt = body.get("prompt")
            classes = body.get("classes")
            if not prompt or not classes:
                return self._json(400, {"error": "prompt and classes (lists "
                                                 "of token ids) are required"})
            out = loop.call("embed", prompt)
            logits = np.asarray(out["logits"], np.float64)
            sel = logits[np.asarray(classes, np.int64)]
            sel -= sel.max()
            probs = np.exp(sel) / np.exp(sel).sum()
            self._json(200, {"classes": [int(c) for c in classes],
                             "probs": [float(p) for p in probs],
                             "top": int(classes[int(probs.argmax())])})

    return Handler


class ApiServer:
    """Handle for a running serve API: ``.port`` (bound port — pass
    ``port=0`` to let the OS pick, tests do), ``.close()`` (stop loop +
    server), ``.wait()`` (block until closed — the CLI's foreground mode)."""

    def __init__(self, loop: _ServeLoop, httpd: ThreadingHTTPServer):
        self._loop = loop
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        daemon=True, name="serve-http")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def close(self) -> None:
        self._loop.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._loop.join(timeout=5)

    def wait(self) -> None:
        try:
            self._thread.join()
        except KeyboardInterrupt:
            self.close()


def serve_api(target, *, port: int = 0, host: str = "127.0.0.1") -> ApiServer:
    """Boot the HTTP serve API over an Engine or Router. Returns the
    running :class:`ApiServer`."""
    backend = _Backend(target)
    loop = _ServeLoop(backend)
    loop.start()
    httpd = ThreadingHTTPServer((host, port), _make_handler(loop))
    return ApiServer(loop, httpd)
