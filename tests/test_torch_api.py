"""The port's HTTP serve API (repro_torch.serving.api over an Engine or a
Router) on the CPU: the ports of tests/test_api.py, each test building its
engine and server in its own body (as the reference's
``test_completion_matches_direct_engine`` does), on port 0.

  * bit-identity — tokens over HTTP (streamed or not) are the direct
                   Engine's, and a seeded sampled completion repeats
  * streaming    — SSE events arrive in order, the terminal frame carries
                   finish_reason and n_tokens, the stream ends with [DONE]
  * non-generative — /v1/embeddings is Engine.embed's hidden state;
                   /v1/classify a distribution over the candidate ids
  * door contract — bad bodies and unknown routes are 4xx JSON errors;
                   /healthz and /v1/stats serve
  * a Router backend — completions through a two-host fleet equal the
                   single engine's
"""

import contextlib
import http.client
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_model
from repro_torch.serving import Engine, EngineConfig, Router, RouterConfig, serve_api

CFG = get_config("tinyllama-1.1b").smoke()
RNG = np.random.default_rng(31)
ECFG = dict(max_slots=2, max_seq_len=32)


@pytest.fixture(scope="module")
def params():
    return init_model(CFG, torch.Generator().manual_seed(0))


@contextlib.contextmanager
def _served(params, **ecfg):
    """A fresh engine behind a port-0 API server, closed on exit."""
    eng = Engine(CFG, params, EngineConfig(**{**ECFG, **ecfg}), device="cpu")
    srv = serve_api(eng, port=0)
    try:
        yield srv, eng
    finally:
        srv.close()
        eng.close()


def _request(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
    payload = json.dumps(body).encode() if body is not None else None
    headers = {"Content-Type": "application/json"} if payload else {}
    conn.request(method, path, body=payload, headers=headers)
    resp = conn.getresponse()
    data = json.loads(resp.read().decode())
    conn.close()
    return resp.status, data


def _stream(srv, body):
    """POST a streaming completion, return the decoded SSE event list."""
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
    conn.request("POST", "/v1/completions", body=json.dumps({**body, "stream": True}).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    events = []
    for raw in resp.fp:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        data = line[len("data: "):]
        if data == "[DONE]":
            break
        events.append(json.loads(data))
    conn.close()
    return events


def _prompt(n):
    return [int(t) for t in RNG.integers(0, CFG.vocab, (n,))]


def _direct(params, prompt, gen):
    eng = Engine(CFG, params, EngineConfig(**ECFG), device="cpu")
    req = eng.submit(prompt, gen, strict=True)
    eng.run_until_complete()
    eng.close()
    return list(req.tokens)


def test_healthz_and_stats(params):
    with _served(params) as (srv, _):
        status, body = _request(srv, "GET", "/healthz")
        assert status == 200 and body == {"ok": True}
        status, body = _request(srv, "GET", "/v1/stats")
        assert status == 200
        assert body["submitted"] == 0
        status, _ = _request(srv, "GET", "/no/such/route")
        assert status == 404


def test_completion_matches_direct_engine(params):
    """Greedy tokens over POST /v1/completions equal a direct submit's."""
    prompt = _prompt(6)
    expected = _direct(params, prompt, 8)
    with _served(params) as (srv, _):
        status, body = _request(srv, "POST", "/v1/completions",
                                {"prompt": prompt, "max_new_tokens": 8})
        assert status == 200
        assert body["tokens"] == expected
        assert body["finish_reason"] == "length"


def test_sse_stream_orders_and_terminates(params):
    prompt = _prompt(5)
    with _served(params) as (srv, _):
        events = _stream(srv, {"prompt": prompt, "max_new_tokens": 6})
        *toks, done = events
        assert [e["index"] for e in toks] == list(range(6))
        assert done == {"done": True, "finish_reason": "length", "n_tokens": 6}
        status, body = _request(srv, "POST", "/v1/completions",
                                {"prompt": prompt, "max_new_tokens": 6})
        assert status == 200 and body["tokens"] == [e["token"] for e in toks]


def test_seeded_sampling_is_reproducible_over_http(params):
    req = {"prompt": _prompt(6), "max_new_tokens": 8,
           "temperature": 0.8, "top_k": 20, "top_p": 0.95, "seed": 1234}
    with _served(params) as (srv, eng):
        status, first = _request(srv, "POST", "/v1/completions", req)
        assert status == 200
        status, again = _request(srv, "POST", "/v1/completions", req)
        assert status == 200
        assert first["tokens"] == again["tokens"]
        assert eng.metrics.sampled_tokens >= 16


def test_stop_sequence_over_http(params):
    prompt = _prompt(5)
    with _served(params) as (srv, _):
        status, full = _request(srv, "POST", "/v1/completions",
                                {"prompt": prompt, "max_new_tokens": 8})
        assert status == 200 and len(full["tokens"]) == 8
        stop = full["tokens"][2:4]
        status, cut = _request(srv, "POST", "/v1/completions",
                               {"prompt": prompt, "max_new_tokens": 8, "stop": [stop]})
        assert status == 200
        # the first occurrence of the pair ends the stream
        ends = [j + 2 for j in range(7) if full["tokens"][j:j + 2] == stop]
        assert cut["tokens"] == full["tokens"][:ends[0]]
        assert cut["finish_reason"] == "stop"


def test_logprobs_over_http(params):
    """``"logprobs": true`` adds each token's log-probability and
    ``"top_logprobs": k`` its k alternatives; strictly opt-in."""
    prompt = _prompt(6)
    base = {"prompt": prompt, "max_new_tokens": 6}
    with _served(params) as (srv, _):
        status, plain = _request(srv, "POST", "/v1/completions", base)
        assert status == 200
        assert set(plain) == {"tokens", "finish_reason"}

        status, lp = _request(srv, "POST", "/v1/completions",
                              {**base, "logprobs": True, "top_logprobs": 2})
        assert status == 200
        assert lp["tokens"] == plain["tokens"]
        assert len(lp["logprobs"]) == len(lp["tokens"])
        assert all(v <= 0.0 for v in lp["logprobs"])
        assert all(len(row) == 2 for row in lp["top_logprobs"])
        for tok, lv, row in zip(lp["tokens"], lp["logprobs"], lp["top_logprobs"]):
            assert row[0][0] == tok and abs(row[0][1] - lv) < 1e-6

        status, only = _request(srv, "POST", "/v1/completions", {**base, "logprobs": True})
        assert status == 200 and "top_logprobs" not in only
        assert only["logprobs"] == lp["logprobs"]

        events = _stream(srv, {**base, "logprobs": True, "top_logprobs": 2})
        *toks_ev, _ = events
        assert [e["token"] for e in toks_ev] == lp["tokens"]
        assert [e["logprob"] for e in toks_ev] == lp["logprobs"]
        assert [e["top_logprobs"] for e in toks_ev] == lp["top_logprobs"]
        events = _stream(srv, base)
        assert all("logprob" not in e for e in events[:-1])


def test_embeddings_match_direct_embed(params):
    prompt = _prompt(7)
    ref_eng = Engine(CFG, params, EngineConfig(**ECFG), device="cpu")
    direct = ref_eng.embed(prompt)["embedding"]
    ref_eng.close()
    with _served(params) as (srv, eng):
        status, body = _request(srv, "POST", "/v1/embeddings", {"prompt": prompt})
        assert status == 200
        assert body["dim"] == CFG.d_model == len(body["embedding"])
        np.testing.assert_allclose(np.asarray(body["embedding"]), np.asarray(direct),
                                   rtol=1e-6)
        assert eng.metrics.embed_requests == 1


def test_classify_is_a_distribution(params):
    """The softmax over the candidate ids of Engine.embed's logits row."""
    classes = [3, 17, 99]
    prompt = _prompt(6)
    ref_eng = Engine(CFG, params, EngineConfig(**ECFG), device="cpu")
    logits = np.asarray(ref_eng.embed(prompt)["logits"], np.float64)[classes]
    ref_eng.close()
    want = np.exp(logits - logits.max()) / np.exp(logits - logits.max()).sum()
    with _served(params) as (srv, _):
        status, body = _request(srv, "POST", "/v1/classify",
                                {"prompt": prompt, "classes": classes})
        assert status == 200
        assert body["classes"] == classes
        assert abs(sum(body["probs"]) - 1.0) < 1e-9
        np.testing.assert_allclose(body["probs"], want, rtol=1e-12)
        assert body["top"] == classes[int(np.argmax(body["probs"]))]


def test_bad_requests_are_4xx(params):
    with _served(params) as (srv, _):
        status, body = _request(srv, "POST", "/v1/completions", {})
        assert status == 400 and "prompt" in body["error"]
        status, body = _request(srv, "POST", "/v1/completions",
                                {"prompt": _prompt(4), "temperature": -1.0})
        assert status == 400 and "temperature" in body["error"]
        status, body = _request(srv, "POST", "/v1/embeddings", {})
        assert status == 400
        status, body = _request(srv, "POST", "/v1/classify", {"prompt": _prompt(4)})
        assert status == 400
        status, body = _request(srv, "POST", "/v1/completions",
                                {"prompt": _prompt(30), "max_new_tokens": 30})
        assert status == 400 and "rejected" in body["error"]


def test_router_backend_serves_the_fleet(params):
    """The API over a two-host Router: completions, streamed or not, give
    the single engine's tokens; /v1/stats carries the three levels."""
    prompts = [_prompt(5), _prompt(7)]
    expected = [_direct(params, p, 6) for p in prompts]
    router = Router(CFG, params, EngineConfig(**ECFG), RouterConfig(n_hosts=2), device="cpu")
    srv = serve_api(router, port=0)
    try:
        status, body = _request(srv, "POST", "/v1/completions",
                                {"prompt": prompts[0], "max_new_tokens": 6})
        assert status == 200 and body["tokens"] == expected[0]
        events = _stream(srv, {"prompt": prompts[1], "max_new_tokens": 6})
        assert [e["token"] for e in events[:-1]] == expected[1]
        status, stats = _request(srv, "GET", "/v1/stats")
        assert status == 200 and stats["router"]["placed"] == 2
        assert stats["fleet"]["completed"] == 2
    finally:
        srv.close()
        router.close()
