"""Port parity of the serving surface: the port's ``EngineHTTPServer`` over
the port's ``MockEngine`` against the reference's server over the
reference's mock, on the same request bodies.  The JSON must agree less
``id``, ``created`` and timing fields (``uptime_s``), the random ticket
ids (``ticket``, ``trace``), and less ``slo`` in ``/healthz`` (a later
slice's); the ``handoff`` and ``kv_migrate`` stats of ``/metrics`` and the
mock's ``host_kv`` block are compared.  The SSE event sequences agree the
same way.  Then the port's own engine behind
the server on the CPU (``test_torch_engine.py``'s CFG): streamed deltas
join to the non-streamed greedy text on every dispatch path, the stop and
U+FFFD holdbacks hold, and in one case the ``on_tokens`` deltas equal the
reference ``ContinuousScheduler``'s on the same requests and weights.

Every HTTP call has a 10 s timeout, every thread join one, servers bind
``127.0.0.1:0`` and shut down in fixture teardown."""

import dataclasses
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch

from lmrs_tpu.engine.mock import MockEngine as JMock
from lmrs_tpu.serving.server import EngineHTTPServer as JServer
from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
from lmrs_tpu_torch.engine.api import GenerationRequest
from lmrs_tpu_torch.engine.mock import MockEngine
from lmrs_tpu_torch.engine.torch_engine import TorchEngine
from lmrs_tpu_torch.models.convert import params_from_jax
from lmrs_tpu_torch.serving.server import EngineHTTPServer

from conftest import free_port

REPO = Path(__file__).resolve().parents[1]
REF_OFF = {"LMRS_COST_LEDGER": "0", "LMRS_SLO": "0", "LMRS_ANATOMY": "0",
           "LMRS_QOS": "0"}
# ids, clocks, random ticket ids, and the key of a later slice
DROP = {"id", "created", "uptime_s", "ticket", "trace", "slo"}
TIMEOUT = 10.0
CFG = dict(vocab_size=300, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
           hidden_dim=160, max_seq_len=128, dtype="float32",
           tie_embeddings=False)
TEXT = ("Transcript section: [00:01] The committee opened with the budget "
        "review for the coming year. [00:05] Several members raised the "
        "question of maintenance costs for the old building. [00:09] The "
        "chair proposed a vote on the revised plan next week.")


class Recording:
    """Mixin: keep the requests a mock saw and the ids it was asked to
    cancel (the mock clears its own cancel set after each batch)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen, self.cancel_log = [], []

    def generate_batch(self, requests, on_result=None, on_tokens=None):
        self.seen.extend(requests)
        return super().generate_batch(requests, on_result=on_result,
                                      on_tokens=on_tokens)

    def cancel(self, request_id):
        self.cancel_log.append(request_id)
        super().cancel(request_id)


class PortMock(Recording, MockEngine):
    pass


class RefMock(Recording, JMock):
    def __init__(self, **kw):
        super().__init__(cost_ledger=False, slo=False, qos=False, **kw)


@pytest.fixture
def servers(monkeypatch):
    """Build (port, reference) servers over fresh mocks; shut them down."""
    for k, v in REF_OFF.items():
        monkeypatch.setenv(k, v)
    made = []

    def make(window_s=0.01, cap=4096, **mock_kw):
        pair = (EngineHTTPServer(PortMock(**mock_kw), port=0,
                                 batch_window_s=window_s, max_tokens_cap=cap),
                JServer(RefMock(**mock_kw), port=0, batch_window_s=window_s,
                        max_tokens_cap=cap))
        for srv in pair:
            srv.start_background()
            made.append(srv)
        return pair

    yield make
    # in parallel: each shutdown waits out its server's 0.5 s poll
    threads = [threading.Thread(target=srv.shutdown) for srv in made]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)


@pytest.fixture(scope="module")
def shared():
    """One (port, reference) pair for the tests whose answers do not
    depend on what ran before (the mocks are deterministic)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_OFF.items():
            mp.setenv(k, v)
        pair = (EngineHTTPServer(PortMock(), port=0, batch_window_s=0.01,
                                 max_tokens_cap=64),
                JServer(RefMock(), port=0, batch_window_s=0.01,
                        max_tokens_cap=64))
        for srv in pair:
            srv.start_background()
        yield pair
        threads = [threading.Thread(target=srv.shutdown) for srv in pair]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)


def call(srv, method, path, body=None, headers=None, raw=None):
    """(status, content type, text) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=TIMEOUT)
    try:
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return (resp.status, resp.getheader("Content-Type", ""),
                resp.read().decode())
    finally:
        conn.close()


def norm(doc):
    if isinstance(doc, dict):
        return {k: norm(v) for k, v in doc.items() if k not in DROP}
    if isinstance(doc, list):
        return [norm(v) for v in doc]
    return doc


def both(pair, method, path, body=None, headers=None, raw=None):
    """Send the same request to both servers; (status, normalized doc) of
    each."""
    out = []
    for srv in pair:
        status, _ctype, text = call(srv, method, path, body, headers, raw)
        out.append((status, norm(json.loads(text))))
    return out


def sse_events(text: str) -> list[dict]:
    """(event, data) frames of an SSE body, data parsed unless [DONE]."""
    out = []
    for frame in text.split("\n\n"):
        if not frame.strip():
            continue
        ev, data = None, None
        for line in frame.split("\n"):
            if line.startswith("event: "):
                ev = line[7:]
            elif line.startswith("data: "):
                data = line[6:]
        out.append({"event": ev,
                    "data": data if data == "[DONE]" else norm(json.loads(data))})
    return out


def deltas_of(events: list[dict]) -> list[str]:
    """The text deltas of either wire's stream."""
    parts = []
    for e in events:
        d = e["data"]
        if d == "[DONE]":
            continue
        if "choices" in d and d["choices"][0]["delta"].get("content"):
            parts.append(d["choices"][0]["delta"]["content"])
        elif d.get("type") == "content_block_delta":
            parts.append(d["delta"]["text"])
    return parts


def joined(events: list[dict]) -> str:
    return "".join(deltas_of(events))


# ------------------------------------------------------------ wire parity

BODIES = [
    ("/v1/chat/completions",
     {"messages": [{"role": "system", "content": "Be brief."},
                   {"role": "user", "content": TEXT}], "temperature": 0}),
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": [{"type": "text", "text": TEXT}]},
                   {"role": "assistant", "content": "ok"},
                   {"role": "tool", "content": "Transcript section: more."}],
      "model": "custom-name", "top_k": 3, "seed": 4}),
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": TEXT}], "stop": "budget",
      "max_tokens": 100000}),
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": TEXT}],
      "stop": ["zzz", "members"], "cache_prefix": 20}),
    ("/v1/messages",
     {"system": "You summarize.", "max_tokens": 64,
      "messages": [{"role": "user", "content": TEXT}]}),
    ("/v1/messages",
     {"system": [{"type": "text", "text": "Blocks."}], "max_tokens": 0,
      "messages": [{"role": "system", "content": "In messages too."},
                   {"role": "user", "content": TEXT}]}),
    ("/v1/messages",
     {"messages": [{"role": "user", "content": TEXT}],
      "stop_sequences": "chair"}),
    ("/v1/messages",
     {"messages": [{"role": "user", "content": TEXT}],
      "stop_sequences": ["nothing-like-this"], "top_k": 2}),
]


@pytest.mark.parametrize("path,body", BODIES)
def test_completion_bodies_match_reference(shared, path, body):
    pair = shared
    got, want = both(pair, "POST", path, body)
    assert got == want
    assert got[0] == 200


def test_stop_reasons_and_cap_reach_the_engine(servers):
    """The cap clamps max_tokens, a stop hit reports ``stop_sequence`` on
    the Anthropic wire, the system role lands in the system prompt."""
    pair = servers(cap=64)
    status, _, text = call(pair[0], "POST", "/v1/messages", BODIES[6][1])
    doc = json.loads(text)
    assert status == 200 and doc["stop_reason"] == "stop_sequence"
    assert doc["stop_sequence"] == "chair"
    call(pair[0], "POST", "/v1/chat/completions", BODIES[2][1])
    call(pair[0], "POST", "/v1/messages", BODIES[5][1])
    seen = pair[0].engine.seen
    assert seen[1].max_new_tokens == 64 and seen[1].stop == ("budget",)
    assert seen[2].max_new_tokens == 0
    assert seen[2].system_prompt == "Blocks.\n\nIn messages too."


def test_get_routes_match_reference(servers):
    pair = servers()
    for path, body in BODIES[:2] + BODIES[4:5]:
        both(pair, "POST", path, body)
    for path in ("/healthz", "/v1/models", "/metrics"):
        got, want = both(pair, "GET", path)
        assert got == want, path
    health = json.loads(call(pair[0], "GET", "/healthz")[2])
    assert health["status"] == "ok" and health["prefix_summary"]
    metrics = json.loads(call(pair[0], "GET", "/metrics")[2])
    assert metrics["http_batches"] == 3 and metrics["http_requests"] == 3
    # the second body declares no shared preamble: no cache query
    assert metrics["engine"]["prefix_cache"]["queries"] == 2
    # Prometheus text: the port's families are the reference's, same values
    pages = [call(s, "GET", "/metrics", headers={"Accept": "text/plain"})
             for s in pair]
    assert all(p[0] == 200 and p[1].startswith("text/plain") for p in pages)
    samples = [{ln.split(" ")[0]: ln.split(" ")[1]
                for ln in p[2].splitlines() if ln and not ln.startswith("#")}
               for p in pages]
    assert set(samples[0]) <= set(samples[1])
    for name in ("lmrs_http_batches_total", "lmrs_http_requests_total"):
        assert samples[0][name] == samples[1][name] == "3"


@pytest.mark.parametrize("method,path,raw,headers", [
    ("POST", "/v1/chat/completions", b"{not json", None),
    ("POST", "/v1/messages", b"[", None),
    ("GET", "/v1/nothing", None, None),
    ("POST", "/v1/nothing", b"{}", None),
    ("DELETE", "/v1/nothing", None, None),
    ("POST", "/v1/chat/completions", None, {"X-LMRS-Deadline": "abc"}),
    ("POST", "/v1/messages", None, {"X-LMRS-Deadline": "nan"}),
    ("POST", "/v1/chat/completions", None, {"X-LMRS-Deadline": "inf"}),
    ("POST", "/v1/chat/completions", None, {"X-LMRS-Deadline": "0"}),
    ("POST", "/v1/messages", None, {"X-LMRS-Deadline": "-1"}),
    ("POST", "/v1/chat/completions", None, {"X-LMRS-Deadline": "30"}),
])
def test_errors_and_deadlines_match_reference(shared, method, path, raw,
                                              headers):
    """400 on bad JSON and on an invalid deadline, 404 on an unknown route,
    an expired deadline shed before any work (both wires say ``shed``)."""
    pair = shared
    if raw is None and method == "POST":
        raw = json.dumps({"messages": [{"role": "user", "content": TEXT}]}
                         ).encode()
    got, want = both(pair, method, path, raw=raw, headers=headers)
    assert got == want
    if headers and headers["X-LMRS-Deadline"] in ("0", "-1"):
        doc = got[1]
        reason = (doc["choices"][0]["finish_reason"] if "choices" in doc
                  else doc["stop_reason"])
        assert got[0] == 200 and reason == "shed"


@pytest.mark.parametrize("deadline,status", [("soon", 400), (0, 200),
                                             (30.5, 200)])
def test_body_deadline_field_matches_reference(shared, deadline, status):
    pair = shared
    got, want = both(pair, "POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": TEXT}],
        "deadline_s": deadline})
    assert got == want and got[0] == status
    if deadline == 0:
        assert got[1]["choices"][0]["finish_reason"] == "shed"


@pytest.mark.parametrize("path,body", [BODIES[0], BODIES[2], BODIES[4],
                                       BODIES[6]])
def test_sse_streams_match_reference(shared, path, body):
    pair = shared
    sbody = {**body, "stream": True, "stream_options": {"include_usage": True}}
    streams = []
    for srv in pair:
        status, ctype, text = call(srv, "POST", path, sbody)
        assert status == 200 and ctype == "text/event-stream"
        streams.append(sse_events(text))
    assert streams[0] == streams[1]
    plain = json.loads(call(pair[0], "POST", path, body)[2])
    text = (plain["choices"][0]["message"]["content"] if "choices" in plain
            else plain["content"][0]["text"])
    assert joined(streams[0]) == text
    if path.endswith("messages"):
        assert [e["event"] for e in streams[0]] == [
            "message_start", "content_block_start", "content_block_delta",
            "content_block_stop", "message_delta", "message_stop"]
    else:
        assert streams[0][-1]["data"] == "[DONE]"
        assert streams[0][-2]["data"]["usage"] == plain["usage"]


def test_concurrent_requests_pool_into_one_wave(servers):
    """Six requests inside one batch window form ONE engine wave on each
    server, with the same texts."""
    pair = servers(window_s=0.5)
    texts = {}
    for srv in pair:
        out = [None] * 6

        def post(i, srv=srv, out=out):
            body = {"messages": [{"role": "user", "content": f"{i} {TEXT}"}]}
            out[i] = json.loads(call(srv, "POST", "/v1/chat/completions",
                                     body)[2])
        threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert srv.batcher.batches_run == 1 and srv.batcher.requests_served == 6
        texts[srv] = [o["choices"][0]["message"]["content"] for o in out]
    assert texts[pair[0]] == texts[pair[1]]
    assert len(pair[0].engine.seen) == 6


@pytest.mark.parametrize("stream", [False, True])
def test_client_disconnect_cancels(servers, stream):
    """A client that goes away while its request runs is cancelled through
    the engine's hook on both servers (the mock takes 1 s a request)."""
    pair = servers(latency_s=1.0)
    for srv in pair:
        body = json.dumps({"messages": [{"role": "user", "content": TEXT}],
                           "stream": stream}).encode()
        sock = socket.create_connection(("127.0.0.1", srv.port),
                                        timeout=TIMEOUT)
        sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\n"
                     b"Host: x\r\nContent-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        if stream:
            assert sock.recv(64).startswith(b"HTTP/1.1 200")
        time.sleep(0.1)
        sock.close()
        t0 = time.time()
        while not srv.engine.cancel_log and time.time() - t0 < TIMEOUT:
            time.sleep(0.05)
        assert srv.engine.cancel_log == [0]
        while srv.batcher.requests_served < 1 and time.time() - t0 < TIMEOUT:
            time.sleep(0.05)
        assert srv.batcher.requests_served == 1


def test_trace_header_adopted_or_minted(servers):
    pair = servers()
    body = {"messages": [{"role": "user", "content": TEXT}]}
    call(pair[0], "POST", "/v1/chat/completions", body,
         headers={"X-LMRS-Trace": "trace-1.a:b"})
    call(pair[0], "POST", "/v1/chat/completions", body,
         headers={"X-LMRS-Trace": "bad id!"})
    call(pair[0], "POST", "/v1/chat/completions", body)
    ids = [r.trace_id for r in pair[0].engine.seen]
    assert ids[0] == "trace-1.a:b"
    assert all(len(t) == 16 and int(t, 16) >= 0 for t in ids[1:])
    assert ids[1] != ids[2]


# ---------------------------------------------------- refused by name

@pytest.mark.parametrize("method,path,status,slice_", [
    ("GET", "/v1/jobs", 501, "A13"), ("POST", "/v1/jobs", 501, "A13"),
    ("GET", "/v1/jobs/j1", 501, "A13"), ("DELETE", "/v1/jobs/j1", 501, "A13"),
    ("GET", "/v1/sessions?x=1", 501, "A13"),
    ("POST", "/v1/sessions/s1/segments", 501, "A13"),
    ("DELETE", "/v1/sessions/s1", 501, "A13"),
    # the observability routes came with A10: the ids keep the status the
    # routes answered before (404); the status now held is the second one
    pytest.param("GET", "/v1/usage", 200, "A10",
                 id="GET-/v1/usage-404-A10"),
    pytest.param("GET", "/v1/anatomy", 501, "A10",
                 id="GET-/v1/anatomy-404-A10"),
    pytest.param("GET", "/v1/trace", 409, "A10",
                 id="GET-/v1/trace-404-A10"),
    pytest.param("POST", "/v1/debug/profile", 501, "A10",
                 id="POST-/v1/debug/profile-404-A10"),
])
def test_later_routes_are_refused_by_name(shared, method, path, status,
                                          slice_):
    """The job and session routes came with A13: a server started without
    ``jobs_dir`` / ``live_dir`` answers them as the reference does with
    the feature off (501, the same error type).  The observability routes
    came with A10 and answer as the reference's do over a mock with the
    ledger, SLO and anatomy off and tracing off: the usage page (200,
    ledger disabled), 501 for the anatomy, 409 for the trace and 501 for a
    profile on an engine without the hook, with the same error types."""
    pair = shared
    body = {} if method == "POST" else None
    code, _, text = call(pair[0], method, path, body)
    assert code == status
    ref_code, _, ref_text = call(pair[1], method, path, body)
    if slice_ == "A10":
        assert ref_code == code
        doc, ref = json.loads(text), json.loads(ref_text)
        if code == 200:
            assert doc["enabled"] is ref["enabled"] is False
            assert doc["tenants"] == ref["tenants"] == {}
        else:
            assert doc["error"]["type"] == ref["error"]["type"]
        return
    err = json.loads(text)["error"]
    if slice_ == "A13":
        ref_code, _, ref_text = call(pair[1], method, path, body)
        assert ref_code == 501
        assert err["type"] == json.loads(ref_text)["error"]["type"]
        assert "disabled on this host" in err["message"]
    else:
        assert f"({slice_}) slice" in err["message"]


@pytest.mark.parametrize("method,path,status", [
    ("GET", "/v1/handoff/t1", 410), ("POST", "/v1/handoff/t1/ack", 410),
    ("POST", "/v1/kv/export", 400), ("GET", "/v1/kv/t1", 410)])
def test_handoff_and_kv_routes_answer_like_reference(shared, method, path,
                                                     status):
    """The ``/v1/handoff`` and ``/v1/kv`` routes answer as the reference's
    do: an unknown ticket is gone (410), an export without a preamble is a
    400."""
    body = {} if method == "POST" else None
    got = both(shared, method, path, body)
    assert got[0] == got[1] and got[0][0] == status


def test_handoff_field_refused_tenant_headers_inert(shared):
    """``"handoff": true`` is served as in the reference (the mock pins its
    completion and the answer is a ticket); the tenant and QoS headers
    change no text."""
    pair = shared
    body = {"messages": [{"role": "user", "content": TEXT}]}
    got = both(pair, "POST", "/v1/chat/completions", {**body, "handoff": True})
    assert got[0] == got[1] and got[0][0] == 200
    assert got[0][1]["object"] == "handoff.ticket"
    plain = both(pair, "POST", "/v1/chat/completions", body)
    tagged = both(pair, "POST", "/v1/chat/completions", body,
                  headers={"X-LMRS-Tenant": "acme",
                           "X-LMRS-QoS-Class": "batch"})
    assert tagged == plain and tagged[0][0] == 200


def test_shutdown_rejects_new_requests():
    srv = EngineHTTPServer(MockEngine(), port=0)
    srv.start_background()
    srv.shutdown()
    res = srv.batcher.submit(GenerationRequest(prompt="late"))
    assert res.finish_reason == "error" and res.error == "server shutting down"
    job = srv.batcher.submit_stream(GenerationRequest(prompt="late"))
    assert job.deltas.get(timeout=TIMEOUT) is None and job.result.error


# ------------------------------------------- the port's engine behind it

def torch_engine(cfg=CFG, tokenizer=None, **kw):
    """A CPU ``TorchEngine`` from the JAX package's random init (seed 7)."""
    import jax

    from lmrs_tpu.config import ModelConfig as JModelConfig
    from lmrs_tpu.models.transformer import init_params as j_init_params

    tree = jax.tree.map(np.asarray, j_init_params(
        JModelConfig(name="t", **cfg), jax.random.PRNGKey(7)))
    tcfg = TModelConfig(name="t", **cfg)
    ecfg = EngineConfig(**{**dict(max_batch_slots=2, page_size=16,
                                  num_pages=40, decode_block=4,
                                  max_tokens=24), **kw})
    return TorchEngine(ecfg, tcfg, device="cpu",
                       params=params_from_jax(tree, tcfg),
                       tokenizer=tokenizer or ByteTokenizer()), tree


PROMPTS = ["hello world, this is", "a b c d e f g",
           "the meeting opened with the budget review and", "zz"]
PATHS = {"mixed": {}, "decode-blocks": {"mixed_batch": False},
         "tree": {"speculate_k": 2},
         "linear-spec": {"speculate_k": 2, "mixed_batch": False}}


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_streams_on_every_dispatch_path(path):
    """Four greedy requests over two slots (later prompts prefill beside
    decoding rows): every request's deltas join to its result text, a
    request with a stop string never streams past the cut, and no delta
    but a request's last ends in U+FFFD."""
    eng, _ = torch_engine(**PATHS[path])
    reqs = [GenerationRequest(prompt=p, request_id=i, temperature=0.0)
            for i, p in enumerate(PROMPTS)]
    plain = eng.generate_batch([dataclasses.replace(r) for r in reqs])
    cut = plain[1].text[5:8]
    reqs[1] = dataclasses.replace(reqs[1], stop=(cut,))
    deltas = defaultdict(list)
    got = eng.generate_batch(reqs, on_tokens=lambda rid, d: deltas[rid].append(d))
    assert eng.audit() == []
    for r in got:
        assert "".join(deltas[r.request_id]) == r.text
        assert all(not d.endswith("�") for d in deltas[r.request_id][:-1])
    assert [r.text for r in got[2:]] == [r.text for r in plain[2:]]
    assert got[1].stop_sequence == cut and got[1].text == \
        plain[1].text[:plain[1].text.index(cut)]
    assert max(len(d) for d in deltas.values()) > 1  # streamed incrementally
    m = eng.engine_metrics()
    if path == "mixed":
        assert m["mixed_batch"]["dispatches"] > 0
    if path == "tree":
        assert m["spec_tree"]["dispatches"] > 0
    if path == "linear-spec":
        assert m["spec_accepted_tokens"] >= 0 and m["decode_blocks"] > 0


def test_engine_deltas_equal_reference_scheduler():
    """The reference's ``ContinuousScheduler`` (through ``JaxEngine``) and
    the port's on the same weights, requests and config: identical deltas
    per request (exact), including the U+FFFD and stop holdbacks.  The
    model vocabulary is the byte tokenizer's (259), so neither sampler can
    pick an id the other one would skip."""
    import jax
    import jax.numpy as jnp

    from lmrs_tpu.config import EngineConfig as JEngineConfig
    from lmrs_tpu.config import ModelConfig as JModelConfig
    from lmrs_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
    from lmrs_tpu.engine.api import GenerationRequest as JRequest
    from lmrs_tpu.engine.jax_engine import JaxEngine

    cfg = {**CFG, "vocab_size": 259}
    kw = dict(max_batch_slots=2, page_size=16, num_pages=40, decode_block=4,
              max_tokens=20, prefix_cache=False)
    eng, tree = torch_engine(cfg, **kw)
    jeng = JaxEngine(JEngineConfig(backend="jax", scheduler="continuous",
                                   seed=0, retry_delay=0.0, **kw),
                     JModelConfig(name="t", **cfg),
                     params=jax.tree.map(jnp.asarray, tree),
                     tokenizer=JByteTokenizer())
    out = {}
    for name, e, mk in (("port", eng, GenerationRequest),
                        ("ref", jeng, JRequest)):
        deltas = defaultdict(list)
        res = e.generate_batch(
            [mk(prompt=p, request_id=i, temperature=0.0,
                stop=("ab",) if i == 1 else ())
             for i, p in enumerate(PROMPTS[:2])],
            on_tokens=lambda rid, d, deltas=deltas: deltas[rid].append(d))
        out[name] = ([r.text for r in res], dict(deltas))
    jeng.shutdown()
    assert out["port"] == out["ref"]
    texts, deltas = out["port"]
    assert any("�" in t for t in texts)  # the holdback was exercised
    assert all(len(v) > 1 for v in deltas.values())


@pytest.mark.parametrize("path", ["/v1/chat/completions", "/v1/messages"])
def test_server_streams_the_engine_greedy_text(path, monkeypatch):
    """The port's server over the port's CPU engine: the SSE deltas join to
    the non-streamed greedy text, and usage counts agree (the ledger's
    ``usage.cost`` bill on its tokens and tenant: its seconds are each
    response's own walls, and the second request hits the first's
    prefix).  The ledger is on, whatever this module's shared servers
    switched off."""
    monkeypatch.delenv("LMRS_COST_LEDGER", raising=False)
    eng, _ = torch_engine(max_tokens=32)
    srv = EngineHTTPServer(eng, port=0, batch_window_s=0.01)
    srv.start_background()
    try:
        body = {"messages": [{"role": "user", "content": PROMPTS[2]}],
                "temperature": 0, "max_tokens": 32}
        plain = json.loads(call(srv, "POST", path, body)[2])
        status, _, text = call(srv, "POST", path, {
            **body, "stream": True, "stream_options": {"include_usage": True}})
        events = sse_events(text)
    finally:
        srv.shutdown()
    assert status == 200

    def counts(usage: dict) -> dict:
        cost = {k: usage["cost"][k] for k in (
            "tenant", "prompt_tokens", "generated_tokens", "goodput_tokens",
            "wasted_tokens")}
        return {**usage, "cost": cost}

    if path.endswith("messages"):
        assert joined(events) == plain["content"][0]["text"]
        assert counts(events[-2]["data"]["usage"]) == counts(plain["usage"])
        assert plain["usage"]["output_tokens"] == 32
    else:
        assert joined(events) == plain["choices"][0]["message"]["content"]
        assert counts(events[-2]["data"]["usage"]) == counts(plain["usage"])
        assert plain["choices"][0]["finish_reason"] == "length"
    assert plain["usage"]["cost"]["generated_tokens"] == 32
    assert len(deltas_of(events)) > 1  # streamed at each host fetch


def test_engine_prefix_summary_publishes_donated_preambles():
    """``prefix_summary`` lists each donated preamble with its live
    coverage (whole pages; nothing spilled: the port has no spill tier)."""
    eng, _ = torch_engine()
    pre = "shared preamble " * 4
    reqs = [GenerationRequest(prompt=pre + b, request_id=i, temperature=0.0,
                              max_new_tokens=4, cache_prefix=len(pre))
            for i, b in enumerate(["one", "two", "three"])]
    eng.generate_batch(reqs)
    summary = eng.prefix_summary()
    assert len(summary) == 1
    row = summary[0]
    assert row["depth_tokens"] == 1 + len(pre)
    assert row["resident_tokens"] == (row["depth_tokens"] // 16) * 16 > 0
    assert row["spilled_tokens"] == row["spilled_pages"] == 0


# ------------------------------------------------------ lmrs-serve-torch

@pytest.mark.parametrize("flag,slice_", [
    (["--mesh", "1,2"], "A8"), (["--jobs-dir", "j"], "A13"), (["--live-dir", "l"], "A13"),
    pytest.param(["--supervise"], "A10b", id="flag3-A10"),
    pytest.param(["--trace"], "A10", id="flag4-A10")])
def test_serve_cli_refuses_later_flags(flag, slice_, capsys, monkeypatch):
    """Flags of later slices are refused by name (``--mesh`` names A8).
    ``--jobs-dir`` and ``--live-dir`` came with A13 and ``--trace`` with
    A10: they reach the server (its constructor is stubbed to record them
    and fail the bind, so ``main`` returns 1); ``--trace`` has turned the
    tracer on by then.  ``--supervise`` came with A10b's first half: it
    hands the argv minus the flag to the supervisor (stubbed to record it)
    and builds no engine in the parent."""
    from lmrs_tpu_torch.obs import disable_tracing, get_tracer
    from lmrs_tpu_torch.serving import cli, server, supervisor

    if slice_ == "A10b":
        seen = {}

        class FakeSupervisor:
            def __init__(self, child_argv, host, port):
                seen.update(argv=child_argv, host=host, port=port)

            def run(self):
                return 0

        monkeypatch.setattr(supervisor, "Supervisor", FakeSupervisor)
        monkeypatch.setattr(server, "EngineHTTPServer", lambda engine, **kw: (
            _ for _ in ()).throw(AssertionError("the parent built a server")))
        assert cli.main([*flag, "--backend", "mock", "--port", "8123",
                         "-q"]) == 0
        assert seen == {"argv": ["--backend", "mock", "--port", "8123", "-q"],
                        "host": "127.0.0.1", "port": 8123}
        return
    if slice_ == "A10":
        monkeypatch.setattr(server, "EngineHTTPServer", lambda engine, **kw: (
            _ for _ in ()).throw(OSError("bind refused (test)")))
        try:
            assert cli.main([*flag, "--backend", "mock", "-q"]) == 1
            assert get_tracer() is not None
        finally:
            disable_tracing()
        return
    if slice_ == "A13":
        seen = {}

        def fake_server(engine, **kw):
            seen.update(kw)
            raise OSError("bind refused (test)")

        monkeypatch.setattr(server, "EngineHTTPServer", fake_server)
        assert cli.main([*flag, "--backend", "mock", "-q"]) == 1
        key = flag[0][2:].replace("-", "_")
        assert seen[key] == flag[1]
        assert seen["pipeline_config"].engine.backend == "mock"
        return
    with pytest.raises(SystemExit) as exc:
        cli.main([*flag, "--backend", "mock"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag[0]} is not in the port yet" in err
    assert f"({slice_}) slice" in err


@pytest.mark.parametrize("flags,role,ttl", [
    (["--role", "prefill"], "prefill", 60.0),
    (["--role", "decode"], "decode", 60.0),
    (["--handoff-ttl", "5"], "both", 5.0)])
def test_serve_cli_role_flags(monkeypatch, flags, role, ttl):
    """``--role`` and ``--handoff-ttl`` reach the server (its constructor
    is stubbed to record them and fail the bind, so ``main`` returns 1)."""
    from lmrs_tpu_torch.serving import cli, server

    monkeypatch.delenv("LMRS_HANDOFF_TTL", raising=False)
    seen = {}

    class Stub:
        def __init__(self, engine, **kw):
            seen.update(kw)
            raise OSError("stub bind")

    monkeypatch.setattr(server, "EngineHTTPServer", Stub)
    assert cli.main([*flags, "--backend", "mock", "-q"]) == 1
    assert (seen["role"], seen["handoff_ttl_s"]) == (role, ttl)


def test_serve_cli_fails_when_the_engine_cannot_build():
    """No silent CPU fallback: without a card the default device fails
    the build, and the server exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from lmrs_tpu_torch.serving.cli import main

    assert main(["--port", "0", "-q"]) == 1


def test_serve_cli_serves_and_stops_on_sigint():
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "lmrs_tpu_torch.serving.cli", "--backend",
         "mock", "--port", str(port), "-q"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        t0, up = time.time(), False
        while time.time() - t0 < 60 and proc.poll() is None:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
                conn.request("GET", "/healthz")
                up = conn.getresponse().status == 200
                conn.close()
                break
            except OSError:
                time.sleep(0.2)
        assert up, proc.stderr.read().decode()[-2000:] if proc.poll() else ""
        srv = type("S", (), {"port": port})
        status, _, text = call(srv, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": TEXT}]})
        assert status == 200 and json.loads(text)["choices"][0]["message"]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
        proc.stderr.close()


def test_stop_holdback_never_streams_past_a_later_cut():
    """The hold of ``max(len(stop)) - 1`` characters never lets an emitted
    character pass a later truncation point: texts growing a character at
    a time against stops of length 1-3."""
    from lmrs_tpu_torch.engine.api import apply_stop_sequences
    from lmrs_tpu_torch.engine.scheduler import ContinuousScheduler

    sched = ContinuousScheduler.__new__(ContinuousScheduler)
    for stop in ("b", "ab", "bab"):
        for full in ("aababb", "bbbbba", "aaaaab"):
            sent = []
            sched._on_tokens = lambda rid, d: sent.append(d)
            sched._streamed = {}
            req = GenerationRequest(prompt="", stop=(stop,))
            for n in range(1, len(full) + 1):
                text, hit = apply_stop_sequences(full[:n], (stop,))
                done = hit is not None or n == len(full)
                sched._stream(req, text, done)
                assert text.startswith("".join(sent))
                if done:
                    break
            assert "".join(sent) == text
