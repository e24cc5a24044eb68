"""Port parity of KV movement: the wire codec and ticket bookkeeping
(``serving/handoff.py``) against the JAX package's, byte for byte in both
directions (bf16 as raw words, int8); ``PagedKVCache`` page-set exports
bit-equal to the JAX package's over the same pool contents, and the same
import rejections and back-pressure; the disaggregated handoff on the
port's ``TorchEngine`` at f32 on the CPU (``test_torch_engine.py``'s CFG):
greedy equal to colocated (prefix cache on and off, and int8 KV with its
scales in the payload), a terminal first token never pins, the orphan
sweep reclaims pins, a drifted payload is a marked error; then the serving
layer over in-process mock servers: the port's router over a prefill and a
decode server of either package (both pairings), its colocated fallback
when the decode server is gone, the ``/v1/kv`` export, import and ack flow
(a duplicate, a bad ticket, an unreachable source), and the router's
prefetch spread.  Tolerance: exact.  Every HTTP call has a timeout of 10 s
or less; servers bind ``127.0.0.1:0`` and shut down in teardown."""

import dataclasses
import http.client
import json
import threading
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lmrs_tpu.config import ModelConfig as JModelConfig
from lmrs_tpu.engine.kv_cache import OutOfPages as JOutOfPages
from lmrs_tpu.engine.kv_cache import PagedKVCache as JCache
from lmrs_tpu.engine.mock import MockEngine as JMock
from lmrs_tpu.serving import handoff as jh
from lmrs_tpu.serving.server import EngineHTTPServer as JServer
from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.engine.api import GenerationRequest, preamble_key
from lmrs_tpu_torch.engine.host_kv import BF16
from lmrs_tpu_torch.engine.kv_cache import OutOfPages as TOutOfPages
from lmrs_tpu_torch.engine.kv_cache import PagedKVCache as TCache
from lmrs_tpu_torch.engine.kv_cache import SequencePages
from lmrs_tpu_torch.engine.mock import MockEngine
from lmrs_tpu_torch.engine.torch_engine import TorchEngine
from lmrs_tpu_torch.serving import handoff as th
from lmrs_tpu_torch.serving.router import RouterEngine
from lmrs_tpu_torch.serving.server import EngineHTTPServer

from test_torch_engine import CFG, IdTokenizer

TIMEOUT = 10.0
REF_OFF = {"LMRS_COST_LEDGER": "0", "LMRS_SLO": "0", "LMRS_ANATOMY": "0",
           "LMRS_QOS": "0"}


@pytest.fixture(autouse=True)
def ref_surfaces_off(monkeypatch):
    for k, v in REF_OFF.items():
        monkeypatch.setenv(k, v)


# ------------------------------------------------------------------ codec

def _pages(kind: str, pkg: str, shape=(2, 3, 2, 8, 4)) -> np.ndarray:
    """The same page bytes in both packages' array types."""
    rng = np.random.default_rng(11)
    if kind == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    words = rng.integers(0, 1 << 16, shape).astype(np.uint16)
    return words.view(BF16 if pkg == "port" else ml_dtypes.bfloat16)


def _wire_payload(kind: str, pkg: str) -> dict:
    return {"version": 1, "kv_len": 19, "n_pages": 3,
            "dtype": "int8" if kind == "int8" else "bfloat16",
            "k": _pages(kind, pkg), "v": _pages(kind, pkg)[::-1].copy(),
            "kscale": np.linspace(0.5, 2.0, 16, dtype=np.float32),
            "tokens": [1, 2, 3], "generated": [7]}


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_codec_cross_package(kind, writer):
    """Encoded by either package, decoded by the other: the same bytes on
    the wire, the same arrays out (bf16 as raw words in the port)."""
    enc = {"port": th.encode_payload, "ref": jh.encode_payload}
    dec = {"port": th.decode_payload, "ref": jh.decode_payload}
    reader = "ref" if writer == "port" else "port"
    blob = enc[writer](_wire_payload(kind, writer))
    assert blob == enc[reader](_wire_payload(kind, reader))
    out = dec[reader](blob)
    want = _wire_payload(kind, reader)
    for key, val in want.items():
        if isinstance(val, np.ndarray):
            assert out[key].dtype == val.dtype
            assert out[key].tobytes() == val.tobytes()
            assert out[key].shape == val.shape
        else:
            assert out[key] == val
    if reader == "port" and kind == "bf16":
        t = torch.from_numpy(out["k"].view(np.int16).copy()).view(torch.bfloat16)
        ref = jh.decode_payload(blob)["k"].astype(np.float32)
        assert torch.equal(t.float().isnan(), torch.from_numpy(np.isnan(ref)))
        fin = ~np.isnan(ref)
        assert np.array_equal(t.float().numpy()[fin], ref[fin])


@pytest.mark.parametrize("cut", [4, 20, -3])
def test_codec_rejects_truncation_alike(cut):
    blob = th.encode_payload(_wire_payload("int8", "port"))
    short = blob[:cut]
    errors = []
    for dec in (th.decode_payload, jh.decode_payload):
        with pytest.raises(ValueError) as exc:
            dec(short)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_ticket_registry_and_import_log_alike():
    """The same lifecycle (lookup, consume once, expiry, sweep) answers
    alike in both packages; the import log dedups alike."""
    outs = []
    for mod in (th, jh):
        t = [100.0]
        reg = mod.TicketRegistry(clock=lambda: t[0])
        a = reg.create(7, deadline_t=110.0, trace_id="tr")
        b = reg.create(8, deadline_t=105.0)
        steps = [reg.lookup(a)["rid"], reg.lookup(a)["trace_id"],
                 reg.consume(a), reg.consume(a), reg.lookup(a),
                 reg.consume("nope"), reg.stats()]
        t[0] = 106.0
        steps += [reg.lookup(b), reg.consume(b),
                  [(rid, consumed) for _t, rid, consumed in reg.sweep()],
                  reg.stats()]
        t[0] = 111.0
        steps += [[(rid, consumed) for _t, rid, consumed in reg.sweep()],
                  reg.stats()]
        log = mod.ImportLog(cap=2)
        steps += [log.add("x"), log.add("x"), log.seen("x"), log.add("y"),
                  log.add("z"), log.seen("x"), log.seen("z")]
        outs.append(steps)
    assert outs[0] == outs[1]


# ------------------------------------------------------- page-set exports

KINDS = {"bf16": ("bfloat16", None, torch.bfloat16),
         "int8": ("bfloat16", "int8", torch.int8),
         "f32": ("float32", None, torch.float32)}
GEOM = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64)  # hd 16


def _pool_values(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    vals = rng.standard_normal(shape).astype(np.float32)
    if kind == "bf16":  # values bf16 holds exactly, so both casts agree
        vals = torch.from_numpy(vals).bfloat16().float().numpy()
    return vals


def _cache_pair(kind, num_pages=16, ps=8, max_pages=8):
    model_dtype, kv_dtype, tdtype = KINDS[kind]
    jc = JCache(JModelConfig(dtype=model_dtype, **GEOM), num_pages, ps,
                max_pages, kv_dtype=kv_dtype)
    tc = TCache(TModelConfig(dtype=model_dtype, **GEOM), num_pages, ps,
                max_pages, device="cpu", dtype=tdtype)
    for name, seed in (("k", 1), ("v", 2)):
        vals = _pool_values(kind, tuple(tc.k.shape), seed)
        setattr(jc, name, jnp.asarray(vals, jc.k.dtype))
        getattr(tc, name).copy_(torch.from_numpy(vals).to(tdtype))
    return jc, tc


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_exports_bit_equal_to_reference(kind):
    """``export_sequence`` (a ragged length: the last page partial) and
    ``export_pages`` of the same pool contents encode to the same bytes in
    both packages; an import lands the same bytes."""
    from lmrs_tpu.engine.kv_cache import SequencePages as JSeq

    jc, tc = _cache_pair(kind)
    pages = [3, 9, 5]
    jseq = jc.export_sequence(JSeq(pages=list(pages)), 19)
    tseq = tc.export_sequence(SequencePages(pages=list(pages)), 19)
    assert th.encode_payload(tseq) == jh.encode_payload(jseq)
    assert th.encode_payload(tc.export_pages([2, 4])) == \
        jh.encode_payload(jc.export_pages([2, 4]))
    # the wire payload imported into a pool with a different free list
    _jd, td = _cache_pair(kind, num_pages=24)
    held = td.alloc_pages(5)
    got = td.import_sequence(th.decode_payload(jh.encode_payload(jseq)))
    assert got.length == 19 and set(got.pages).isdisjoint(held)
    again = td.export_sequence(got, 19)
    assert th.encode_payload(again) == th.encode_payload(tseq)


def test_import_rejections_and_back_pressure_match_reference():
    """Geometry and dtype mismatches are ``ValueError`` naming the field,
    with nothing allocated; a full pool is ``OutOfPages`` and the import
    fits once pages free — in both packages."""
    from lmrs_tpu.engine.kv_cache import SequencePages as JSeq

    out = []
    for pkg in ("port", "ref"):
        jc, tc = _cache_pair("f32")
        src = tc if pkg == "port" else jc
        seq = (SequencePages if pkg == "port" else JSeq)(pages=[1, 2])
        payload = src.export_sequence(seq, 10)
        res = []
        for kind, num_pages, ps in (("f32", 16, 16), ("int8", 16, 8)):
            jo, to = _cache_pair(kind, num_pages=num_pages, ps=ps)
            dst = to if pkg == "port" else jo
            with pytest.raises(ValueError) as exc:
                dst.import_sequence(payload)
            res.append((str(exc.value), dst.allocator.free_count))
        for bad in ({"n_pages": 0}, {"kv_len": 40}):
            with pytest.raises(ValueError) as exc:
                (tc if pkg == "port" else jc).import_sequence(
                    {**payload, **bad})
            res.append(str(exc.value))
        jd, td = _cache_pair("f32", num_pages=4)
        dst = td if pkg == "port" else jd
        held = dst.alloc_pages(2)
        with pytest.raises(TOutOfPages if pkg == "port" else JOutOfPages):
            dst.import_sequence(payload)
        res.append(dst.allocator.free_count)
        dst.allocator.free(held)
        res.append(len(dst.import_sequence(payload).pages))
        out.append(res)
    assert out[0] == out[1]


# --------------------------------------------------------- engine level

PROMPTS = ["the quick brown fox jumps over the lazy dog",
           "the quick brown fox jumps over the fence again"]


def _engine(**kw):
    cfg = EngineConfig(**{"page_size": 16, "num_pages": 48,
                          "max_batch_slots": 4, "decode_block": 4,
                          "max_tokens": 12, **kw})
    return TorchEngine(cfg, TModelConfig(**CFG), device="cpu",
                       tokenizer=IdTokenizer())


def _greedy(prompt, rid, **kw):
    return GenerationRequest(prompt=prompt, request_id=rid, temperature=0.0,
                             max_new_tokens=12, **kw)


@pytest.fixture(scope="module", params=["cache_on", "cache_off"])
def trio(request):
    kw = {} if request.param == "cache_on" else {"prefix_cache": False}
    return request.param, tuple(_engine(**kw) for _ in range(3))


def test_disagg_matches_colocated_greedy(trio):
    """Prefill engine -> wire payload -> decode engine: the colocated
    text, finish and count; both audits clean with the pins accounted,
    and a clean pool after the release."""
    mode, (colo, pre, dec) = trio
    prompts = PROMPTS + ([PROMPTS[0]] if mode == "cache_on" else [])
    for i, prompt in enumerate(prompts):
        base = colo.generate_batch([_greedy(prompt, i)])[0]
        assert base.completion_tokens > 1
        res_p = pre.generate_batch([_greedy(prompt, i, handoff_export=True)])[0]
        assert res_p.finish_reason == "handoff"
        assert res_p.completion_tokens == 1 and base.text.startswith(res_p.text)
        assert pre.pinned_handoffs()[i] >= 1 and pre.audit() == []
        payload = th.decode_payload(th.encode_payload(pre.export_handoff(i)))
        res_d = dec.generate_batch([_greedy(prompt, i, handoff_state=payload)])[0]
        assert (res_d.text, res_d.finish_reason, res_d.completion_tokens) == \
            (base.text, base.finish_reason, base.completion_tokens)
        assert pre.release_handoff(i) >= 1 and pre.release_handoff(i) == 0
        assert pre.audit() == [] and dec.audit() == []
    assert pre.pinned_handoffs() == {}
    assert dec._scheduler.metrics["handoff_imports"] == len(prompts)


def test_terminal_first_token_never_pins(trio):
    _, (_, pre, _) = trio
    res = pre.generate_batch([GenerationRequest(
        prompt="short", request_id=90, temperature=0.0, max_new_tokens=1,
        handoff_export=True)])[0]
    assert res.finish_reason == "length" and res.completion_tokens == 1
    assert pre.pinned_handoffs() == {} and pre.audit() == []


def test_import_rejects_token_mismatch(trio):
    """A payload whose tokens disagree with this engine's encoding of the
    prompt is a marked error, and the pool stays clean."""
    _, (_, pre, dec) = trio
    pre.generate_batch([_greedy("mismatch probe prompt", 91,
                                handoff_export=True)])
    res = dec.generate_batch([_greedy(
        "a different prompt entirely, much longer than before", 91,
        handoff_state=dict(pre.export_handoff(91)))])[0]
    assert res.finish_reason == "error" and "handoff import failed" in res.error
    assert dec.audit() == []
    pre.release_handoff(91)
    assert pre.audit() == []


def test_engine_orphan_sweep_reclaims_pins(trio):
    _, (_, pre, _) = trio
    pre.generate_batch([_greedy("orphan sweep probe", 92, handoff_export=True)])
    sched = pre._scheduler
    before = sched.metrics["handoff_orphaned_pages"]
    released = pre.sweep_handoffs(now=time.time() + 3600.0)
    assert released >= 1 and pre.pinned_handoffs() == {}
    assert sched.metrics["handoff_orphaned_pages"] == before + released
    assert pre.audit() == []


def test_release_during_a_run_is_deferred():
    """An ack landing while the exporting engine runs frees the pages at
    the next block boundary, not from the handler thread."""
    pre = _engine()
    pre.generate_batch([_greedy(PROMPTS[0], 1, handoff_export=True)])
    seen = {}

    def on_result(res, submit):
        seen["n"] = pre.release_handoff(1)
        seen["deferred"] = len(pre._scheduler._release_deferred)

    pre.generate_batch([_greedy(PROMPTS[1], 2)], on_result=on_result)
    assert seen["n"] >= 1 and seen["deferred"] == 1
    assert pre._scheduler._release_deferred == [] and pre.audit() == []


def test_int8_kv_handoff_carries_scales():
    """Under int8 KV the per-slot scales ride the payload and land in the
    importing slot's rows: the colocated text."""
    colo, pre, dec = (_engine(kv_quantize="int8", page_size=32)
                      for _ in range(3))
    base = colo.generate_batch([_greedy(PROMPTS[0], 1)])[0]
    assert pre.generate_batch([_greedy(PROMPTS[0], 1, handoff_export=True)]
                              )[0].finish_reason == "handoff"
    payload = th.decode_payload(th.encode_payload(pre.export_handoff(1)))
    assert payload["dtype"] == "int8" and payload["kscale"].shape == (2, 1, 64)
    got = dec.generate_batch([_greedy(PROMPTS[0], 1, handoff_state=payload)])[0]
    assert got.text == base.text
    missing = {k: v for k, v in payload.items() if k != "kscale"}
    bad = dec.generate_batch([_greedy(PROMPTS[0], 2, handoff_state=missing)])[0]
    assert bad.finish_reason == "error" and dec.audit() == []


# ----------------------------------------------------- serving (mocks)

def _server(pkg, **kw):
    if pkg == "port":
        srv = EngineHTTPServer(MockEngine(), port=0, batch_window_s=0.01, **kw)
    else:
        srv = JServer(JMock(cost_ledger=False, slo=False, qos=False), port=0,
                      batch_window_s=0.01, **kw)
    srv.start_background()
    return srv


def _close(*servers):
    threads = [threading.Thread(target=s.shutdown) for s in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=None if body is None else
                     json.dumps(body), headers={"Content-Type":
                                                "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw)
        except ValueError:
            return resp.status, raw
    finally:
        conn.close()


BODY = ("Transcript section: [00:01] The committee opened with the budget "
        "review for the coming year. [00:05] Several members raised the "
        "question of maintenance costs for the old building.")


def _requests(n, pre="Summarize the section below.\n"):
    return [GenerationRequest(prompt=f"{pre}{i}: {BODY}", request_id=i,
                              cache_prefix=len(pre), temperature=0.0)
            for i in range(n)]


@pytest.mark.parametrize("prefill_pkg,decode_pkg", [("port", "ref"),
                                                    ("ref", "port")])
def test_router_over_mixed_package_pair(prefill_pkg, decode_pkg):
    """The port's router over a prefill server of one package and a
    decode server of the other: every request hands off and comes back
    with the text a colocated mock makes."""
    p = _server(prefill_pkg, role="prefill")
    d = _server(decode_pkg, role="decode")
    router = RouterEngine([], timeout_s=TIMEOUT,
                          prefill_hosts=[f"127.0.0.1:{p.port}"],
                          decode_hosts=[f"127.0.0.1:{d.port}"])
    try:
        reqs = _requests(4)
        got = router.generate_batch(reqs)
        want = MockEngine().generate_batch([dataclasses.replace(r)
                                            for r in reqs])
        assert [r.text for r in got] == [r.text for r in want]
        assert all(r.error is None for r in got)
        m = router.engine_metrics()
        assert m["handoff"] == {"handoffs": 4, "retries": 0, "fallbacks": 0}
        assert set(m["pools"]) == {"prefill", "decode"}
        assert _http(p.port, "GET", "/metrics")[1]["handoff"]["acks"] == 4
        assert not p.engine.pinned_handoffs()
    finally:
        router.shutdown()
        _close(p, d)


def test_router_falls_back_colocated_without_the_decode_server():
    """With the decode server gone the flow degrades: the request
    re-prefills on the prefill server (which serves plain requests whole)
    and the unacked ticket's pin is swept."""
    p = _server("port", role="prefill", handoff_ttl_s=0.5)
    d = _server("port", role="decode")
    router = RouterEngine([], timeout_s=TIMEOUT,
                          prefill_hosts=[f"127.0.0.1:{p.port}"],
                          decode_hosts=[f"127.0.0.1:{d.port}"])
    try:
        _close(d)
        got = router.generate_batch(_requests(1))[0]
        assert got.error is None and got.finish_reason == "stop"
        assert router._handoff_fallbacks == 1
        assert p.engine.pinned_handoffs()
        p.sweep_handoffs(now=time.time() + 60)
        assert not p.engine.pinned_handoffs()
    finally:
        router.shutdown()
        _close(p)


@pytest.mark.parametrize("src_pkg,dst_pkg", [("port", "port"), ("port", "ref"),
                                             ("ref", "port")])
def test_kv_wire_export_import_ack(src_pkg, dst_pkg):
    """Warm a preamble on A, export it, import it on B (B pulls and acks):
    a duplicate import is 409, the acked ticket 410, a bad ticket and an
    unreachable source fail without installing anything, and B then hits
    the preamble."""
    a, b = _server(src_pkg), _server(dst_pkg)
    try:
        req = _requests(1)[0]
        body = {"messages": [{"role": "user", "content": req.prompt}],
                "cache_prefix": req.cache_prefix}
        assert _http(a.port, "POST", "/v1/chat/completions", body)[0] == 200
        key = preamble_key(None, req.prompt, req.cache_prefix)
        st, doc = _http(a.port, "POST", "/v1/kv/export", {"preamble": key})
        assert st == 200 and doc["object"] == "kv.ticket" and doc["tokens"] > 0
        src = f"127.0.0.1:{a.port}"
        st, idoc = _http(b.port, "POST", "/v1/kv/import",
                         {"ticket": doc["ticket"], "source": src})
        assert st == 200 and idoc["imported_tokens"] == doc["tokens"]
        assert _http(b.port, "POST", "/v1/kv/import",
                     {"ticket": doc["ticket"], "source": src})[0] == 409
        assert _http(a.port, "GET", f"/v1/kv/{doc['ticket']}")[0] == 410
        assert _http(b.port, "POST", "/v1/kv/import",
                     {"ticket": "bogus", "source": src})[0] >= 400
        assert _http(b.port, "POST", "/v1/kv/import",
                     {"ticket": "t", "source": "127.0.0.1:1"})[0] >= 400
        assert _http(b.port, "POST", "/v1/kv/import", {})[0] == 400
        assert _http(a.port, "POST", "/v1/kv/export",
                     {"preamble": "never-seen"})[0] == 404
        assert _http(b.port, "POST", "/v1/chat/completions", body)[0] == 200
        m = _http(b.port, "GET", "/metrics")[1]
        assert m["engine"]["kv_migrate"]["imports"] == 1
        assert m["engine"]["prefix_cache"]["hits"] == 1
        assert "pinned_bytes" in m["kv_migrate"]
    finally:
        _close(a, b)


def test_kv_migrate_switch_off_answers_501(monkeypatch):
    monkeypatch.setenv("LMRS_KV_MIGRATE", "0")
    srv = _server("port")
    try:
        for method, path in (("POST", "/v1/kv/export"), ("GET", "/v1/kv/t"),
                             ("POST", "/v1/kv/t/ack"), ("POST", "/v1/kv/import")):
            assert _http(srv.port, method, path,
                         {} if method == "POST" else None)[0] == 501
        assert "kv_migrate" not in _http(srv.port, "GET", "/metrics")[1]
    finally:
        _close(srv)


def test_router_prefetch_spread():
    """A same-preamble group larger than one host's fair share, placed on
    a host whose summary predicts a hit: the siblings pull the page set
    first (``lmrs_kv_migrate_prefetches_total`` above 0)."""
    a, b = _server("port"), _server("port")
    router = RouterEngine([f"127.0.0.1:{a.port}", f"127.0.0.1:{b.port}"],
                          timeout_s=TIMEOUT)
    try:
        reqs = _requests(8)
        assert _http(a.port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": reqs[0].prompt}],
            "cache_prefix": reqs[0].cache_prefix})[0] == 200
        router._refresh_summaries()
        t0 = time.time()
        while len(router._summaries) < 2 and time.time() - t0 < TIMEOUT:
            time.sleep(0.02)
        got = router.generate_batch(reqs)
        assert all(r.error is None for r in got)
        while router._kv_prefetches < 1 and time.time() - t0 < TIMEOUT:
            time.sleep(0.02)
        assert router._kv_prefetches >= 1
        assert "lmrs_kv_migrate_prefetches_total 1" in \
            router.prometheus_metrics()
        assert router.engine_metrics()["kv_migrate"]["prefetches"] >= 1
    finally:
        router.shutdown()
        _close(a, b)
