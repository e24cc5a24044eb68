"""Port parity, live sessions: the port's incremental chunking, the
append-stable reduce tree with its node cache, ``SessionManager``, its HTTP
surface and router forwarding, and the cross-refresh draft hint, against
the JAX package's.

* Chunking: the incremental chunker's snapshots (``Chunk.to_dict``) equal
  the JAX package's on the same append batches.
* The stable tree: the nodes computed and reused over a growing leaf list
  equal the reference aggregator's, and the summary equals a cold run.
* Sessions (mock engines): appends in batches against a cold session fed
  at once (equal chunks, the same summary), every refresh document equal
  to the JAX package's (node and chunk reuse included), refresh 2 carrying
  refresh 1's summary as ``draft_hint``, journal rehydration after a
  shutdown, close, and the HTTP surface beside the reference server's.
* The draft hint on the real engine: a ``TorchEngine`` at test widths (f32,
  CPU, byte tokenizer, ``speculate_k=3``, tree speculation) gives the same
  greedy texts with and without a hint (under preemption too), more
  accepted drafts with it, and the texts of the JAX package's engine with
  the same hint and weights.

Every HTTP call carries its own timeout."""

from __future__ import annotations

import dataclasses
import json
import random
import urllib.request

import numpy as np
import pytest
import torch

from conftest import make_segments

REF_OFF = {"LMRS_COST_LEDGER": "0", "LMRS_SLO": "0", "LMRS_ANATOMY": "0",
           "LMRS_QOS": "0", "LMRS_KV_MIGRATE": "0"}
TIMEOUT = 30.0
# clocks, minted trace ids and the refresh wall differ run to run
DROP = {"created_t", "trace_id", "refreshed_t", "refresh_seconds"}


@pytest.fixture(autouse=True)
def _reference_surfaces_off(monkeypatch):
    for k, v in REF_OFF.items():
        monkeypatch.setenv(k, v)


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in DROP}
    if isinstance(doc, (list, tuple)):
        return [_strip(v) for v in doc]
    return doc


def live_config(pkg: str, **live_kw):
    """The reference live tests' surface: small chunks, arity 3, greedy,
    bulk refreshes."""
    if pkg == "port":
        from lmrs_tpu_torch import config as c
    else:
        from lmrs_tpu import config as c
    live = dict(class_default="bulk")
    live.update(live_kw)
    return c.PipelineConfig(
        chunk=c.ChunkConfig(max_tokens_per_chunk=150, overlap_tokens=0,
                            context_tokens=30, tokenizer="approx"),
        engine=c.EngineConfig(backend="mock", temperature=0.0, seed=0,
                              max_tokens=48, retry_delay=0.0),
        reduce=c.ReduceConfig(max_summaries_per_batch=3),
        live=c.LiveConfig(**live))


def manager(pkg: str, d, engine=None, **live_kw):
    if pkg == "port":
        from lmrs_tpu_torch.engine.mock import MockEngine
        from lmrs_tpu_torch.live import SessionManager
    else:
        from lmrs_tpu.engine.mock import MockEngine
        from lmrs_tpu.live import SessionManager
    return SessionManager(engine or MockEngine(seed=0), d,
                          config=live_config(pkg, **live_kw))


# ----------------------------------------------------------- chunking


@pytest.mark.parametrize("overlap", [0, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_incremental_chunking_matches_reference(seed, overlap):
    from lmrs_tpu.data.chunker import TranscriptChunker as JChunker
    from lmrs_tpu.data.preprocessor import preprocess_transcript as j_pre
    from lmrs_tpu_torch.data.chunker import TranscriptChunker
    from lmrs_tpu_torch.data.preprocessor import preprocess_transcript

    raw = make_segments(90, seed=seed)
    segs = preprocess_transcript(raw, merge_same_speaker=False)
    assert segs == j_pre(raw, merge_same_speaker=False)
    kw = dict(max_tokens_per_chunk=120, overlap_tokens=overlap,
              context_tokens=20, tokenizer="approx")
    inc, jinc = TranscriptChunker(**kw).incremental(), JChunker(**kw).incremental()
    rng = random.Random(seed)
    i = 0
    while i < len(segs):
        k = rng.randrange(1, 13)
        inc.append(segs[i:i + k])
        jinc.append(segs[i:i + k])
        i += k
        snap = [c.to_dict() for c in inc.chunks()]
        assert snap == [c.to_dict() for c in jinc.chunks()]
        assert (inc.sealed_count, inc.chunk_count, inc.n_segments) == (
            jinc.sealed_count, jinc.chunk_count, jinc.n_segments)
        assert [inc.chunker.stable_context_header(c) for c in inc.chunks()] \
            == [jinc.chunker.stable_context_header(c) for c in jinc.chunks()]
    one_shot = TranscriptChunker(**kw).chunk_transcript(segs)
    assert [c.to_dict() for c in inc.chunks()] == [c.to_dict() for c in one_shot]


# ----------------------------------------------------------- stable tree


class DictCache:
    """A node cache recording what the aggregator asked of it."""

    def __init__(self, node_key):
        self.node_key = node_key
        self.store: dict[str, str] = {}
        self.computed: list[str] = []
        self.hits: list[str] = []

    def lookup(self, node_id, summaries, template, metadata):
        text = self.store.get(self.node_key(summaries, template, metadata))
        if text is not None:
            self.hits.append(node_id)
        return text

    def record(self, node_id, summaries, template, metadata, text):
        self.store[self.node_key(summaries, template, metadata)] = text
        self.computed.append(node_id)


def _stable(pkg):
    if pkg == "port":
        from lmrs_tpu_torch.config import EngineConfig, ReduceConfig
        from lmrs_tpu_torch.data.chunker import Chunk
        from lmrs_tpu_torch.engine.executor import MapExecutor
        from lmrs_tpu_torch.engine.mock import MockEngine
        from lmrs_tpu_torch.jobs.journal import node_key
        from lmrs_tpu_torch.reduce.aggregator import ResultAggregator
    else:
        from lmrs_tpu.config import EngineConfig, ReduceConfig
        from lmrs_tpu.data.chunker import Chunk
        from lmrs_tpu.engine.executor import MapExecutor
        from lmrs_tpu.engine.mock import MockEngine
        from lmrs_tpu.jobs.journal import node_key
        from lmrs_tpu.reduce.aggregator import ResultAggregator

    def leaves(n):
        return [Chunk(chunk_index=i, start_time=i * 60.0,
                      end_time=(i + 1) * 60.0, speakers=["S"],
                      summary=f"Summary {i}: findings about item {i}.")
                for i in range(n)]

    def agg(stable=True):
        return ResultAggregator(
            MapExecutor(MockEngine(), EngineConfig(temperature=0.0)),
            ReduceConfig(stable_tree=stable, max_summaries_per_batch=3,
                         max_tokens_per_batch=50, reserve_tokens=0))
    return agg, leaves, DictCache(node_key)


def test_stable_tree_reuse_matches_reference():
    """Appending leaves recomputes only the dirty batch per level and the
    root; the ids computed and reused, level by level, equal the reference
    aggregator's, and each grown result equals a cold run."""
    out = {}
    for pkg in ("port", "reference"):
        agg, leaves, cache = _stable(pkg)
        a = agg()
        rounds = []
        for n in (12, 13, 16, 3):
            cache.computed, cache.hits = [], []
            res = a.aggregate(leaves(n), node_cache=cache)
            cold = agg().aggregate(leaves(n))
            assert res["final_summary"] == cold["final_summary"]
            rounds.append((list(cache.computed), list(cache.hits),
                           res["final_summary"], res["levels"],
                           res["hierarchical"]))
        out[pkg] = rounds
    assert out["port"] == out["reference"]
    first, grown = out["port"][0], out["port"][1]
    assert len(first[0]) == 7  # L1 x4, L2 x2, final
    assert [n.split("@")[0] for n in grown[0]] == ["L1.B4", "L2.B1", "L3.final"]
    assert out["port"][3][4] is False  # below the arity: single pass


def test_batch_tree_unchanged_without_cache():
    """With ``stable_tree`` off and no cache the batch pipeline's reduce
    requests stay what they were: the same prompts as the reference's."""
    prompts = {}
    for pkg in ("port", "reference"):
        agg, leaves, _ = _stable(pkg)
        a = agg(stable=False)
        seen = []
        run = a.executor.run_requests
        a.executor.run_requests = lambda reqs, run=run: (
            seen.extend(r.prompt for r in reqs) or run(reqs))
        a.aggregate(leaves(12))
        prompts[pkg] = seen
    assert prompts["port"] == prompts["reference"] and len(prompts["port"]) > 1


def test_live_and_reduce_config_match_reference(monkeypatch):
    from lmrs_tpu.config import LiveConfig as JLive
    from lmrs_tpu.config import PipelineConfig as JPipe
    from lmrs_tpu_torch.config import LiveConfig, PipelineConfig

    names = ("LMRS_LIVE_DIR", "LMRS_LIVE_REFRESH_TOKENS",
             "LMRS_LIVE_CLASS_DEFAULT")
    for env in ({}, dict(zip(names, ("/x/live", "300", "bulk")))):
        for k in names:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert vars(LiveConfig()) == vars(JLive())
    assert PipelineConfig().reduce.stable_tree is JPipe().reduce.stable_tree is False
    for bad in (dict(class_default="warp"), dict(refresh_tokens=-1),
                dict(interactive_deadline_s=0)):
        with pytest.raises(ValueError):
            LiveConfig(**bad)


# ------------------------------------------------------------- sessions


def test_batched_appends_equal_cold_and_reference(tmp_path):
    """Four appends with a refresh after each against a cold session fed
    every segment at once: the same chunks and summary, only dirty chunks
    recomputed, nodes reused; every refresh and status document equal to
    the JAX package's session on the same appends."""
    segs = make_segments(120, seed=3)
    refreshes, status = {}, {}
    for pkg in ("port", "reference"):
        m = manager(pkg, tmp_path / pkg)
        m.create(session_id="inc")
        refreshes[pkg] = [m.append("inc", segs[i:i + 30], refresh=True)
                          for i in range(0, 120, 30)]
        status[pkg] = m.status_doc(m.get("inc"))
        chunks = [c.to_dict() for c in m.get("inc").inc.chunks()]
        m.shutdown()
    assert _strip(refreshes["port"]) == _strip(refreshes["reference"])
    assert _strip(status["port"]) == _strip(status["reference"])
    last = refreshes["port"][-1]["refresh"]
    assert 0 < last["dirty_chunks"] < last["num_chunks"]
    assert last["chunk_summaries_reused"] > 0 and last["reduce_nodes_reused"] > 0
    cold = manager("port", tmp_path / "cold")
    cold.create(session_id="cold")
    doc = cold.append("cold", segs, refresh=True)["refresh"]
    assert doc["summary"] == last["summary"]
    assert [c.to_dict() for c in cold.get("cold").inc.chunks()] == chunks
    cold.shutdown()


def test_refresh_carries_previous_summary_as_draft_hint(tmp_path):
    from lmrs_tpu_torch.engine.mock import MockEngine

    eng = MockEngine(seed=0)
    m = manager("port", tmp_path, engine=eng)
    m.create(session_id="s")
    segs = make_segments(60, seed=9)
    r1 = m.append("s", segs[:30], refresh=True)["refresh"]
    assert eng.draft_hints == []  # nothing to draft from on refresh 1
    n1 = len(eng.draft_hints)
    r2 = m.append("s", segs[30:], refresh=True)["refresh"]
    assert len(eng.draft_hints) > n1
    assert set(eng.draft_hints) == {r1["summary"]}
    n2 = len(eng.draft_hints)
    m.append("s", make_segments(10, seed=4), refresh=True)
    assert set(eng.draft_hints[n2:]) == {r2["summary"]}
    m.shutdown()


def test_journal_rehydration_after_shutdown(tmp_path):
    """A new manager over the directory rebuilds the session from its
    journal: the same status and summary documents, a refresh with nothing
    new recomputes nothing, and an append reuses the clean subtrees.  The
    JAX package's manager rehydrates the port's journal to the same
    documents.  Replaying the journal twice gives the same state."""
    from lmrs_tpu.live import rebuild_live_state as j_rebuild
    from lmrs_tpu_torch.jobs import journal as tj
    from lmrs_tpu_torch.live import rebuild_live_state

    d = tmp_path / "live"
    m1 = manager("port", d)
    m1.create(session_id="s")
    m1.append("s", make_segments(60, seed=1), refresh=True)
    m1.append("s", make_segments(5, seed=2))  # appended, not summarized
    before = (m1.status_doc(m1.get("s")), m1.summary_doc("s"))
    wal = m1.get("s").wal_path
    m1.shutdown()
    records, meta = tj.replay(wal)
    assert not meta["torn"] and not meta["corrupt"]
    assert (tj.canonical_json(rebuild_live_state(records + records))
            == tj.canonical_json(rebuild_live_state(records))
            == tj.canonical_json(j_rebuild(records)))
    docs = {}
    for pkg in ("reference", "port"):  # the port's refreshes journal more
        m = manager(pkg, d)
        assert m.recover() == 1
        docs[pkg] = (m.status_doc(m.get("s")), m.summary_doc("s"))
        if pkg == "port":
            r = m.refresh("s")
            assert r["reduce_nodes_reused"] > 0
            assert r["dirty_chunks"] < r["num_chunks"]
            again = m.refresh("s")
            assert again["dirty_chunks"] == 0
            assert again["reduce_nodes_computed"] == 0
        m.shutdown()
    want = _strip(before)
    want[0]["recovered"] = True
    for doc in (want[0], docs["port"][0], docs["reference"][0]):
        doc.pop("journal")  # this process's appends
    assert _strip(docs["port"]) == want
    assert _strip(docs["reference"]) == _strip(docs["port"])


def test_close_deletes_and_validation(tmp_path):
    m = manager("port", tmp_path)
    with pytest.raises(ValueError):
        m.create({"bogus_knob": 1})
    with pytest.raises(ValueError):
        m.create(session_id="bad/../id")
    m.create(session_id="s")
    for bad in ([{"start": "abc", "end": 5.0, "text": "hi"}],
                [{"start": 9.0, "end": 1.0, "text": "hi"}]):
        with pytest.raises(ValueError):
            m.append("s", bad)
    assert m.get("s").append_seq == 0  # nothing journaled
    m.append("s", make_segments(10, seed=0), refresh=True)
    wal = m.get("s").wal_path
    assert m.close("s") is not None and not wal.exists()
    with pytest.raises(KeyError):
        m.refresh("s")
    assert manager("port", tmp_path).recover() == 0


def test_auto_refresh_threshold_matches_reference(tmp_path):
    segs = make_segments(60, seed=6)
    docs = {}
    for pkg in ("port", "reference"):
        m = manager(pkg, tmp_path / pkg, refresh_tokens=400)
        m.create(session_id="s")
        docs[pkg] = [m.append("s", segs[:2]), m.append("s", segs[2:40]),
                     m.append("s", segs[40:], refresh=False)]
        m.shutdown()
    assert "refresh" not in docs["port"][0]
    assert docs["port"][1]["refresh"]["auto"] is True
    assert _strip(docs["port"]) == _strip(docs["reference"])


def _call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        headers={"Content-Type": "application/json"},
        data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_session_lifecycle_matches_reference(tmp_path):
    """The ``/v1/sessions`` flow on the port's server beside the
    reference's: every status code and document equal (less clocks)."""
    from lmrs_tpu.engine.mock import MockEngine as JMock
    from lmrs_tpu.serving.server import EngineHTTPServer as JServer
    from lmrs_tpu_torch.engine.mock import MockEngine
    from lmrs_tpu_torch.serving.server import EngineHTTPServer

    segs = make_segments(60, seed=5)
    flow = [("POST", "/v1/sessions", {"session_id": "abc",
                                      "params": {"class": "bulk"}}),
            ("POST", "/v1/sessions", {"session_id": "abc"}),
            ("POST", "/v1/sessions/abc/segments",
             {"segments": segs[:30], "refresh": True}),
            ("GET", "/v1/sessions/abc/summary", None),
            ("POST", "/v1/sessions/abc/segments", {"segments": segs[30:]}),
            ("GET", "/v1/sessions/abc/summary?refresh=1", None),
            ("POST", "/v1/sessions/abc/refresh", {"class": "bulk"}),
            ("GET", "/v1/sessions", None),
            ("GET", "/v1/sessions/abc", None),
            ("GET", "/v1/sessions/nope", None),
            ("POST", "/v1/sessions", {"params": {"bogus": 1}}),
            ("POST", "/v1/sessions/abc/segments", {"segments": "no"}),
            ("DELETE", "/v1/sessions/abc", None),
            ("GET", "/v1/sessions/abc", None)]
    out = {}
    for pkg, srv_cls, mock in (("port", EngineHTTPServer, MockEngine),
                               ("reference", JServer, JMock)):
        kw = {} if pkg == "port" else dict(cost_ledger=False, slo=False,
                                           qos=False)
        srv = srv_cls(mock(seed=0, **kw), port=0, batch_window_s=0.01,
                      live_dir=str(tmp_path / pkg),
                      pipeline_config=live_config(pkg))
        srv.start_background()
        try:
            out[pkg] = [_call(srv.port, *step) for step in flow]
            metrics = _call(srv.port, "GET", "/metrics")[1]
            text = urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/metrics",
                headers={"Accept": "text/plain"}), timeout=TIMEOUT).read().decode()
        finally:
            srv.shutdown()
        out[pkg].append(metrics.get("live"))
        out[pkg].append(sorted(ln for ln in text.splitlines()
                               if ln.startswith("lmrs_live_")
                               and "seconds" not in ln))
    assert [s for s, _ in out["port"][:-2]] == [200, 200, 200, 200, 200, 200,
                                                200, 200, 200, 404, 400, 400,
                                                200, 404]
    port, ref = _strip(out["port"]), _strip(out["reference"])
    port[-2]["live_dir"] = ref[-2]["live_dir"]
    # the error texts name each package's server command
    for p, r in zip(port[:-2], ref[:-2]):
        if p[0] >= 400:
            assert p[1]["error"]["type"] == r[1]["error"]["type"]
            p[1]["error"] = r[1]["error"]
    assert port == ref


def test_router_forwards_sessions_and_jobs_sticky(tmp_path):
    """A front server over a ``RouterEngine`` with no managers of its own:
    sessions and jobs go to one backend, stay pinned there, and a fresh
    router finds them again by a fleet scan."""
    import time

    from lmrs_tpu_torch.engine.mock import MockEngine
    from lmrs_tpu_torch.serving.router import RouterEngine
    from lmrs_tpu_torch.serving.server import EngineHTTPServer

    from test_torch_jobs import job_transcript

    cfg = live_config("port")
    backends = [EngineHTTPServer(MockEngine(seed=0), port=0,
                                 batch_window_s=0.01,
                                 live_dir=str(tmp_path / f"l{i}"),
                                 jobs_dir=str(tmp_path / f"j{i}"),
                                 pipeline_config=cfg) for i in range(2)]
    for b in backends:
        b.start_background()
    hosts = [f"127.0.0.1:{b.port}" for b in backends]
    router = RouterEngine(hosts, timeout_s=TIMEOUT)
    front = EngineHTTPServer(router, port=0, batch_window_s=0.01)
    front.start_background()
    segs = make_segments(40, seed=5)
    try:
        p = front.port
        assert _call(p, "POST", "/v1/sessions", {"session_id": "r1"})[0] == 200
        st, doc = _call(p, "POST", "/v1/sessions/r1/segments",
                        {"segments": segs, "refresh": True})
        assert st == 200 and doc["refresh"]["summary"]
        owners = [b for b in backends
                  if _call(b.port, "GET", "/v1/sessions/r1")[0] == 200]
        assert len(owners) == 1
        assert _strip(_call(p, "GET", "/v1/sessions/r1")) == _strip(
            _call(owners[0].port, "GET", "/v1/sessions/r1"))
        st, job = _call(p, "POST", "/v1/jobs", {"transcript": job_transcript()})
        assert st == 200
        deadline = time.time() + TIMEOUT
        while job["status"] not in ("done", "failed") and time.time() < deadline:
            time.sleep(0.05)
            job = _call(p, "GET", f"/v1/jobs/{job['id']}")[1]
        assert job["status"] == "done"
        holders = [b for b in backends
                   if _call(b.port, "GET", f"/v1/jobs/{job['id']}")[0] == 200]
        assert len(holders) == 1
        assert router._job_hosts[job["id"]] == f"127.0.0.1:{holders[0].port}"
        fresh = RouterEngine(hosts, timeout_s=TIMEOUT)
        try:
            st, doc = fresh.session_request("GET", "/v1/sessions/r1/summary",
                                            None)
            assert st == 200 and doc["summary"]
            st, doc = fresh.job_request("GET", f"/v1/jobs/{job['id']}", None)
            assert st == 200 and doc["status"] == "done"
            assert fresh.session_request("GET", "/v1/sessions/zz", None)[0] == 404
        finally:
            fresh.shutdown()
        assert _call(p, "DELETE", "/v1/sessions/r1")[0] == 200
        assert _call(p, "GET", "/v1/sessions/r1")[0] == 404
    finally:
        front.shutdown()
        router.shutdown()
        for b in backends:
            b.shutdown()


# ------------------------------------------- the draft hint on the engine


CFG = dict(vocab_size=259, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
           hidden_dim=160, max_seq_len=128, dtype="float32",
           tie_embeddings=False)
K = 3


def _cycle_params(seed=3):
    """Test-width JAX params whose greedy next byte is the byte after the
    current one (``test_torch_spec_tree._cycle_tree`` at the byte
    tokenizer's vocabulary): a hint that spells the continuation drafts
    it."""
    import jax

    from lmrs_tpu.config import ModelConfig as JModelConfig
    from lmrs_tpu.models.transformer import init_params as j_init_params

    jcfg = JModelConfig(name="cycle", **CFG)
    tree = jax.tree.map(np.array, j_init_params(jcfg, jax.random.PRNGKey(seed)))
    r = np.random.default_rng(seed)
    emb = r.standard_normal(tree["embed"]["weight"].shape).astype(np.float32)
    head = 0.01 * r.standard_normal(tree["lm_head"]["weight"].shape).astype(np.float32)
    ids = np.arange(3, 259)
    head[:, 3 + (ids - 3 + 1) % 256] = 0.1 * emb[ids].T
    tree["embed"]["weight"], tree["lm_head"]["weight"] = emb, head
    tree["layers"]["attn"]["wo"] *= 0.1
    tree["layers"]["mlp"]["w_down"] *= 0.1
    return jcfg, tree


PROMPTS = ["Notes: " * 6 + "".join(chr(65 + 4 * i + j) for j in range(3))
           for i in range(4)]
# each hint spells its prompt's greedy continuation (and more): drafts
HINTS = ["".join(chr(64 + 4 * i + j) for j in range(30)) for i in range(4)]
ENGINE_KW = dict(max_batch_slots=3, page_size=32, num_pages=24,
                 decode_block=4, max_tokens=20, prefill_chunk=4096,
                 speculate_k=K, seed=0)


def _requests(mk, hints):
    return [mk(prompt=p, request_id=i, temperature=0.0,
               max_new_tokens=14 + 2 * i,
               **({"draft_hint": h} if h else {}))
            for i, (p, h) in enumerate(zip(PROMPTS, hints))]


def _port_run(params, tcfg, hints, **kw):
    from lmrs_tpu_torch.config import EngineConfig
    from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
    from lmrs_tpu_torch.engine.api import GenerationRequest
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine

    eng = TorchEngine(EngineConfig(**{**ENGINE_KW, **kw}), tcfg, device="cpu",
                      params=params, tokenizer=ByteTokenizer())
    res = eng.generate_batch(_requests(GenerationRequest, hints))
    assert eng.audit() == []
    assert all(r.error is None for r in res)
    return [r.text for r in res], eng.engine_metrics(), eng


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_draft_hint_leaves_greedy_output_and_matches_reference():
    """Tree speculation with and without a draft hint: the same greedy
    texts, more accepted drafts with it (the hint spells the cycle's
    continuation), the same texts under a pool that preempts (a
    continuation re-seeds its hint), and the JAX package's engine with the
    same hint and weights gives the same texts."""
    import jax
    import jax.numpy as jnp

    from lmrs_tpu.config import EngineConfig as JEngineConfig
    from lmrs_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
    from lmrs_tpu.engine.api import GenerationRequest as JRequest
    from lmrs_tpu.engine.jax_engine import JaxEngine
    from lmrs_tpu_torch.config import ModelConfig as TModelConfig
    from lmrs_tpu_torch.models.convert import params_from_jax

    jcfg, tree = _cycle_params()
    tcfg = TModelConfig(name="cycle", **CFG)
    params = params_from_jax(tree, tcfg)
    plain, m0, _ = _port_run(params, tcfg, [None] * 4)
    hinted, m1, eng = _port_run(params, tcfg, HINTS)
    assert hinted == plain
    assert m0["spec_tree"]["dispatches"] > 0 and m1["spec_tree"]["dispatches"] > 0
    assert m1["spec_accepted_tokens"] > m0["spec_accepted_tokens"]
    assert m1["spec_tree"]["mean_accept_depth"] > m0["spec_tree"]["mean_accept_depth"]
    squeezed, m2, _ = _port_run(params, tcfg, HINTS, num_pages=10,
                                page_size=16)
    assert squeezed == plain and m2["preemptions"] > 0
    jeng = JaxEngine(JEngineConfig(backend="jax", scheduler="continuous",
                                   retry_delay=0.0, **ENGINE_KW),
                     jcfg, params=jax.tree.map(jnp.asarray, tree),
                     tokenizer=JByteTokenizer())
    try:
        ref = [r.text for r in jeng.generate_batch(_requests(JRequest, HINTS))]
        jm = jeng.engine_metrics()
    finally:
        jeng.shutdown()
    assert ref == hinted
    assert jm["spec_tree"]["dispatches"] > 0


def test_seed_history_matches_reference():
    """The history row a slot is seeded with (hint ahead, then prompt and
    generated tokens, clipped to the buffer) and its offset equal the
    reference scheduler's ``seed_history``, re-seeding included."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from lmrs_tpu.engine.scheduler import ContinuousScheduler as JScheduler
    from lmrs_tpu_torch.engine.scheduler import (ContinuousScheduler,
                                                 _SlotState)

    def ns(buf):
        return SimpleNamespace(spec_k=K, _spec_tree=True, B=2, max_len=16,
                               _spec_buf=buf, device=torch.device("cpu"))

    for hint, n_prompt, n_gen in ((list(range(100, 106)), 5, 2),
                                  (list(range(100, 112)), 6, 3),
                                  ([], 7, 1), (list(range(100, 104)), 15, 4)):
        prompt, gen = list(range(3, 3 + n_prompt)), list(range(50, 50 + n_gen))
        t_st = _SlotState(req=None, prompt_ids=prompt, max_new=8, seq=None,
                          generated=list(gen), spec_hint=hint)
        t_ns = ns(None)
        ContinuousScheduler._seed_history(t_ns, 1, t_st)
        j_st = SimpleNamespace(prompt_ids=prompt, generated=list(gen),
                               spec_hint=hint, spec_hoff=0)
        j_ns = ns(jnp.zeros((2, 16), jnp.int32))
        JScheduler.seed_history(j_ns, 1, j_st)
        assert t_st.spec_hoff == j_st.spec_hoff
        assert t_ns._spec_buf[1].tolist() == np.asarray(j_ns._spec_buf[1]).tolist()
        t_st.generated.append(77)  # a re-seed keeps the hint
        j_st.generated.append(77)
        ContinuousScheduler._seed_history(t_ns, 1, t_st)
        JScheduler.seed_history(j_ns, 1, j_st)
        assert t_ns._spec_buf[1].tolist() == np.asarray(j_ns._spec_buf[1]).tolist()


def test_hint_ignored_without_tree_speculation(monkeypatch):
    """Linear speculation and ``speculate_k=0`` take no hint ids."""
    from lmrs_tpu_torch.config import EngineConfig
    from lmrs_tpu_torch.config import ModelConfig as TModelConfig
    from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
    from lmrs_tpu_torch.engine.api import GenerationRequest
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.models.transformer import init_params

    tcfg = TModelConfig(name="t", **CFG)
    params = init_params(tcfg, 0)
    req = GenerationRequest(prompt="abc", draft_hint="abcdef")
    for env, k in (("0", K), ("1", 0)):
        monkeypatch.setenv("LMRS_SPEC_TREE", env)
        eng = TorchEngine(EngineConfig(**{**ENGINE_KW, "speculate_k": k}),
                          tcfg, device="cpu", params=params,
                          tokenizer=ByteTokenizer())
        assert eng._scheduler._hint_ids(req, 4, 8) == []
    monkeypatch.setenv("LMRS_SPEC_TREE", "1")
    eng = TorchEngine(EngineConfig(**ENGINE_KW), tcfg, device="cpu",
                      params=params, tokenizer=ByteTokenizer())
    sched = eng._scheduler
    assert sched._hint_ids(req, 4, 8) == ByteTokenizer().encode("abcdef")
    room = sched.max_len - 100 - 8 - 1 - sched._spec_width * K
    assert len(sched._hint_ids(dataclasses.replace(req, draft_hint="x" * 500),
                               100, 8)) == room
