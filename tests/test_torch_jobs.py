"""Port parity, durable jobs: the port's write-ahead journal and
``JobManager`` against the JAX package's.

* The journal: torn tail, mid-file corruption, duplicates, unknown record
  types, the append/fsync degrade paths (reached by monkeypatching), and
  journals written by either package replaying to the same
  ``rebuild_state`` in the other; the content-addressed keys
  (``canonical_json``, ``chunk_key``, ``node_key``, ``job_id_for``,
  ``content_node_id``) equal across the packages on hypothesis-drawn
  inputs.
* The manager: each package's ``JobManager`` over its own mock on the same
  transcript gives equal status docs and results (less the clock and the
  minted trace id); a job interrupted mid-map or mid-reduce and recovered
  ends token-identical to an uninterrupted one; degraded completion under
  and over the threshold; cancel, then retry on the same journal.
* One SIGKILL: a port server subprocess (this file run as a script) with
  ``--jobs-dir`` over the mock backend, killed mid-job and restarted; the
  job finishes with the uninterrupted run's summary.

Every subprocess and HTTP call carries its own timeout."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

REPO = Path(__file__).resolve().parents[1]
REF_OFF = {"LMRS_COST_LEDGER": "0", "LMRS_SLO": "0", "LMRS_ANATOMY": "0",
           "LMRS_QOS": "0", "LMRS_KV_MIGRATE": "0"}
TIMEOUT = 30.0
# the clock and the minted trace id differ run to run
DROP = {"created_t", "trace_id"}


def job_transcript(n: int = 30, seed: int = 1) -> dict:
    """The reference job tests' synthetic transcript (``_job_worker.py``)."""
    import random

    rng = random.Random(seed)
    words = ("the quarterly review covered the inference engine roadmap "
             "kernel design latency targets hiring plan and budget "
             "allocation for the serving tier").split()
    segs = []
    t = 0.0
    for i in range(n):
        dur = 2.0 + rng.random() * 6.0
        text = " ".join(rng.choice(words) for _ in range(8 + rng.randrange(14)))
        segs.append({"start": round(t, 2), "end": round(t + dur, 2),
                     "text": text.capitalize() + ".",
                     "speaker": f"SPEAKER_{i % 2:02d}"})
        t += dur + rng.random()
    return {"segments": segs}


def pipeline_config(pkg: str, **chunk_kw):
    """The reference job tests' mock surface (small chunks, a reduce budget
    that forms a tree, greedy), built from ``pkg``'s config classes."""
    if pkg == "port":
        from lmrs_tpu_torch import config as c
    else:
        from lmrs_tpu import config as c
    chunk = dict(max_tokens_per_chunk=150, overlap_tokens=0,
                 context_tokens=30, tokenizer="approx")
    chunk.update(chunk_kw)
    return c.PipelineConfig(
        chunk=c.ChunkConfig(**chunk),
        engine=c.EngineConfig(backend="mock", temperature=0.0, seed=0,
                              max_tokens=48, retry_delay=0.0),
        reduce=c.ReduceConfig(max_tokens_per_batch=300, reserve_tokens=50,
                              max_summaries_per_batch=3))


def manager(pkg: str, d, start_worker: bool = False, jobs_config=None,
            config=None, **mock_kw):
    if pkg == "port":
        from lmrs_tpu_torch.engine.mock import MockEngine
        from lmrs_tpu_torch.jobs.manager import JobManager
    else:
        from lmrs_tpu.engine.mock import MockEngine
        from lmrs_tpu.jobs.manager import JobManager
    return JobManager(MockEngine(seed=0, **mock_kw), d,
                      config=config or pipeline_config(pkg),
                      jobs_config=jobs_config, start_worker=start_worker)


@pytest.fixture(autouse=True)
def _reference_surfaces_off(monkeypatch):
    """The reference surfaces the port lacks (ledger, SLO, anatomy, QoS,
    KV migration) off, so both packages' documents compare key for key."""
    for k, v in REF_OFF.items():
        monkeypatch.setenv(k, v)


def _doc(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k not in DROP}


# ----------------------------------------------------------- the journal


def _records():
    return [{"type": "job_header", "job_id": "j1", "fingerprint": "f"},
            {"type": "chunk_done", "chunk_index": 0, "start_time": 0.0,
             "end_time": 1.0, "summary": "s0 ☃", "error": None},
            {"type": "reduce_node_done", "node_id": "L1.B0@x", "key": "k1",
             "text": "node"},
            {"type": "job_done", "status": "done"}]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_replays_the_same_state_in_both_packages(tmp_path, writer):
    """A journal written by either package (the same bytes, line for line)
    replays to the same records, meta and ``rebuild_state`` in both."""
    from lmrs_tpu.jobs import journal as jj
    from lmrs_tpu_torch.jobs import journal as tj

    paths = {}
    for name, mod in (("port", tj), ("reference", jj)):
        j = mod.Journal(tmp_path / f"{name}.wal")
        assert all(j.append(r) for r in _records())
        j.close()
        paths[name] = j.path
    assert paths["port"].read_bytes() == paths["reference"].read_bytes()
    wal = paths[writer]
    (t_recs, t_meta), (j_recs, j_meta) = tj.replay(wal), jj.replay(wal)
    assert t_recs == j_recs == _records()
    assert t_meta == j_meta == {"records": 4, "dropped": 0, "torn": False,
                                "corrupt": False}
    assert (tj.canonical_json(tj.rebuild_state(t_recs))
            == jj.canonical_json(jj.rebuild_state(j_recs)))


def test_journal_torn_tail_and_repair(tmp_path):
    """A partial final line is dropped on replay (``torn``); the next
    append truncates it first, so the new record is not merged into it."""
    from lmrs_tpu.jobs import journal as jj
    from lmrs_tpu_torch.jobs import journal as tj

    p = tmp_path / "t.wal"
    j = tj.Journal(p)
    for r in _records()[:2]:
        j.append(r)
    j.close()
    with open(p, "ab") as fh:
        fh.write(b"deadbeef {\"type\": \"chunk_d")
    for mod in (tj, jj):
        recs, meta = mod.replay(p)
        assert recs == _records()[:2]
        assert meta["torn"] and not meta["corrupt"] and meta["dropped"] == 1
    j2 = tj.Journal(p)
    assert j2.append(_records()[3])
    j2.close()
    recs, meta = jj.replay(p)
    assert recs == [*_records()[:2], _records()[3]] and not meta["torn"]


def test_journal_midfile_corruption_stops_replay(tmp_path):
    from lmrs_tpu.jobs import journal as jj
    from lmrs_tpu_torch.jobs import journal as tj

    p = tmp_path / "c.wal"
    j = tj.Journal(p)
    for r in _records():
        j.append(r)
    j.close()
    lines = p.read_bytes().split(b"\n")
    lines[1] = lines[1][:20] + b"X" + lines[1][21:]  # CRC now fails
    p.write_bytes(b"\n".join(lines))
    for mod in (tj, jj):
        recs, meta = mod.replay(p)
        assert recs == _records()[:1]
        assert meta == {"records": 1, "dropped": 3, "torn": False,
                        "corrupt": True}


def test_journal_duplicates_and_unknown_types_are_idempotent(tmp_path):
    from lmrs_tpu.jobs import journal as jj
    from lmrs_tpu_torch.jobs import journal as tj

    recs = _records() + [{"type": "from_a_newer_build", "x": 1}]
    once = tj.canonical_json(tj.rebuild_state(recs))
    assert tj.canonical_json(tj.rebuild_state(recs + recs)) == once
    assert jj.canonical_json(jj.rebuild_state(recs + recs)) == once
    state = tj.rebuild_state(recs)
    assert set(state) == {"header", "chunks", "nodes", "done"}
    assert state["nodes"] == {"k1": "node"} and list(state["chunks"]) == ["0:0.0:1.0"]


def test_journal_append_and_fsync_failures_degrade(tmp_path, monkeypatch):
    """A failed fsync keeps the record (not durable) and a failed write
    drops it; both mark the journal degraded and never raise."""
    from lmrs_tpu_torch.jobs import journal as tj

    j = tj.Journal(tmp_path / "d.wal")
    assert j.append(_records()[0])

    def bad_fsync(fd):
        raise OSError("fsync refused (test)")

    monkeypatch.setattr(tj.os, "fsync", bad_fsync)
    assert j.append(_records()[1]) is False
    monkeypatch.undo()
    real_open = open

    def bad_open(path, mode="r", *a, **kw):
        if str(path).endswith("e.wal"):
            raise OSError("volume gone (test)")
        return real_open(path, mode, *a, **kw)

    monkeypatch.setattr("builtins.open", bad_open)
    k = tj.Journal(tmp_path / "e.wal")
    assert k.append(_records()[0]) is False
    monkeypatch.undo()
    assert j.stats() == {"appends": 2, "append_failures": 0,
                         "fsync_failures": 1, "degraded": True}
    assert k.stats() == {"appends": 0, "append_failures": 1,
                         "fsync_failures": 0, "degraded": True}
    j.close()
    assert [r["type"] for r in tj.replay(j.path)[0]] == ["job_header",
                                                         "chunk_done"]


_JSON = st.recursive(
    st.none() | st.booleans() | st.integers()
    | st.floats(allow_nan=False, allow_infinity=False) | st.text(),
    lambda kids: st.lists(kids, max_size=4)
    | st.dictionaries(st.text(), kids, max_size=4),
    max_leaves=12)


def test_content_keys_match_reference():
    """The content-addressed keys are the reference's on drawn inputs."""
    from lmrs_tpu.jobs import journal as jj
    from lmrs_tpu.reduce.aggregator import content_node_id as j_node_id
    from lmrs_tpu_torch.jobs import journal as tj
    from lmrs_tpu_torch.reduce.aggregator import content_node_id as t_node_id

    finite = st.floats(allow_nan=False, allow_infinity=False,
                       min_value=-1e9, max_value=1e9)
    meta = st.none() | st.dictionaries(st.text(), st.text() | st.integers(),
                                       max_size=3)

    @settings(max_examples=60, deadline=None)
    @given(obj=_JSON, idx=st.integers(-5, 10**6), a=finite, b=finite,
           summaries=st.lists(st.text(), max_size=4),
           template=st.none() | st.text(), metadata=meta, fp=st.text(),
           segs=st.lists(st.dictionaries(st.text(), _JSON, max_size=3),
                         max_size=3))
    def check(obj, idx, a, b, summaries, template, metadata, fp, segs):
        assert tj.canonical_json(obj) == jj.canonical_json(obj)
        assert tj.chunk_key(idx, a, b) == jj.chunk_key(idx, a, b)
        assert (tj.node_key(summaries, template, metadata)
                == jj.node_key(summaries, template, metadata))
        doc = {"segments": segs}
        assert tj.job_id_for(doc, fp) == jj.job_id_for(doc, fp)
        assert (t_node_id("L1.B0", summaries, template, metadata)
                == j_node_id("L1.B0", summaries, template, metadata))
        assert (tj.config_fingerprint(x=obj, fp=fp)
                == jj.config_fingerprint(x=obj, fp=fp))

    check()


# ----------------------------------------------------------- the manager


@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    """One uninterrupted job per package on the same transcript: their
    status docs, results and the port's journal lines."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_OFF.items():
            mp.setenv(k, v)
        for pkg in ("port", "reference"):
            d = tmp_path_factory.mktemp(f"jobs_{pkg}")
            jm = manager(pkg, d)
            job = jm.submit(job_transcript())
            jm.run_job(job)
            out[pkg] = {"dir": d, "jid": job.job_id,
                        "doc": jm.status_doc(job),
                        "lines": job.wal_path.read_bytes().split(b"\n")[:-1]}
            jm.shutdown()
    return out


def test_job_status_docs_and_results_match_reference(baselines):
    port, ref = baselines["port"], baselines["reference"]
    assert port["jid"] == ref["jid"]
    doc = port["doc"]
    assert doc["status"] == "done"
    assert doc["progress"]["num_chunks"] >= 5
    assert doc["progress"]["reduce_nodes_done"] >= 3  # a real tree
    assert doc["result"]["hierarchical"]
    assert _doc(doc) == _doc(ref["doc"])


def _by_type(lines):
    out: dict[str, list[bytes]] = {}
    for raw in lines:
        out.setdefault(json.loads(raw[9:])["type"], []).append(raw)
    return out


def _interrupted(baseline, tmp_path, n_chunks, n_nodes=0):
    """A jobs dir as a crash leaves it: the request file plus the header,
    the first ``n_chunks`` chunk records and ``n_nodes`` node records."""
    by = _by_type(baseline["lines"])
    keep = (by["job_header"] + by["chunk_done"][:n_chunks]
            + by["reduce_node_done"][:n_nodes])
    d = tmp_path / "resume"
    d.mkdir()
    jid = baseline["jid"]
    (d / f"{jid}.req.json").write_bytes(
        (baseline["dir"] / f"{jid}.req.json").read_bytes())
    (d / f"{jid}.wal").write_bytes(b"\n".join(keep) + b"\n")
    return d


@pytest.mark.parametrize("where", ["mid-map", "mid-reduce"])
def test_recovered_job_is_token_identical(baselines, tmp_path, where):
    """A job interrupted mid-map (3 chunks journaled) or mid-reduce (every
    chunk and 3 nodes) recovers, reuses exactly the journaled work, and
    ends on the uninterrupted job's summary; the JAX package's manager
    recovering the same directory gives the same status doc."""
    base = baselines["port"]
    n_chunks = base["doc"]["progress"]["num_chunks"]
    n_nodes = base["doc"]["progress"]["reduce_nodes_done"]
    if where == "mid-map":
        plan = dict(n_chunks=3)
    else:
        plan = dict(n_chunks=n_chunks, n_nodes=3)
    docs = {}
    for pkg in ("port", "reference"):
        (tmp_path / pkg).mkdir()
        jm = manager(pkg, _interrupted(base, tmp_path / pkg, **plan))
        assert jm.recover() == 1
        job = jm.get(base["jid"])
        assert job.status == "queued" and job.recovered
        jm.run_job(job)
        docs[pkg] = jm.status_doc(job)
        jm.shutdown()
    doc = docs["port"]
    assert doc["status"] == "done"
    assert doc["result"]["summary"] == base["doc"]["result"]["summary"]
    if where == "mid-map":
        assert doc["progress"]["num_resumed_chunks"] == 3
        assert doc["result"]["total_requests"] == (
            base["doc"]["result"]["total_requests"] - 3)
    else:
        assert doc["progress"]["reduce_nodes_reused"] == 3
        assert doc["result"]["total_requests"] == n_nodes - 3
    assert _doc(doc) == _doc(docs["reference"])


def test_duplicate_submit_converges_and_fingerprint_gate(tmp_path):
    """A duplicate submit returns the same job; a restart under another
    chunking surface sets the stale journal aside and recomputes."""
    jm = manager("port", tmp_path)
    t = job_transcript()
    a = jm.submit(t)
    assert jm.submit(t) is a
    jm.run_job(a)
    jm.shutdown()
    wal = a.wal_path
    # drop the terminal record: the journal looks interrupted
    lines = [ln for ln in wal.read_bytes().split(b"\n")[:-1]
             if json.loads(ln[9:])["type"] != "job_done"]
    wal.write_bytes(b"\n".join(lines) + b"\n")
    jm2 = manager("port", tmp_path,
                  config=pipeline_config("port", max_tokens_per_chunk=100))
    assert jm2.recover() == 1
    job = jm2.get(a.job_id)
    jm2.run_job(job)
    assert job.status == "done" and job.resumed_chunks == 0
    assert Path(str(wal) + ".stale").exists()
    jm2.shutdown()


def _marked_transcript() -> dict:
    t = job_transcript()
    t["segments"][2]["text"] = "This segment says XXFAILXX loudly."
    return t


@pytest.mark.parametrize("fraction,want", [(0.34, "degraded"), (0.0, "failed")])
def test_degraded_completion_threshold(tmp_path, fraction, want):
    """One failed chunk of several: under the threshold the job finishes
    degraded with its reason, over it failed; both packages agree."""
    from lmrs_tpu.config import JobsConfig as JJobs
    from lmrs_tpu_torch.config import JobsConfig

    docs = {}
    for pkg, cls in (("port", JobsConfig), ("reference", JJobs)):
        jm = manager(pkg, tmp_path / pkg, jobs_config=cls(
            max_failed_chunk_fraction=fraction),
            config=pipeline_config(pkg, context_tokens=0),
            fail_pattern="XXFAILXX")
        job = jm.submit(_marked_transcript())
        jm.run_job(job)
        docs[pkg] = jm.status_doc(job)
        jm.shutdown()
    doc = docs["port"]
    assert doc["status"] == want
    assert doc["progress"]["chunks_failed"] == 1
    assert len(doc["degraded_reasons"]) == 1
    assert doc["result"]["summary"]
    assert _doc(doc) == _doc(docs["reference"])
    # the terminal state survives a restart
    jm2 = manager("port", tmp_path / "port")
    assert jm2.recover() == 0
    assert jm2.get(doc["id"]).status == want
    jm2.shutdown()


def test_cancel_running_job_then_retry(tmp_path):
    """A running job cancels (journaled terminal); a resubmit retries on
    the same journal, reusing what the cancelled run journaled."""
    from lmrs_tpu_torch.jobs import journal as tj

    t = job_transcript()
    jm = manager("port", tmp_path, start_worker=True, latency_s=0.1)
    job = jm.submit(t)
    deadline = time.time() + TIMEOUT
    while job.status != "running" and time.time() < deadline:
        time.sleep(0.01)
    assert job.status == "running"
    jm.cancel(job.job_id)
    assert job.done_ev.wait(TIMEOUT)
    assert job.status == "cancelled"
    assert tj.rebuild_state(tj.replay(job.wal_path)[0])["done"]["status"] \
        == "cancelled"
    jm.shutdown()
    jm2 = manager("port", tmp_path)
    assert jm2.recover() == 0  # cancelled is terminal at start-up
    retry = jm2.submit(t)
    assert retry.status == "queued"
    jm2.run_job(retry)
    assert retry.status == "done" and retry.result["summary"]
    jm2.shutdown()


def test_graceful_shutdown_withholds_shutdown_induced_terminal(tmp_path):
    """A job that fails while the manager shuts down journals no terminal
    record, so the restart resumes it."""
    from lmrs_tpu_torch.jobs import journal as tj

    jm = manager("port", tmp_path)
    job = jm.submit(job_transcript())
    jm._stopped = True  # the shutdown flag, as shutdown() sets it
    jm._finish(job, "failed", None, [], error="server shutting down")
    assert tj.rebuild_state(tj.replay(job.wal_path)[0])["done"] is None
    jm.shutdown()
    jm2 = manager("port", tmp_path)
    assert jm2.recover() == 1
    jm2.run_job(jm2.get(job.job_id))
    assert jm2.get(job.job_id).status == "done"
    jm2.shutdown()


def test_jobs_config_matches_reference(monkeypatch):
    from lmrs_tpu.config import JobsConfig as JJobs
    from lmrs_tpu_torch.config import JobsConfig

    for env in ({}, {"LMRS_JOBS_DIR": "/x/jobs",
                     "LMRS_JOBS_DEGRADED_FRACTION": "0.5"}):
        for k in ("LMRS_JOBS_DIR", "LMRS_JOBS_DEGRADED_FRACTION"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert vars(JobsConfig()) == vars(JJobs())
    with pytest.raises(ValueError, match="max_failed_chunk_fraction"):
        JobsConfig(max_failed_chunk_fraction=1.5)


def test_histogram_exposition_matches_reference():
    """The managers' histograms render the reference's Prometheus text."""
    from lmrs_tpu.obs import metrics as jm
    from lmrs_tpu_torch.obs import metrics as tm

    pages = []
    for mod in (tm, jm):
        reg = mod.MetricsRegistry()
        for name, buckets in (("lmrs_x_seconds", mod.DEFAULT_LATENCY_BUCKETS_S),
                              ("lmrs_x_ratio", mod.RATIO_BUCKETS)):
            h = reg.histogram(name, buckets, help="h\nx", unit="u")
            for v in (0.0, 0.0004, 0.1, 0.55, 1.0, 7.5, 250.0):
                h.observe(v)
        reg.counter("lmrs_x_total", "c").inc(3)
        pages.append(reg.render_prometheus(labels={"host": "a"}))
    assert pages[0] == pages[1]
    assert tm.DEFAULT_LATENCY_BUCKETS_S == jm.DEFAULT_LATENCY_BUCKETS_S
    assert tm.RATIO_BUCKETS == jm.RATIO_BUCKETS


# ------------------------------------------------- the server, SIGKILLed


def _http(method, url, body=None):
    req = urllib.request.Request(
        url, method=method, headers={"Content-Type": "application/json"},
        data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(port, jobs_dir, stall):
    """Child: this file as a script runs ``lmrs-serve-torch --backend mock
    --jobs-dir`` with each chunk record's append delayed by ``stall``
    seconds (a wide kill window between records)."""
    return subprocess.Popen(
        [sys.executable, __file__, str(port), str(jobs_dir), str(stall)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def _wait_up(proc, base):
    deadline = time.time() + TIMEOUT
    while time.time() < deadline:
        assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
        try:
            if _http("GET", base + "/healthz")[0] == 200:
                return
        except OSError:
            time.sleep(0.1)
    raise AssertionError("no /healthz")


def test_job_survives_server_sigkill(tmp_path):
    from conftest import free_port

    from lmrs_tpu_torch.jobs import journal as tj

    d = tmp_path / "jobs"
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    # the served surface's chunking (200-token overlap, 150-token context)
    # over a longer transcript: several chunks
    body = {"transcript": job_transcript(n=120),
            "params": {"max_tokens_per_chunk": 400}}
    proc = _serve(port, d, 0.3)
    try:
        _wait_up(proc, base)
        status, doc = _http("POST", base + "/v1/jobs", body)
        assert status == 200, doc
        jid = doc["id"]
        wal = d / f"{jid}.wal"
        deadline = time.time() + TIMEOUT
        while time.time() < deadline:
            recs = tj.replay(wal)[0]
            if sum(r["type"] == "chunk_done" for r in recs) >= 2:
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
    state = tj.rebuild_state(tj.replay(wal)[0])
    journaled = len(state["chunks"])
    assert journaled >= 2 and state["done"] is None
    proc = _serve(port, d, 0.0)
    try:
        _wait_up(proc, base)
        deadline = time.time() + TIMEOUT
        while time.time() < deadline:
            doc = _http("GET", f"{base}/v1/jobs/{jid}")[1]
            if doc["status"] in ("done", "failed"):
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
    assert doc["status"] == "done" and doc["recovered"]
    assert doc["progress"]["num_resumed_chunks"] == journaled
    # the uninterrupted job on the same surface
    from lmrs_tpu_torch.config import EngineConfig, PipelineConfig
    from lmrs_tpu_torch.engine.api import make_engine
    from lmrs_tpu_torch.jobs.manager import JobManager

    cfg = PipelineConfig(engine=EngineConfig(backend="mock", max_tokens=4096))
    jm = JobManager(make_engine(cfg.engine), tmp_path / "clean", config=cfg,
                    start_worker=False)
    clean = jm.submit(body["transcript"], body["params"])
    assert clean.job_id == jid
    jm.run_job(clean)
    jm.shutdown()
    assert doc["result"]["summary"] == clean.result["summary"]
    assert doc["result"]["total_requests"] < clean.result["total_requests"]


if __name__ == "__main__":
    # the SIGKILL test's server: python tests/test_torch_jobs.py PORT DIR STALL
    port, jobs_dir, stall = sys.argv[1], sys.argv[2], float(sys.argv[3])
    from lmrs_tpu_torch.jobs import journal as tj
    from lmrs_tpu_torch.serving import cli

    if stall > 0:
        plain_append = tj.Journal.append

        def paced_append(self, rec):
            if rec.get("type") == "chunk_done":
                time.sleep(stall)
            return plain_append(self, rec)

        tj.Journal.append = paced_append
    sys.exit(cli.main(["--backend", "mock", "--port", port,
                       "--jobs-dir", jobs_dir, "-q"]))
