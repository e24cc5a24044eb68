"""Port parity, observability (measurement half): the port's ``obs``
modules against the JAX package's, and the scheduler's tracer, ledger,
anatomy, attribution and SLO feeds against the reference scheduler's.

* Module level, with injected clocks: the same call sequences, drawn with
  numpy from a seed, go into both packages' ``Tracer`` (payload and
  validation), ``CostLedger`` (``note_step`` / ``finish`` /
  ``usage_report``, seconds to 1e-9, tokens exact), ``SLOEngine`` (states
  and burns), ``StepAnatomy`` (report, audit identity), ``stitch_traces``,
  ``merge_usage``, ``merge_anatomy`` and the flight recorder's files.
* The roofline model: ``chip_spec()`` on stubbed card names, and the byte
  and FLOP counts against the reference's at every shared preset.
* Engine level, the tiny model at f32 on the CPU beside one reference
  ``JaxEngine`` on the same weights: every request's event-name chain, the
  ledger's tokens, the pre-existing ``metrics_report`` keys, the ``slo``,
  ``anatomy`` and ``cost`` block keys, the audits after a dispatch fault,
  and the deadline-storm postmortem."""

from __future__ import annotations

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from lmrs_tpu.obs import anatomy as j_anatomy
from lmrs_tpu.obs import flight as j_flight
from lmrs_tpu.obs import ledger as j_ledger
from lmrs_tpu.obs import metrics as j_metrics
from lmrs_tpu.obs import slo as j_slo
from lmrs_tpu.obs import trace as j_trace
from lmrs_tpu_torch.obs import anatomy as t_anatomy
from lmrs_tpu_torch.obs import flight as t_flight
from lmrs_tpu_torch.obs import ledger as t_ledger
from lmrs_tpu_torch.obs import metrics as t_metrics
from lmrs_tpu_torch.obs import slo as t_slo
from lmrs_tpu_torch.obs import trace as t_trace

PKGS = {"ref": SimpleNamespace(trace=j_trace, ledger=j_ledger, slo=j_slo,
                               anatomy=j_anatomy, flight=j_flight,
                               metrics=j_metrics),
        "port": SimpleNamespace(trace=t_trace, ledger=t_ledger, slo=t_slo,
                                anatomy=t_anatomy, flight=t_flight,
                                metrics=t_metrics)}
# the tiny model of tests/test_torch_engine.py
CFG = dict(vocab_size=300, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
           hidden_dim=160, max_seq_len=128, dtype="float32",
           tie_embeddings=False)


class StepClock:
    """A deterministic clock: each call advances by a seeded draw."""

    def __init__(self, seed: int, t0: float = 1000.0):
        self.rng = np.random.default_rng(seed)
        self.t = t0

    def __call__(self) -> float:
        self.t += float(self.rng.uniform(1e-4, 5e-3))
        return self.t


class ManualClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def close(a, b, tol=1e-9):
    """Recursive equality, floats to ``tol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (a, b)
        for k in a:
            close(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            close(x, y, tol)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=tol, rel=tol), (a, b)
    else:
        assert a == b, (a, b)


# ------------------------------------------------------------ the tracer

def drive_tracer(mod) -> dict:
    tr = mod.Tracer(capacity=64)
    rng = np.random.default_rng(3)
    t = 100.0
    for i in range(90):  # past the capacity: oldest-first drops
        t += float(rng.uniform(0.001, 0.01))
        key = f"trace-{i % 5}" if i % 2 else i % 7
        tid = tr.track_for(key)
        if i % 3:
            tr.instant("decode_block", ts=t, tid=tid,
                       args={"tokens": int(rng.integers(1, 9))})
        else:
            tr.complete("prefill", t, t + 0.002, tid=tid,
                        args={"prompt_tokens": int(rng.integers(1, 99))})
    tr.name_track(mod.PID_PIPELINE, 1, "reduce stream")
    doc = tr.payload(host="h:1")
    doc.pop("clock_s")
    return {"doc": doc, "recorded": tr.recorded,
            "ts": tr.timestamps("decode_block")}


def test_tracer_payload_matches_reference():
    ref, port = drive_tracer(j_trace), drive_tracer(t_trace)
    assert port == ref
    assert port["recorded"] == 90
    t_trace.validate_trace_events(port["doc"]["traceEvents"])


@pytest.mark.parametrize("bad", [
    {"ph": "i"},                                      # no name
    {"name": "x", "ph": "Q", "ts": 0, "pid": 1, "tid": 0},
    {"name": "x", "ph": "X", "ts": 0, "pid": 1, "tid": 0},   # no dur
    {"name": "x", "ph": "M", "ts": 0, "pid": 1, "tid": 0},   # no args.name
    {"name": "job_done", "ph": "i", "ts": 0, "pid": 1, "tid": 0,
     "args": {"job": "j"}},                           # contract arg missing
    {"name": "decode_block", "ph": "X", "ts": 0, "dur": 1, "pid": 1,
     "tid": 0, "args": {"hbm_gb": float("nan")}},
])
def test_trace_validation_refuses_what_the_reference_refuses(bad):
    for mod in (j_trace, t_trace):
        with pytest.raises(ValueError):
            mod.validate_trace_events([bad])


def test_trace_export_and_file_validation(tmp_path):
    for name, mod in (("ref", j_trace), ("port", t_trace)):
        assert mod.export_current(tmp_path / "x.json") == (
            None, "tracing was not enabled")
        mod.enable_tracing()
        try:
            mod.get_tracer().instant("enqueue", tid=mod.req_tid(0),
                                     args={"prompt_tokens": 3})
            n, err = mod.export_current(tmp_path / f"{name}.json")
        finally:
            mod.disable_tracing()
        assert err is None and n == 5  # 4 metadata rows + the event
    assert (t_trace.validate_trace_file(tmp_path / "port.json")
            == j_trace.validate_trace_file(tmp_path / "port.json"))
    untimed = lambda e: {k: v for k, v in e.items() if k != "ts"}  # noqa: E731
    assert (untimed(t_trace.validate_trace_file(tmp_path / "ref.json")[-1])
            == untimed(j_trace.validate_trace_file(tmp_path / "port.json")[-1]))


def stitch_pages(mod) -> list:
    def page(events):
        tr = mod.Tracer()
        tid = tr.track_for("tr-1")
        other = tr.track_for("tr-2")
        for name, ts, args in events:
            tr.instant(name, ts=ts, tid=tid, args=args)
        tr.instant("enqueue", ts=900.0, tid=other, args={"prompt_tokens": 1})
        d = tr.payload()
        d["clock_s"] = 0.0
        return d

    t0, skew = 1000.0, -10.0
    return [("pre:1", page([
                ("enqueue", t0, {"prompt_tokens": 8}),
                ("handoff_export", t0 + 1.0, {"pages": 2, "kv_len": 8}),
                ("handoff_release", t0 + 3.0, {"pages": 2,
                                               "orphaned": False})])),
            ("dec:1", page([
                ("handoff_import", t0 + 2.0 + skew, {"pages": 2, "kv_len": 8}),
                ("finish", t0 + 4.0 + skew, {"reason": "stop"})]))]


def test_stitch_traces_matches_reference():
    ref = j_trace.stitch_traces(stitch_pages(j_trace))
    port = t_trace.stitch_traces(stitch_pages(t_trace))
    assert port == ref
    assert port["stitch"]["offsets_ms"]["dec:1"] > 0
    assert (t_trace.stitched_chains(port["traceEvents"])
            == j_trace.stitched_chains(ref["traceEvents"]))


# ------------------------------------------------------------ the ledger

def drive_ledger(mod, seed: int = 5):
    rng = np.random.default_rng(seed)
    clock = ManualClock(50.0)
    reg = mod.metrics.MetricsRegistry()
    led = mod.ledger.CostLedger(reg, enabled=True, clock=clock)
    reqs = [SimpleNamespace(request_id=i, tenant=(None if i % 3 == 0
                                                  else f"t{i % 3}"))
            for i in range(12)]
    usages = []
    live = list(reqs)
    while live:
        clock.t += float(rng.uniform(0.01, 0.1))
        k = int(rng.integers(1, min(5, len(live)) + 1))
        rows = [live[int(j)] for j in rng.choice(len(live), k, replace=False)]
        op = int(rng.integers(0, 4))
        if op == 0:
            led.note_queue_wait(rows[0], float(rng.uniform(0, 0.3)))
            led.note_saved(rows[0], prefix_tokens=int(rng.integers(0, 40)),
                           prefetched_tokens=int(rng.integers(0, 20)),
                           spec_tokens=int(rng.integers(0, 5)),
                           prefetched_bytes=float(rng.integers(0, 4096)))
        elif op in (1, 2):
            half = max(1, len(rows) // 2)
            dec = [(r, int(rng.integers(0, 8)), int(rng.integers(1, 9)))
                   for r in rows[:half]]
            pre = [(r, int(rng.integers(1, 300)),
                    float(rng.uniform(1e6, 1e9))) for r in rows[half:]]
            led.note_step(float(rng.uniform(1e-3, 0.05)), decode_rows=dec,
                          prefill_rows=pre,
                          decode_cost_s=float(rng.uniform(0, 1e-2)),
                          prefill_cost_s=float(rng.uniform(0, 1e-2)))
        else:
            r = rows[0]
            live.remove(r)
            reason = ["stop", "length", "deadline", "cancelled"][
                int(rng.integers(0, 4))]
            res = SimpleNamespace(request_id=r.request_id,
                                  prompt_tokens=int(rng.integers(1, 500)),
                                  completion_tokens=int(rng.integers(0, 64)),
                                  finish_reason=reason, error=None)
            usages.append(led.finish(r, res))
    return led, usages


def test_cost_ledger_matches_reference():
    j_led, j_use = drive_ledger(PKGS["ref"])
    t_led, t_use = drive_ledger(PKGS["port"])
    close(t_use, j_use)
    close(t_led.usage_report(), j_led.usage_report())
    close(t_led.report(), j_led.report())
    assert t_led.audit() == j_led.audit() == []
    tot = t_led.usage_report()["totals"]
    assert tot["prompt_tokens"] == sum(u["prompt_tokens"] for u in t_use)
    assert tot["requests"] == 12
    # the ledger's kill switch: no usage, an inert report
    off = t_ledger.CostLedger(enabled=False)
    assert off.finish(SimpleNamespace(request_id=0), None) is None
    assert off.report() == {"enabled": False} and off.audit() == []


def test_merge_usage_and_tenant_totals_match_reference():
    _, use = drive_ledger(PKGS["port"], seed=9)
    j_into, t_into = {}, {}
    for u in use:
        j_ledger.merge_usage(j_into, u)
        t_ledger.merge_usage(t_into, u)
    close(t_into, j_into)
    tenants = {"a": dict(t_into), "b": dict(use[0], requests=1)}
    close(t_ledger.totals_from_tenants(tenants),
          j_ledger.totals_from_tenants(tenants))


# --------------------------------------------------------------- the SLO

def drive_slo(mod) -> list:
    rng = np.random.default_rng(11)
    clock = ManualClock(0.0)
    eng = mod.slo.SLOEngine(
        mod.metrics.MetricsRegistry(), fast_s=10.0, slow_s=60.0, hold_s=5.0,
        clock=clock, enabled=True,
        specs=(mod.slo.SLOSpec("ttft_p95_ms", "latency_p95", 200.0),
               mod.slo.SLOSpec("block_gap_p95_ms", "latency_p95", 100.0),
               mod.slo.SLOSpec("deadline_miss_rate", "rate", 0.1),
               mod.slo.SLOSpec("error_rate", "rate", 0.1),
               mod.slo.SLOSpec("goodput_tok_s", "throughput_min", 5.0)))
    docs = []
    for step in range(160):
        clock.t += 0.5
        bad = 60 <= step < 100  # a degraded stretch, then recovery
        eng.observe_ttft(float(rng.uniform(0.05, 0.15)) * (4 if bad else 1))
        eng.observe_gap(float(rng.uniform(0.02, 0.08)) * (3 if bad else 1))
        reason = ("deadline" if bad and rng.random() < 0.5 else "stop")
        eng.note_result(reason, int(rng.integers(1, 40)))
        if step % 10 == 9:
            docs.append(eng.report())
    return docs


def test_slo_engine_matches_reference():
    j_docs, t_docs = drive_slo(PKGS["ref"]), drive_slo(PKGS["port"])
    close(t_docs, j_docs)
    states = [d["state"] for d in t_docs]
    assert "critical" in states and states[-1] == "ok"
    assert t_slo.worst_state(["ok", "warn"]) == "warn"
    assert t_slo.state_rank("critical") == j_slo.state_rank("critical")


def test_slo_specs_from_env_match_reference(monkeypatch):
    monkeypatch.setenv("LMRS_SLO_SPEC",
                       json.dumps({"ttft_p95_ms": 150, "nope": 1,
                                   "goodput_tok_s": "x"}))
    assert ([tuple(vars(s).values()) for s in t_slo.specs_from_env()]
            == [tuple(vars(s).values()) for s in j_slo.specs_from_env()])


# ----------------------------------------------------------- the anatomy

def drive_anatomy(mod):
    reg = mod.metrics.MetricsRegistry()
    an = mod.anatomy.StepAnatomy(reg, clock=StepClock(21))
    rng = np.random.default_rng(22)
    snap = None
    for i in range(40):
        an.iter_begin()
        with an.seg("admit"):
            pass
        if i % 7 == 3:
            an.iter_discard() if i % 2 else an.iter_abort()
            continue
        with an.seg("plan"):
            with an.seg("dispatch"):
                pass
            if rng.random() < 0.5:
                with an.seg("draft"):
                    pass
        with an.seg("fetch"):
            pass
        with an.seg("finish"):
            with an.seg("io"):
                pass
        tpb = int(2 ** rng.integers(4, 8))
        an.note_bucket(tpb, 8, int(rng.integers(1, tpb + 1)))
        an.iter_end(mod.anatomy.CLASSES[i % 4])
        if i == 19:
            snap = an.snapshot()
    return an, snap


def test_step_anatomy_matches_reference():
    (j_an, j_snap), (t_an, t_snap) = (drive_anatomy(PKGS["ref"]),
                                      drive_anatomy(PKGS["port"]))
    close(t_snap, j_snap)
    for before in (None, t_snap):
        close(t_an.report(before, rtt=(0.001, 1.0)),
              j_an.report(before, rtt=(0.001, 1.0)))
    assert t_an.audit() == j_an.audit() == []
    rep = t_an.report()
    assert rep["aborted_iterations"] == 3 and rep["iterations"] == 34
    assert rep["wall_ms"] == pytest.approx(
        sum(rep["segments_ms"].values()) + rep["residual_ms"], abs=1e-2)
    docs = [t_an.report(), t_an.report(t_snap)]
    close(t_anatomy.merge_anatomy(docs), j_anatomy.merge_anatomy(docs))
    assert t_anatomy.NULL_ANATOMY.report() == j_anatomy.NULL_ANATOMY.report()


# ------------------------------------------------------ the flight recorder

def test_postmortems_validate_across_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("LMRS_POSTMORTEM_MIN_S", "0")
    paths = {}
    for name, mod in (("ref", PKGS["ref"]), ("port", PKGS["port"])):
        mod.trace.enable_tracing()
        try:
            mod.trace.get_tracer().complete("decode_block", 1.0, 1.5,
                                            args={"hbm_gb": 0.5})
            paths[name] = mod.flight.dump_postmortem(
                "deadline_storm", metrics={"decode_tokens": 3},
                extra={"expired_this_sweep": 4}, out_dir=tmp_path / name)
        finally:
            mod.trace.disable_tracing()
    for p in paths.values():
        j_doc = j_flight.validate_postmortem_file(p)
        t_doc = t_flight.validate_postmortem_file(p)
        assert j_doc == t_doc and t_doc["spans"][0]["name"] == "decode_block"
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "lmrs-postmortem-v1", "reason": ""}))
    for mod in (j_flight, t_flight):
        with pytest.raises(ValueError):
            mod.validate_postmortem_file(bad)
    assert t_flight.postmortem_dir() is None  # unarmed: dumps are no-ops
    assert t_flight.dump_postmortem("x") is None


# ------------------------------------------------------ the roofline model

@pytest.mark.parametrize("name,flops,bw,known", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12, True),
    ("NVIDIA H100 SXM5 80GB", 989e12, 3.35e12, True),
    ("NVIDIA H100 PCIe", 756e12, 2.0e12, True),
    ("NVIDIA H100 NVL", 835e12, 3.9e12, True),
    ("NVIDIA A100-SXM4-80GB", 989e12, 3.35e12, False),
    ("cpu", 989e12, 3.35e12, False)])
def test_chip_spec_peaks(monkeypatch, name, flops, bw, known):
    import torch

    from lmrs_tpu_torch.utils import perf_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: name)
    for spec in (perf_model.chip_spec(), perf_model.chip_spec(name)):
        assert (spec.kind, spec.peak_flops, spec.peak_hbm_bw,
                spec.known) == (name, flops, bw, known)


def test_roofline_counts_match_reference():
    from lmrs_tpu.config import model_preset as j_preset
    from lmrs_tpu.utils import perf_model as jp
    from lmrs_tpu_torch.config import model_preset as t_preset
    from lmrs_tpu_torch.utils import perf_model as tp

    for name in ("tiny", "bench-8b", "gemma-2b", "gemma-7b", "mixtral-8x7b"):
        jc, tc = j_preset(name), t_preset(name)
        for q in (False, True):
            assert tp.weight_bytes(tc, q) == jp.weight_bytes(jc, q)
            assert (tp.decode_step_bytes(tc, 1500, q, q)
                    == jp.decode_step_bytes(jc, 1500, q, q))
        assert tp.kv_bytes_per_token(tc) == jp.kv_bytes_per_token(jc)
        assert (tp.prefill_flops(tc, 700, head_tokens=1, kv_start=300)
                == jp.prefill_flops(jc, 700, head_tokens=1, kv_start=300))


def test_dispatch_attribution_counts_and_samples():
    """The port's attribution counts the reference's bytes and FLOPs, and
    its samples are model time over (wall - rtt) against the card's
    peaks (a CPU engine prices as the unknown card)."""
    import torch

    from lmrs_tpu.config import model_preset as j_preset
    from lmrs_tpu.obs.perf import DispatchAttribution as JAttr
    from lmrs_tpu_torch.config import EngineConfig
    from lmrs_tpu_torch.config import model_preset as t_preset
    from lmrs_tpu_torch.obs.perf import DispatchAttribution as TAttr

    ecfg = EngineConfig()
    j = JAttr(j_preset("bench-8b"), ecfg, j_metrics.MetricsRegistry())
    t = TAttr(t_preset("bench-8b"), ecfg, t_metrics.MetricsRegistry(),
              device=torch.device("cpu"))
    for a in (j, t):
        a._rtt, a._rtt_t, a._clock = 0.002, 0.0, lambda: 1.0
    assert t.decode_bytes(16, 8, 12000) == j.decode_bytes(16, 8, 12000)
    assert t.prefill_flops(600, 1000) == j.prefill_flops(600, 1000)
    nb = t.note_block(10.0, 10.5, 16, 8, 12000, 0.0, warm=True)
    assert nb == j.note_block(10.0, 10.5, 16, 8, 12000, 0.0, warm=True)
    util = nb / (0.5 - 0.002) / 3.35e12
    assert t.report()["decode_hbm_util"]["p50"] == pytest.approx(util,
                                                                 abs=1e-4)
    assert t.report().keys() == j.report().keys()
    nb = t.note_mixed_step(11.0, 11.2, 4, 4000, 3e12, warm=True)
    mfu = t.report()["prefill_mfu"]["p50"]
    assert mfu == pytest.approx((nb / 3.35e12 + 3e12 / 989e12) / 0.198,
                                abs=1e-4)


def test_a_block_carrying_prefill_counts_work_but_gives_no_sample():
    """A decode block whose fetch also waits out sequenced prefills counts
    both costs and samples neither ratio (module doc of ``obs/perf.py``)."""
    import torch

    from lmrs_tpu_torch.config import EngineConfig
    from lmrs_tpu_torch.config import model_preset as t_preset
    from lmrs_tpu_torch.obs.perf import DispatchAttribution as TAttr

    t = TAttr(t_preset("bench-8b"), EngineConfig(),
              t_metrics.MetricsRegistry(), device=torch.device("cpu"))
    t._rtt, t._rtt_t, t._clock = 0.002, 0.0, lambda: 1.0
    nb = t.note_block(10.0, 10.5, 16, 8, 12000, 4e12, warm=True)
    assert nb == t.decode_bytes(16, 8, 12000)
    assert t.c_bytes.value == nb and t.c_flops.value == 4e12
    assert t.h_hbm.count == 0 and t.h_mfu.count == 0
    t.note_block(11.0, 11.5, 16, 8, 12000, 0.0, warm=True)
    assert t.h_hbm.count == 1 and t.h_mfu.count == 0


# ------------------------------------------------------ the engine level

@pytest.fixture(scope="module")
def engines():
    """One reference JaxEngine and one port TorchEngine on the same tiny
    weights (f32, the CPU), each run over the same requests with its
    package's tracer on.  Returns per package: (engine, results, trace
    events by track)."""
    import torch  # noqa: F401  (the port's engine)

    from lmrs_tpu.config import EngineConfig as JEngineConfig
    from lmrs_tpu.config import ModelConfig as JModelConfig
    from lmrs_tpu.engine.api import GenerationRequest as JRequest
    from lmrs_tpu.engine.jax_engine import JaxEngine
    from lmrs_tpu.models.transformer import init_params as j_init_params
    from lmrs_tpu_torch.config import EngineConfig
    from lmrs_tpu_torch.config import ModelConfig as TModelConfig
    from lmrs_tpu_torch.engine.api import GenerationRequest
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.models.convert import params_from_jax

    from test_torch_engine import IdTokenizer

    jcfg, tcfg = JModelConfig(name="t", **CFG), TModelConfig(name="t", **CFG)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(7)))
    ekw = dict(max_batch_slots=2, page_size=16, num_pages=40, decode_block=4,
               max_tokens=8, prefill_chunk=4096, seed=0)
    pre = "shared preamble shared preamble! "
    prompts = [pre + "alpha beta", pre + "gamma delta", "x" * 20,
               pre + "epsilon"]
    out = {}
    for name in ("ref", "port"):
        tmod = PKGS[name].trace
        tmod.enable_tracing()
        try:
            if name == "ref":
                eng = JaxEngine(
                    JEngineConfig(backend="jax", scheduler="continuous",
                                  retry_delay=0.0, **ekw), jcfg,
                    params=jax.tree.map(jax.numpy.asarray, tree),
                    tokenizer=IdTokenizer())
                mk = JRequest
            else:
                eng = TorchEngine(EngineConfig(**ekw), tcfg, device="cpu",
                                  params=params_from_jax(tree, tcfg),
                                  tokenizer=IdTokenizer())
                mk = GenerationRequest
            res = eng.generate_batch([
                mk(prompt=p, request_id=i, temperature=0.0,
                   max_new_tokens=8, cache_prefix=len(pre))
                for i, p in enumerate(prompts)])
            spans = tmod.get_tracer().spans_by_tid()
        finally:
            tmod.disable_tracing()
        out[name] = (eng, res, spans)
    return out


# the lifecycle milestones each request's chain is held to (decode_block
# instants and queue_wait spans depend on the block structure)
MILESTONES = ("enqueue", "admit", "prefix_match", "prefill", "first_token",
              "decode", "preempt", "finish", "cancel", "shed", "deadline")


def chain(spans: dict, rid: int) -> list[str]:
    return [e["name"] for e in spans[t_trace.req_tid(rid)]
            if e["name"] in MILESTONES]


def test_engine_trace_chains_match_reference(engines):
    j_eng, j_res, j_spans = engines["ref"]
    t_eng, t_res, t_spans = engines["port"]
    assert [r.text for r in t_res] == [r.text for r in j_res]
    for rid in range(4):
        c = chain(t_spans, rid)
        assert c == chain(j_spans, rid), rid
        assert c[0] == "enqueue" and c[-1] == "finish"
        order = [c.index(x) for x in ("enqueue", "admit", "first_token",
                                      "finish")]
        assert order == sorted(order) and "prefill" in c and "decode" in c
    sched = t_spans[t_trace.TID_SCHED]
    blocks = [e for e in sched if e["name"] == "decode_block"]
    assert blocks and all(e["args"]["hbm_gb"] > 0 for e in blocks)
    assert any(e["name"] == "prefill_dispatch" for e in sched)
    t_trace.validate_trace_events(sum(t_spans.values(), []))


def test_engine_ledger_tokens_match_reference(engines):
    (_, j_res, _), (t_eng, t_res, _) = engines["ref"], engines["port"]
    keys = ("tenant", "prompt_tokens", "generated_tokens", "goodput_tokens",
            "wasted_tokens", "tokens_saved_prefix_cache")
    for j, t in zip(j_res, t_res):
        assert {k: t.usage[k] for k in keys} == {k: j.usage[k] for k in keys}
        assert t.usage["device_seconds"] > 0
    tot = t_eng.usage_report()["totals"]
    assert tot["prompt_tokens"] == sum(r.prompt_tokens for r in t_res)
    assert tot["generated_tokens"] == sum(r.completion_tokens for r in t_res)
    assert t_eng.audit() == []


# metrics_report keys the port carried before the observability slice
PRE_KEYS = {"requests", "prefill_tokens", "prefill_dispatches",
            "packed_prefill_dispatches", "decode_tokens", "decode_blocks",
            "decode_block_seconds", "mixed_step_seconds",
            "decode_tokens_per_sec", "mean_decode_occupancy", "peak_kv_pages",
            "peak_kv_page_utilization", "preemptions", "stalls", "cancelled",
            "deadline", "shed", "mixed_batch", "rpa", "run_seconds",
            "prefix_cache", "host_kv"}


def test_engine_metrics_report_blocks_match_reference(engines):
    j_m = engines["ref"][0].engine_metrics()
    t_eng = engines["port"][0]
    t_m = t_eng.engine_metrics()
    assert PRE_KEYS <= t_m.keys()
    for block in ("slo", "cost", "anatomy", "perf_attribution"):
        assert t_m[block].keys() == j_m[block].keys(), block
    for spec, doc in t_m["slo"]["specs"].items():
        assert doc.keys() == j_m["slo"]["specs"][spec].keys()
    an = t_m["anatomy"]
    assert an["iterations"] > 0 and an["aborted_iterations"] == 0
    assert set(an["classes"]) <= set(t_anatomy.CLASSES)
    assert t_m["cost"]["totals"].keys() == j_m["cost"]["totals"].keys()
    assert t_m["mixed_batch"]["dispatches"] + t_m["decode_blocks"] > 0
    text = t_eng.metrics_registry().render_prometheus()
    for fam in ("lmrs_decode_tokens_total", "lmrs_decode_hbm_util_ratio",
                "lmrs_anatomy_wall_seconds_total",
                "lmrs_cost_decode_device_seconds_total", "lmrs_slo_state"):
        assert fam in text, fam
    counters = t_eng._scheduler.counters
    assert counters["decode_tokens"] == t_m["decode_tokens"]
    assert counters["rpa_dispatches"] == t_m["rpa"]["dispatches"]


def test_span_dispatches_feed_the_bucket_economics(engines):
    """Every ragged-span dispatch lands in one anatomy bucket, with its
    real span tokens and the packed buffer's alignment as padding."""
    t_m = engines["port"][0].engine_metrics()
    buckets = t_m["anatomy"]["buckets"]
    assert t_m["rpa"]["dispatches"] > 0
    assert sum(b["dispatches"] for b in buckets.values()) \
        == t_m["rpa"]["dispatches"]
    assert sum(b["real_tokens"] for b in buckets.values()) \
        == t_m["rpa"]["span_tokens"]
    for key, b in buckets.items():
        tpb = int(key.split("x")[0])
        assert b["real_tokens"] + b["padded_tokens"] == b["dispatches"] * tpb
    assert 0.0 <= t_m["anatomy"]["rpa_pad_waste_ratio"] < 1.0
    assert engines["port"][0].audit() == []


def tiny_engine(**ekw):
    from lmrs_tpu_torch.config import EngineConfig
    from lmrs_tpu_torch.config import ModelConfig as TModelConfig
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine

    from test_torch_engine import IdTokenizer

    kw = dict(max_batch_slots=4, page_size=16, num_pages=40, decode_block=4,
              max_tokens=24, seed=0)
    kw.update(ekw)
    return TorchEngine(EngineConfig(**kw), TModelConfig(name="t", **CFG),
                       device="cpu", tokenizer=IdTokenizer())


def test_audits_hold_after_a_dispatch_fault(tmp_path, monkeypatch):
    """A forward that raises mid-run: the recovery writes a
    ``dispatch_fault`` postmortem, the open anatomy iteration is aborted,
    and both audits (with the pool's) are clean; the engine serves the
    next batch."""
    from lmrs_tpu_torch.engine import scheduler as sched_mod
    from lmrs_tpu_torch.engine.api import GenerationRequest

    monkeypatch.setenv("LMRS_POSTMORTEM_DIR", str(tmp_path))
    monkeypatch.setenv("LMRS_POSTMORTEM_MIN_S", "0")
    eng = tiny_engine()
    real = sched_mod.forward_paged
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected dispatch fault")
        return real(*a, **kw)

    monkeypatch.setattr(sched_mod, "forward_paged", flaky)
    reqs = [GenerationRequest(prompt=f"probe {i} " * 3, request_id=i,
                              temperature=0.0) for i in range(3)]
    with pytest.raises(RuntimeError, match="injected"):
        eng.generate_batch(reqs)
    assert eng.audit() == []
    assert eng.anatomy_report()["aborted_iterations"] == 1
    pm = sorted(tmp_path.glob("postmortem-dispatch_fault-*.json"))
    assert len(pm) == 1
    doc = t_flight.validate_postmortem_file(pm[0])
    assert "injected" in doc["extra"]["error"]
    out = eng.generate_batch(reqs)
    assert all(r.error is None and r.usage for r in out)
    assert eng.audit() == []


def test_deadline_storm_writes_a_postmortem(tmp_path, monkeypatch):
    """Requests whose deadline runs out during their decode expire in one
    sweep: ``deadline`` results, and one ``deadline_storm`` postmortem
    holding the ring's spans (``LMRS_DEADLINE_STORM`` at its default,
    3)."""
    import time

    from lmrs_tpu_torch.engine import scheduler as sched_mod
    from lmrs_tpu_torch.engine.api import GenerationRequest

    monkeypatch.setenv("LMRS_POSTMORTEM_DIR", str(tmp_path))
    monkeypatch.setenv("LMRS_POSTMORTEM_MIN_S", "0")
    eng = tiny_engine(max_tokens=60)
    real = sched_mod.forward_paged

    def slow(*a, **kw):  # every dispatch takes its time
        time.sleep(0.02)
        return real(*a, **kw)

    monkeypatch.setattr(sched_mod, "forward_paged", slow)
    t_trace.enable_tracing()
    try:
        dl = time.time() + 1.0
        out = eng.generate_batch([
            GenerationRequest(prompt=f"storm {i} " * 3, request_id=i,
                              temperature=0.0, max_new_tokens=60,
                              deadline_s=dl) for i in range(4)])
    finally:
        t_trace.disable_tracing()
    assert [r.finish_reason for r in out] == ["deadline"] * 4
    assert all(r.text for r in out)  # expired in flight: partial text kept
    pm = sorted(tmp_path.glob("postmortem-deadline_storm-*.json"))
    assert len(pm) == 1
    doc = t_flight.validate_postmortem_file(pm[0])
    assert doc["extra"]["expired_this_sweep"] == 4
    assert any(e["name"] == "decode_block" for e in doc["spans"])
    assert eng.audit() == []


def test_obs_off_keeps_outputs_and_report_shape(monkeypatch):
    """``LMRS_ANATOMY=0 LMRS_COST_LEDGER=0 LMRS_SLO=0``: the same tokens
    and schedule, no usage, no anatomy block, the SLO pinned ok."""
    from lmrs_tpu_torch.engine.api import GenerationRequest

    reqs = lambda: [GenerationRequest(prompt=f"same {i} " * 4,  # noqa: E731
                                      request_id=i, temperature=0.0)
                    for i in range(3)]
    on = tiny_engine()
    a = on.generate_batch(reqs())
    for k in ("LMRS_ANATOMY", "LMRS_COST_LEDGER", "LMRS_SLO"):
        monkeypatch.setenv(k, "0")
    off = tiny_engine()
    b = off.generate_batch(reqs())
    assert [r.text for r in a] == [r.text for r in b]
    assert all(r.usage for r in a) and not any(r.usage for r in b)
    m_on, m_off = on.engine_metrics(), off.engine_metrics()
    for k in ("decode_tokens", "prefill_tokens", "decode_blocks",
              "prefill_dispatches", "preemptions"):
        assert m_on[k] == m_off[k], k
    assert "anatomy" not in m_off and m_off["cost"] == {"enabled": False}
    assert m_off["slo"]["state"] == "ok" and off.audit() == []


def test_a_dropped_engine_frees_without_a_collection():
    """The scheduler's observability holds it only weakly (the
    postmortems' counter snapshot): dropping a run engine frees its pools
    at once, not at the next garbage collection."""
    import gc
    import weakref

    from lmrs_tpu_torch.engine.api import GenerationRequest

    eng = tiny_engine(max_tokens=8)
    t_trace.enable_tracing()
    gc.disable()
    try:
        eng.generate_batch([GenerationRequest(prompt="drop me", request_id=0)])
        eng.engine_metrics()
        pools = weakref.ref(eng._scheduler.cache.k)
        del eng
        assert pools() is None
    finally:
        gc.enable()
        t_trace.disable_tracing()
