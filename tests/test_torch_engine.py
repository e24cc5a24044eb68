"""Port parity, the slice as a whole: ``TorchEngine`` greedy decoding held
against a JAX ``forward_paged`` greedy loop from the same weights (teacher
forced; tokens must agree wherever the reference's top-2 logit margin
exceeds 1e-3, far above the f32 logit tolerance of 1e-4), one
``lmrs-torch`` CLI run on the CPU, and the package's isolation from JAX and
from ``lmrs_tpu``."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.config import ModelConfig as JModelConfig
from lmrs_tpu.models.transformer import forward_paged as j_forward_paged
from lmrs_tpu.models.transformer import init_params as j_init_params
from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.engine.api import GenerationRequest
from lmrs_tpu_torch.engine.torch_engine import TorchEngine
from lmrs_tpu_torch.models.convert import params_from_jax

from conftest import make_segments

REPO = Path(__file__).resolve().parents[1]
MARGIN = 1e-3
CFG = dict(vocab_size=300, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
           hidden_dim=160, max_seq_len=128, dtype="float32",
           tie_embeddings=False)


class IdTokenizer:
    """Byte ids in, decimal ids out: a reversible text form of the
    generated ids, so the test reads exactly what the engine sampled."""

    pad_id, bos_id, eos_id, vocab_size = 0, 1, 2, 259

    def encode(self, text):
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)

    def count(self, text):
        return len(text.encode("utf-8"))


_JIT = {}


def _jitted_forward(jcfg):
    """One jitted reference forward per config (eager calls would retrace
    the layer scan every step)."""
    if jcfg.name not in _JIT:
        _JIT[jcfg.name] = jax.jit(
            lambda params, toks, pos, kp, vp, table, lens, last_pos:
            j_forward_paged(params, jcfg, toks, pos, kp, vp, table, lens,
                            jcfg.max_seq_len, last_pos=last_pos))
    return _JIT[jcfg.name]


def _jax_greedy_check(tree, jcfg, prompt_ids, generated, max_new, eos):
    """Teacher-forced JAX loop over the engine's tokens: returns how many
    tokens were checked (margin above MARGIN)."""
    ps = 16
    n = len(prompt_ids)
    n_pages = -(-(n + max_new + 1) // ps)
    shape = (jcfg.n_layers * (n_pages + 1), jcfg.n_kv_heads, ps, jcfg.hd)
    kp, vp = jnp.zeros(shape), jnp.zeros(shape)
    table = jnp.arange(1, n_pages + 1, dtype=jnp.int32)[None]
    params = jax.tree.map(jnp.asarray, tree)
    fwd = _jitted_forward(jcfg)
    logits, kp, vp = fwd(
        params, jnp.asarray([prompt_ids], jnp.int32),
        jnp.arange(n, dtype=jnp.int32)[None], kp, vp, table,
        jnp.asarray([n], jnp.int32), jnp.asarray([n - 1], jnp.int32))
    checked = 0
    stream = list(generated) + ([eos] if len(generated) < max_new else [])
    for step, tok in enumerate(stream):
        row = np.asarray(logits)[0, 0, :IdTokenizer.vocab_size]
        top2 = np.sort(row)[-2:]
        if top2[1] - top2[0] > MARGIN:
            assert int(row.argmax()) == tok, f"step {step}"
            checked += 1
        if step == len(stream) - 1:
            break
        pos = n + step
        logits, kp, vp = fwd(
            params, jnp.asarray([[tok]], jnp.int32),
            jnp.asarray([[pos]], jnp.int32), kp, vp, table,
            jnp.asarray([pos + 1], jnp.int32), jnp.asarray([0], jnp.int32))
    return checked


def test_engine_greedy_matches_jax_loop():
    jcfg = JModelConfig(name="t", **CFG)
    tcfg = TModelConfig(name="t", **CFG)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(7)))
    tok = IdTokenizer()
    max_new = 10
    engine = TorchEngine(
        EngineConfig(max_batch_slots=2, page_size=16, num_pages=40,
                     decode_block=4, max_tokens=max_new, prefill_chunk=4096),
        tcfg, device="cpu", params=params_from_jax(tree, tcfg), tokenizer=tok)
    # equal lengths: the reference prefill compiles once; 2 slots still
    # give one packed wave (2 prompts) and one lone fresh prefill
    prompts = ["alpha beta gamma", "the quick brown!", "x" * 16]
    results = engine.generate_batch([
        GenerationRequest(prompt=p, request_id=i, temperature=0.0)
        for i, p in enumerate(prompts)])
    assert engine.audit() == []
    metrics = engine.engine_metrics()
    assert metrics["packed_prefill_dispatches"] >= 1  # 2 slots: a packed wave
    assert metrics["prefill_dispatches"] > metrics["packed_prefill_dispatches"]
    checked = 0
    for p, res in zip(prompts, results):
        assert res.error is None
        gen = [int(t) for t in res.text.split()]
        assert len(gen) == res.completion_tokens <= max_new
        checked += _jax_greedy_check(tree, jcfg, [tok.bos_id] + tok.encode(p),
                                     gen, max_new, tok.eos_id)
    assert checked >= 20  # the margin rule must leave most tokens checked


def test_prompt_past_prefill_chunk_fails_alone():
    """A prompt longer than one prefill chunk no longer fails: it prefills
    in continuation chunks through the span route and completes beside the
    rest of the batch; the pool is audited clean."""
    tcfg = TModelConfig(name="t", **CFG)
    engine = TorchEngine(
        EngineConfig(max_batch_slots=2, page_size=16, num_pages=20,
                     decode_block=4, max_tokens=4, prefill_chunk=32),
        tcfg, device="cpu", tokenizer=IdTokenizer())
    short, long_ = engine.generate_batch([
        GenerationRequest(prompt="short", request_id=0, temperature=0.0),
        GenerationRequest(prompt="y" * 40, request_id=1, temperature=0.0)])
    assert short.error is None and short.completion_tokens > 0
    assert long_.error is None and long_.completion_tokens > 0
    assert long_.prompt_tokens == 41
    assert engine.engine_metrics()["rpa"]["dispatches"] >= 1
    assert engine.audit() == []


def check_default_path(cfg: dict, name: str = "t") -> None:
    """The default path under pressure for the model ``cfg``: 2 slots, a
    9-page pool and prompts longer than the 32-token prefill chunk.  The
    first wave prefills in continuation chunks, the shared 3-page preamble
    is cached, page growth preempts the younger slot, whose continuation
    (and every later request) hits the cache and prefills through mixed
    steps beside the decoding slot.  Greedy tokens agree with the JAX
    teacher-forced loop; every route shows in the metrics and the audit is
    clean."""
    jcfg = JModelConfig(name=name, **cfg)
    tcfg = TModelConfig(name=name, **cfg)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(7)))
    tok = IdTokenizer()
    max_new = 24
    engine = TorchEngine(
        EngineConfig(max_batch_slots=2, page_size=16, num_pages=9,
                     decode_block=4, max_tokens=max_new, prefill_chunk=32,
                     mixed_token_budget=32),
        tcfg, device="cpu", params=params_from_jax(tree, tcfg), tokenizer=tok)
    preamble = "You are summarizing. Keep facts and numbers!!!\n"  # 47 chars
    bodies = ["alpha beta g", "the quick br", "x" * 12, "0123456789ab"]
    results = engine.generate_batch([
        GenerationRequest(prompt=preamble + body, request_id=i,
                          temperature=0.0, cache_prefix=len(preamble))
        for i, body in enumerate(bodies)])
    assert engine.audit() == []
    m = engine.engine_metrics()
    assert m["preemptions"] >= 1
    assert m["mixed_batch"]["dispatches"] >= 1
    assert m["prefix_cache"]["hits"] >= 1
    assert m["prefix_cache"]["tokens_reused"] >= 48
    assert m["rpa"]["dispatches"] > m["mixed_batch"]["dispatches"]  # chunks
    checked = 0
    for body, res in zip(bodies, results):
        assert res.error is None and res.prompt_tokens == 60
        gen = [int(t) for t in res.text.split()]
        assert len(gen) == res.completion_tokens <= max_new
        checked += _jax_greedy_check(
            tree, jcfg, [tok.bos_id] + tok.encode(preamble + body), gen,
            max_new, tok.eos_id)
    assert checked >= 40  # the margin rule must leave most tokens checked


def test_engine_default_path_matches_jax_loop():
    """``check_default_path`` at the engine tests' Llama-style model."""
    check_default_path(CFG)


def test_cli_summarizes_on_cpu(tmp_path):
    from lmrs_tpu_torch.cli import main

    src = tmp_path / "t.json"
    src.write_text(json.dumps({"segments": make_segments(30)}))
    out = tmp_path / "s.txt"
    rc = main(["--input", str(src), "--output", str(out), "--model",
               "bench-smoke", "--tokenizer", "byte", "--device", "cpu",
               "--max-tokens", "16", "--report", "-q"])
    assert rc == 0
    assert out.read_text(encoding="utf-8")
    report = json.loads(Path(str(out) + ".report.json").read_text())
    assert report["failed_requests"] == 0 and report["num_chunks"] >= 1


def test_cli_no_prefix_cache_runs(tmp_path):
    from lmrs_tpu_torch.cli import config_from_args, build_parser, main

    args = build_parser().parse_args(["--input", "x.json", "--no-prefix-cache"])
    assert config_from_args(args).engine.prefix_cache is False
    src = tmp_path / "t.json"
    src.write_text(json.dumps({"segments": make_segments(10)}))
    out = tmp_path / "s.txt"
    rc = main(["--input", str(src), "--output", str(out), "--model",
               "bench-smoke", "--tokenizer", "byte", "--device", "cpu",
               "--max-tokens", "4", "--no-prefix-cache", "--report", "-q"])
    assert rc == 0
    report = json.loads(Path(str(out) + ".report.json").read_text())
    assert report["failed_requests"] == 0
    assert "prefix_cache" not in report["engine_metrics"]


@pytest.mark.parametrize("flag", [["--profile"],
                                  ["--kv-quantize", "int4"], ["--mesh", "1,2"]])
def test_cli_refuses_later_slices(tmp_path, flag, capsys):
    """Flags of later slices are refused by name; since int8 is ported,
    ``--kv-quantize`` is refused only for a mode the reference lacks (and
    since tree speculation is, ``--speculate-k`` is accepted, since
    checkpoints are, ``--checkpoint``, since the serving surface is,
    ``--backend`` and ``--hosts``, and since observability is,
    ``--profile``: the missing transcript then fails the run, not the
    flag)."""
    from lmrs_tpu_torch.cli import main

    if flag == ["--profile"]:
        assert main(["--input", str(tmp_path / "missing.json"), *flag]) == 1
        assert "not in the port" not in capsys.readouterr().err
        return
    with pytest.raises(SystemExit) as exc:
        main(["--input", str(tmp_path / "missing.json"), *flag])
    assert exc.value.code == 2
    want = "supported: int8" if "int4" in flag else "slice"
    assert want in capsys.readouterr().err


@pytest.mark.parametrize("var,field,want", [
    ("LMRS_HOST_KV", "host_kv", False), ("LMRS_KV_DISK", "kv_disk", True)])
def test_host_kv_environment_switches(monkeypatch, tmp_path, var, field,
                                      want, capsys):
    """The spill tiers are set, as in the reference, through the
    environment and ``EngineConfig``: ``LMRS_HOST_KV=0`` disarms the host
    tier, ``LMRS_KV_DISK=1`` arms the disk tier under it.  The CLI has no
    ``--host-kv`` flag (the reference's ``lmrs`` has none)."""
    from lmrs_tpu_torch.cli import build_parser

    monkeypatch.setenv(var, "1" if want else "0")
    monkeypatch.setenv("LMRS_KV_DISK_DIR", str(tmp_path))
    cfg = EngineConfig(page_size=16, num_pages=16)
    assert getattr(cfg, field) is want
    eng = TorchEngine(cfg, TModelConfig(**CFG), device="cpu",
                      tokenizer=IdTokenizer())
    pc = eng._scheduler._prefix_cache
    assert (pc.pool is not None) is cfg.host_kv
    assert (pc.disk is not None) is (cfg.host_kv and cfg.kv_disk)
    assert eng.engine_metrics()["host_kv"]["enabled"] is cfg.host_kv
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--input", "x.json", "--host-kv"])
    assert "unrecognized arguments: --host-kv" in capsys.readouterr().err


@pytest.mark.parametrize("flag,slice_", [
    (["--mesh", "1,2"], "A8"),
    (["--profile"], "A10"),
    (["--trace-out", "t.json"], "A10"), (["--no-trace"], "A10")])
def test_cli_refuses_reference_flags_by_name(tmp_path, flag, slice_, capsys):
    """The reference CLI's flags of features the port lacks are refused by
    name with the slice that brings them, not as unrecognized arguments.
    Since observability (A10) came, its flags work: a mock-backend run
    with ``--trace-out`` writes a valid trace on the way out, ``--no-trace``
    beside it writes none, and ``--profile`` runs the stages in profiler
    ranges."""
    from lmrs_tpu_torch.cli import main

    if slice_ == "A10":
        from lmrs_tpu_torch.obs import disable_tracing, validate_trace_file

        src = tmp_path / "in.json"
        src.write_text(json.dumps({"segments": make_segments(6)}))
        out = tmp_path / "t.json"
        args = flag if flag[0] != "--trace-out" else ["--trace-out", str(out)]
        extra = ["--trace-out", str(out)] if flag == ["--no-trace"] else []
        try:
            assert main(["--input", str(src), "--backend", "mock", "-q",
                         *args, *extra]) == 0
        finally:
            disable_tracing()
        assert out.exists() is (flag[0] == "--trace-out")
        if out.exists():
            names = {e["name"] for e in validate_trace_file(out)}
            assert {"map_stage", "generate", "finish"} <= names
        assert "not in the port" not in capsys.readouterr().err
        return
    with pytest.raises(SystemExit) as exc:
        main(["--input", str(tmp_path / "missing.json"), *flag])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag[0]} is not in the port yet" in err
    assert f"({slice_}) slice" in err
    assert "unrecognized" not in err


@pytest.mark.parametrize("flag,field,want", [
    (["--save-chunks", "c.json"], None, None),
    (["--resume-from", "c.json"], None, None),
    (["--stream-reduce"], "reduce.streaming", True),
    (["--max-concurrent-requests", "4"], "engine.max_concurrent_requests", 4)])
def test_cli_accepts_pipeline_parity_flags(flag, field, want):
    """The reference's A11 flags, refused by name until the pipeline,
    executor and CLI parity slice, are accepted and reach their config
    field (the dump paths go to ``summarize``, not to the config)."""
    from lmrs_tpu_torch.cli import build_parser, config_from_args

    args = build_parser().parse_args(["--input", "x.json", *flag])
    cfg = config_from_args(args)
    if field is None:
        assert getattr(args, flag[0][2:].replace("-", "_")) == flag[1]
    else:
        part, name = field.split(".")
        assert getattr(getattr(cfg, part), name) == want
        default = config_from_args(build_parser().parse_args(["--input", "x.json"]))
        assert getattr(getattr(default, part), name) != want


def test_engine_raises_without_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchEngine(EngineConfig(), TModelConfig(name="t", **CFG))


def test_package_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import lmrs_tpu_torch\n"
        "for m in pkgutil.walk_packages(lmrs_tpu_torch.__path__, 'lmrs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = [k for k in sys.modules if k == 'lmrs_tpu' or k.startswith('lmrs_tpu.')]\n"
        "assert not bad, bad\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['ml_dtypes'] is None\n"
        "for m in ('engine.host_kv', 'serving.handoff', 'jobs.journal',\n"
        "          'jobs.manager', 'live.session', 'obs.trace', 'obs.flight',\n"
        "          'obs.perf', 'obs.anatomy', 'obs.ledger', 'obs.slo',\n"
        "          'obs.metrics', 'utils.perf_model', 'utils.timing',\n"
        "          'training.train', 'training.cli', 'eval.rouge',\n"
        "          'eval.synthetic', 'eval.parity', 'testing.faults',\n"
        "          'engine.watchdog', 'serving.supervisor', 'fleet',\n"
        "          'fleet.qos', 'fleet.autoscale', 'analysis',\n"
        "          'analysis.__main__', 'analysis.cli', 'analysis.core',\n"
        "          'analysis.drift', 'analysis.envpass', 'analysis.locks',\n"
        "          'analysis.tracing', 'runtime', 'runtime.native',\n"
        "          'utils.logging', 'testing.alloc_script'):\n"
        "    assert 'lmrs_tpu_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# ------------------------------------------------------------ static path

STATIC_PROMPTS = ["alpha beta gamma", "the quick brown fox jumps", "x" * 70]


class WideIdTokenizer(IdTokenizer):
    """``IdTokenizer`` over the whole model vocabulary: the port's rule of
    never sampling an id the tokenizer cannot decode does not bind."""

    vocab_size = CFG["vocab_size"]


def _static_engines(max_new: int = 6):
    from lmrs_tpu.config import EngineConfig as JEngineConfig
    from lmrs_tpu.engine.jax_engine import JaxEngine

    jcfg = JModelConfig(name="t", **CFG)
    tcfg = TModelConfig(name="t", **CFG)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(11)))
    kw = dict(scheduler="static", max_batch_slots=2, max_tokens=max_new,
              seed=0)
    ref = JaxEngine(JEngineConfig(backend="jax", **kw), jcfg,
                    params=jax.tree.map(jnp.asarray, tree),
                    tokenizer=WideIdTokenizer())
    port = TorchEngine(EngineConfig(**kw), tcfg, device="cpu",
                       params=params_from_jax(tree, tcfg),
                       tokenizer=WideIdTokenizer())
    return ref, port, tree


def test_static_engine_greedy_matches_jax_static():
    """``scheduler="static"``: lockstep waves (2 slots, 3 prompts of three
    lengths: two waves, buckets 64 and 128), greedy tokens identical to the
    reference's static engine, finish reasons and token counts too; with a
    tokenizer narrower than the model's vocabulary no id past it is
    sampled (as on the continuous path)."""
    ref, port, tree = _static_engines()
    reqs = [GenerationRequest(prompt=p, request_id=i, temperature=0.0)
            for i, p in enumerate(STATIC_PROMPTS)]
    from lmrs_tpu.engine.api import GenerationRequest as JRequest

    want = ref.generate_batch([JRequest(prompt=p, request_id=i,
                                        temperature=0.0)
                               for i, p in enumerate(STATIC_PROMPTS)])
    got = port.generate_batch(reqs)
    assert [(r.request_id, r.text, r.completion_tokens, r.prompt_tokens,
             r.finish_reason) for r in got] == \
        [(r.request_id, r.text, r.completion_tokens, r.prompt_tokens,
          r.finish_reason) for r in want]
    assert all(r.completion_tokens > 0 for r in got)
    assert max(int(t) for r in got for t in r.text.split()) >= \
        IdTokenizer.vocab_size  # the wide tokenizer lets the limit go
    ref.shutdown()
    tcfg = TModelConfig(name="t", **CFG)
    narrow = TorchEngine(EngineConfig(scheduler="static", max_batch_slots=2,
                                      max_tokens=6, seed=0), tcfg,
                         device="cpu", params=params_from_jax(tree, tcfg),
                         tokenizer=IdTokenizer())
    ids = [int(t) for r in narrow.generate_batch(reqs) for t in r.text.split()]
    assert ids and max(ids) < IdTokenizer.vocab_size


def test_static_engine_surface():
    """The static engine's hooks answer with the reference's empty shapes;
    an expired deadline sheds at admission; ``on_tokens``/``on_result``
    arrive once per finished request, and what ``on_result`` submits runs
    in a later wave."""
    import time as _time

    tcfg = TModelConfig(name="t", **CFG)
    eng = TorchEngine(EngineConfig(scheduler="static", max_batch_slots=2,
                                   max_tokens=4), tcfg, device="cpu",
                      tokenizer=IdTokenizer())
    assert not eng.schedules_internally and not eng.supports_handoff
    assert eng.engine_metrics() == {} and eng.prefix_summary() == []
    assert eng.audit() == [] and eng.kv_export("x") is None
    assert eng.metrics_registry() is None
    assert eng.usage_report()["enabled"] is False
    assert eng.anatomy_report() == {"object": "anatomy", "enabled": False}
    assert eng.slo_report()["state"] == "ok"
    with pytest.raises(RuntimeError, match="no prefix cache"):
        eng.kv_import({})
    with pytest.raises(KeyError):
        eng.export_handoff(1)
    eng.cancel(1)  # no abort point: a no-op
    streamed, seen = [], []

    def on_result(res, submit):
        seen.append(res.request_id)
        if res.request_id == 0:
            submit([GenerationRequest(prompt="late", request_id=9,
                                      temperature=0.0)])

    out = eng.generate_batch(
        [GenerationRequest(prompt="abc", request_id=0, temperature=0.0),
         GenerationRequest(prompt="old", request_id=1,
                           deadline_s=_time.time() - 1)],
        on_result=on_result,
        on_tokens=lambda rid, text: streamed.append(rid))
    assert [r.request_id for r in out] == [0, 1, 9]
    assert out[1].finish_reason == "shed" and out[1].completion_tokens == 0
    assert seen == [0, 1, 9] and streamed == [0, 9]


def test_static_config_accepted_unknown_refused():
    assert EngineConfig(scheduler="static").scheduler == "static"
    with pytest.raises(ValueError, match="want continuous|static"):
        EngineConfig(scheduler="lockstep")


# ------------------------------------------------ environment switches


def test_prefix_cache_env_kill_switch(monkeypatch):
    """``LMRS_PREFIX_CACHE=0`` disarms the prefix cache in both packages'
    engines: neither reports a ``prefix_cache`` block."""
    from lmrs_tpu.config import EngineConfig as JEngineConfig
    from lmrs_tpu.engine.jax_engine import JaxEngine

    jcfg = JModelConfig(name="t", **CFG)
    tcfg = TModelConfig(name="t", **CFG)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(1)))
    kw = dict(max_batch_slots=2, page_size=16, num_pages=40)
    for env, on in (("1", True), ("0", False)):
        monkeypatch.setenv("LMRS_PREFIX_CACHE", env)
        ref = JaxEngine(JEngineConfig(backend="jax", **kw), jcfg,
                        params=jax.tree.map(jnp.asarray, tree),
                        tokenizer=IdTokenizer())
        port = TorchEngine(EngineConfig(**kw), tcfg, device="cpu",
                           params=params_from_jax(tree, tcfg),
                           tokenizer=IdTokenizer())
        assert ("prefix_cache" in ref.engine_metrics()) is on
        assert ("prefix_cache" in port.engine_metrics()) is on
        ref.shutdown()


@pytest.mark.parametrize("env,want", [
    ({}, "torch"),
    ({"LMRS_BACKEND": "mock"}, "mock"),
    ({"DEFAULT_PROVIDER": "http"}, "http"),
    ({"DEFAULT_PROVIDER": "openai"}, "torch"),
    ({"LMRS_BACKEND": "anthropic"}, "torch"),
    ({"LMRS_BACKEND": "mock", "DEFAULT_PROVIDER": "anthropic"}, "mock"),
    ({"LMRS_BACKEND": "torch", "DEFAULT_PROVIDER": "anthropic"}, "torch"),
    ({"LMRS_BACKEND": "jax"}, None),
])
def test_backend_environment_switches(monkeypatch, env, want):
    """``LMRS_BACKEND`` then ``DEFAULT_PROVIDER`` pick the backend as in the
    reference; its HTTP-vendor names in the environment map to the local
    default, which in the port is ``torch`` (the mock only when named);
    unset, the backend is ``torch``; ``jax`` is refused by name."""
    for name in ("LMRS_BACKEND", "DEFAULT_PROVIDER"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if want is None:
        with pytest.raises(ValueError, match="JAX package's engine"):
            EngineConfig()
    else:
        assert EngineConfig().backend == want


def _switch_run(monkeypatch, var, value, **engine_kw):
    monkeypatch.setenv(var, value)
    tcfg = TModelConfig(name="t", **CFG)
    eng = TorchEngine(EngineConfig(max_batch_slots=2, page_size=16,
                                   num_pages=40, decode_block=4, max_tokens=6,
                                   **engine_kw),
                      tcfg, device="cpu", tokenizer=IdTokenizer())
    syncs = []
    note = eng._scheduler._perf.note_prefill_sync
    eng._scheduler._perf.note_prefill_sync = (
        lambda *a, **k: (syncs.append(1), note(*a, **k)))
    res = eng.generate_batch([
        GenerationRequest(prompt=p, request_id=i, temperature=0.0)
        for i, p in enumerate(STATIC_PROMPTS[:2])])
    assert eng.audit() == []
    return [r.text for r in res], eng.engine_metrics(), len(syncs)


def test_pack_prefill_environment_switch(monkeypatch):
    """``LMRS_PACK_PREFILL=0`` prefills each whole prompt in its own
    dispatch (no packed dispatch); the tokens do not change."""
    on, m_on, _ = _switch_run(monkeypatch, "LMRS_PACK_PREFILL", "1")
    off, m_off, _ = _switch_run(monkeypatch, "LMRS_PACK_PREFILL", "0")
    assert m_on["packed_prefill_dispatches"] == 1
    assert m_off["packed_prefill_dispatches"] == 0
    assert m_off["prefill_dispatches"] == 2
    assert off == on


def test_defer_tok0_environment_switch(monkeypatch):
    """``LMRS_DEFER_TOK0=0`` fetches a prefill wave's first tokens on their
    own (a synchronous prefill sample) instead of with the next decode
    block; the tokens do not change."""
    kw = dict(mixed_batch=False)
    on, _, n_on = _switch_run(monkeypatch, "LMRS_DEFER_TOK0", "1", **kw)
    off, _, n_off = _switch_run(monkeypatch, "LMRS_DEFER_TOK0", "0", **kw)
    assert n_on == 0 and n_off >= 1
    assert off == on
