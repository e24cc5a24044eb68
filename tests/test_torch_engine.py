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
        "          'obs.metrics', 'utils.perf_model', 'utils.timing'):\n"
        "    assert 'lmrs_tpu_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
