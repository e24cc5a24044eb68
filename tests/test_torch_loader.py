"""Port parity, weights and tokenizers from local files.

(a) ``utils/safetensors.py`` against the ``safetensors`` package, both
    ways (each writes, the other reads), every dtype the reader takes
    (bf16 included), zero-size and 0-d tensors and ``__metadata__``; a
    tensor past 4 GiB of a sparse file; an unknown dtype refused by name.
(b) ``convert_hf_llama`` (dense and Mixtral layouts, f32 and f16 sources,
    two shards and an unused ``rotary_emb.inv_freq``) and
    ``convert_hf_gemma``: equal, bit for bit, to ``params_from_jax`` of the
    JAX package's conversion of the same directory, into f32 and bf16
    presets; a missing directory, a missing tensor, a shape mismatch and an
    untied Gemma preset raise the reference's exception types.
(c) The native checkpoint: save / load round trip bit for bit (bf16 source
    files too), an int8 load equal to ``quantize_params`` of the plain
    load, a checkpoint refused by name for another preset, a missing shard.
(d) ``lmrs-torch-convert``'s exit codes (0, 1 for an unknown preset or a
    failed conversion, 2 for bad arguments), its family inference, and a
    ``TorchEngine`` built from its output generating what one built from
    the same params in memory generates.
(e) Config and CLI: ``EngineConfig.mixed_token_budget`` reads
    ``LMRS_MIXED_TOKEN_BUDGET`` as the JAX package's does; ``--checkpoint``
    and ``--tokenizer <dir>`` reach the engine and the chunker through a
    full ``lmrs-torch`` run on the CPU."""

import dataclasses
import json
import struct

import jax
import numpy as np
import pytest
import torch

from lmrs_tpu.config import ModelConfig as JModelConfig
from lmrs_tpu.models import loader as jloader
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.config import model_preset as t_preset
from lmrs_tpu_torch.models import loader as tloader
from lmrs_tpu_torch.models.convert import params_from_jax
from lmrs_tpu_torch.ops.quant import is_quantized, quantize_params
from lmrs_tpu_torch.utils import safetensors as st

from conftest import make_segments

safetensors = pytest.importorskip("safetensors")

DENSE = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
             hidden_dim=48, max_seq_len=128, tie_embeddings=False)
FAMILIES = {
    "dense": DENSE,
    "mixtral": dict(DENSE, n_experts=4, n_experts_per_token=2),
    "gemma": dict(DENSE, tie_embeddings=True, activation="gelu",
                  embed_scale=True, norm_eps=1e-6),
}


def _cfgs(family, dtype="float32"):
    kw = dict(FAMILIES[family], dtype=dtype)
    return JModelConfig(name=family, **kw), TModelConfig(name=family, **kw)


def _hf_tensors(cfg, rng, dt=np.float32) -> dict:
    """An HF-layout checkpoint of ``cfg`` ([out, in] matrices, Llama or
    Mixtral names) with random values, norms around 1."""
    D, F, hd = cfg.dim, cfg.hidden_dim, cfg.dim // cfg.n_heads
    H, K = cfg.n_heads, cfg.n_kv_heads

    def rnd(*shape):
        return rng.normal(size=shape).astype(dt)

    t = {"model.embed_tokens.weight": rnd(cfg.vocab_size, D),
         "model.norm.weight": (1 + 0.1 * rnd(D)).astype(dt)}
    if not cfg.tie_embeddings:
        t["lm_head.weight"] = rnd(cfg.vocab_size, D)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}"
        t[f"{p}.input_layernorm.weight"] = (1 + 0.1 * rnd(D)).astype(dt)
        t[f"{p}.post_attention_layernorm.weight"] = (1 + 0.1 * rnd(D)).astype(dt)
        t[f"{p}.self_attn.q_proj.weight"] = rnd(H * hd, D)
        t[f"{p}.self_attn.k_proj.weight"] = rnd(K * hd, D)
        t[f"{p}.self_attn.v_proj.weight"] = rnd(K * hd, D)
        t[f"{p}.self_attn.o_proj.weight"] = rnd(D, H * hd)
        t[f"{p}.self_attn.rotary_emb.inv_freq"] = rnd(hd // 2)  # unused
        if cfg.n_experts:
            m = f"{p}.block_sparse_moe"
            t[f"{m}.gate.weight"] = rnd(cfg.n_experts, D)
            for j in range(cfg.n_experts):
                t[f"{m}.experts.{j}.w1.weight"] = rnd(F, D)
                t[f"{m}.experts.{j}.w3.weight"] = rnd(F, D)
                t[f"{m}.experts.{j}.w2.weight"] = rnd(D, F)
        else:
            t[f"{p}.mlp.gate_proj.weight"] = rnd(F, D)
            t[f"{p}.mlp.up_proj.weight"] = rnd(F, D)
            t[f"{p}.mlp.down_proj.weight"] = rnd(D, F)
    return t


def _write_hf(d, tensors):
    """Two shards, as HF writes large checkpoints."""
    from safetensors.numpy import save_file

    names = sorted(tensors)
    half = len(names) // 2
    d.mkdir(parents=True, exist_ok=True)
    save_file({k: tensors[k] for k in names[:half]},
              str(d / "model-00001-of-00002.safetensors"))
    save_file({k: tensors[k] for k in names[half:]},
              str(d / "model-00002-of-00002.safetensors"))
    return d


def _assert_params_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "layers":
            assert len(a[k]) == len(b[k])
            for la, lb in zip(a[k], b[k]):
                _assert_params_equal(la, lb)
        elif is_quantized(a[k]):
            assert torch.equal(a[k]["q"], b[k]["q"]) and torch.equal(a[k]["s"], b[k]["s"]), k
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert torch.equal(a[k], b[k]), k


# ----------------------------------------------------------------- (a)

def _all_dtypes(g):
    return {"bf16": torch.randn(3, 5, generator=g).bfloat16(),
            "f16": torch.randn(2, 2, generator=g).half(),
            "f32": torch.randn(4, 1, 3, generator=g),
            "i8": torch.randint(-128, 128, (7,), generator=g, dtype=torch.int8),
            "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "i64": torch.arange(5, dtype=torch.int64) - 2**40,
            "empty": torch.zeros(0, 4), "scalar": torch.tensor(3.5)}


def test_safetensors_writer_read_by_package(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file

    t = _all_dtypes(torch.Generator().manual_seed(0))
    n = st.save_file(t, tmp_path / "x.safetensors", {"format": "pt", "k": "v"})
    assert n == (tmp_path / "x.safetensors").stat().st_size
    back = load_file(str(tmp_path / "x.safetensors"))
    assert set(back) == set(t)
    for k in t:
        assert back[k].dtype == t[k].dtype and torch.equal(back[k], t[k]), k
    with safe_open(str(tmp_path / "x.safetensors"), "pt") as f:
        assert f.metadata() == {"format": "pt", "k": "v"}


def test_safetensors_reader_reads_package_files(tmp_path):
    from safetensors.torch import save_file

    t = _all_dtypes(torch.Generator().manual_seed(1))
    save_file(t, str(tmp_path / "y.safetensors"), metadata={"a": "b"})
    with st.SafeFile(tmp_path / "y.safetensors") as f:
        assert f.metadata == {"a": "b"}
        assert set(f.keys()) == set(t)
        for k in t:
            x = f.get(k)
            assert f.shape(k) == tuple(t[k].shape)
            assert x.dtype == t[k].dtype and torch.equal(x, t[k]), k
        with pytest.raises(KeyError, match="'missing'"):
            f.get("missing")
    save_file({"d": torch.zeros(2, dtype=torch.float64)}, str(tmp_path / "z.safetensors"))
    with pytest.raises(ValueError, match="'d' has dtype F64"):
        st.SafeFile(tmp_path / "z.safetensors")


def test_safetensors_reads_past_4gib(tmp_path):
    """A tensor whose offsets pass 2^32 (a sparse file: the hole reads as
    zeros and costs no disk)."""
    big = 2**32 + 8
    header = {"big": {"dtype": "I8", "shape": [big], "data_offsets": [0, big]},
              "tail": {"dtype": "F32", "shape": [4], "data_offsets": [big, big + 16]}}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    path = tmp_path / "big.safetensors"
    tail = torch.tensor([1.0, -2.0, 3.5, 4.0])
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        f.seek(8 + len(blob) + big)
        f.write(tail.numpy().tobytes())
    with st.SafeFile(path) as f:
        assert f.shape("big") == (big,)
        assert torch.equal(f.get("tail"), tail)


# ----------------------------------------------------------------- (b)

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family,src_dt", [("dense", np.float32),
                                           ("mixtral", np.float32),
                                           ("gemma", np.float32),
                                           ("mixtral", np.float16)])
def test_convert_hf_matches_jax(tmp_path, family, src_dt, dtype):
    jcfg, tcfg = _cfgs(family, dtype)
    d = _write_hf(tmp_path / "hf", _hf_tensors(jcfg, np.random.default_rng(0), src_dt))
    if family == "gemma":
        ref, got = jloader.convert_hf_gemma(str(d), jcfg), tloader.convert_hf_gemma(str(d), tcfg)
    else:
        ref, got = jloader.convert_hf_llama(str(d), jcfg), tloader.convert_hf_llama(str(d), tcfg)
    want = params_from_jax(jax.tree.map(np.asarray, ref), tcfg)
    _assert_params_equal(got, want)
    assert got["embed"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("case", ["no-files", "missing-tensor", "shape",
                                  "untied-gemma"])
def test_convert_hf_errors_match_reference(tmp_path, case):
    jcfg, tcfg = _cfgs("mixtral")
    t = _hf_tensors(jcfg, np.random.default_rng(1))
    if case == "missing-tensor":
        del t["model.layers.1.block_sparse_moe.experts.3.w2.weight"]
    if case == "shape":
        t["model.layers.0.self_attn.q_proj.weight"] = np.zeros((30, 32), np.float32)
    d = tmp_path / "hf"
    if case == "no-files":
        d.mkdir()
    else:
        _write_hf(d, t)
    err = {"no-files": FileNotFoundError, "missing-tensor": KeyError,
           "shape": ValueError, "untied-gemma": ValueError}[case]
    if case == "untied-gemma":
        jcfg, tcfg = _cfgs("dense")
        with pytest.raises(err):
            jloader.convert_hf_gemma(str(d), jcfg)
        with pytest.raises(err, match="tie lm_head"):
            tloader.convert_hf_gemma(str(d), tcfg)
        return
    with pytest.raises(err):
        jloader.convert_hf_llama(str(d), jcfg)
    with pytest.raises(err) as exc:
        tloader.convert_hf_llama(str(d), tcfg)
    if case == "missing-tensor":
        assert "experts.3.w2.weight" in str(exc.value)
    if case == "shape":
        assert "q_proj.weight" in str(exc.value) and "[30, 32]" in str(exc.value)


# ----------------------------------------------------------------- (c)

@pytest.mark.parametrize("family", ["dense", "mixtral", "gemma"])
def test_native_checkpoint_round_trip_and_int8(tmp_path, family):
    """bf16 files in, bf16 params out bit for bit; the int8 load equals
    ``quantize_params`` of the plain load."""
    jcfg, tcfg = _cfgs(family, "bfloat16")
    hf = tmp_path / "hf"
    hf.mkdir()
    src = {k: torch.from_numpy(v).bfloat16()
           for k, v in _hf_tensors(jcfg, np.random.default_rng(2)).items()}
    st.save_file(src, hf / "model.safetensors")  # bf16 HF files
    conv = (tloader.convert_hf_gemma if family == "gemma"
            else tloader.convert_hf_llama)
    params = conv(str(hf), tcfg)
    assert torch.equal(params["embed"], src["model.embed_tokens.weight"])
    ck = tmp_path / "ck"
    n = tloader.save_checkpoint(str(ck), params)
    assert n == sum(f.stat().st_size for f in ck.iterdir())
    assert sorted(f.name for f in ck.iterdir()) == [
        "layer_00000.safetensors", "layer_00001.safetensors", "model.safetensors"]
    _assert_params_equal(tloader.load_checkpoint(str(ck), tcfg), params)
    _assert_params_equal(tloader.load_checkpoint(str(ck), tcfg, quantize="int8"),
                         quantize_params(params))
    # a quantized tree saves and loads as it is
    q = quantize_params(params)
    tloader.save_checkpoint(str(tmp_path / "q"), q)
    _assert_params_equal(tloader.load_checkpoint(str(tmp_path / "q"), tcfg), q)


def test_native_checkpoint_refusals(tmp_path):
    _, tcfg = _cfgs("mixtral")
    from lmrs_tpu_torch.models.transformer import init_params

    ck = tmp_path / "ck"
    tloader.save_checkpoint(str(ck), init_params(tcfg, seed=0))
    with pytest.raises(ValueError, match=r"'w_gate_up' .* shape \[4, 32, 96\]; "
                                         r"the preset needs \[4, 32, 128\]"):
        tloader.load_checkpoint(str(ck), dataclasses.replace(tcfg, hidden_dim=64))
    dense = dataclasses.replace(tcfg, n_experts=0)
    with pytest.raises(ValueError, match=r"'w_gate_up' .* \[4, 32, 96\]; "
                                         r"the preset needs \[32, 96\]"):
        tloader.load_checkpoint(str(ck), dense)  # a dense preset, MoE files
    tloader.save_checkpoint(str(tmp_path / "dense"), init_params(dense, seed=0))
    with pytest.raises(KeyError, match="'router'"):  # and the other way
        tloader.load_checkpoint(str(tmp_path / "dense"), tcfg)
    with pytest.raises(ValueError, match="has 2 layers"):
        tloader.load_checkpoint(str(ck), dataclasses.replace(tcfg, n_layers=3))
    (ck / "layer_00001.safetensors").unlink()
    with pytest.raises(FileNotFoundError, match="layer_00001"):
        tloader.load_checkpoint(str(ck), tcfg)
    with pytest.raises(FileNotFoundError, match="lmrs-torch-convert"):
        tloader.load_checkpoint(str(tmp_path / "nothing"), tcfg)


# ----------------------------------------------------------------- (d)

def test_convert_cli_exit_codes_and_engine(tmp_path, capsys):
    """tiny-moe (Mixtral names) through ``lmrs-torch-convert``; the engine
    built from its output generates what the in-memory params generate."""
    from lmrs_tpu_torch.config import EngineConfig
    from lmrs_tpu_torch.engine.api import GenerationRequest
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.models.convert_cli import main

    tcfg = dataclasses.replace(t_preset("tiny-moe"), n_layers=2)
    jcfg = JModelConfig(**dataclasses.asdict(tcfg))
    hf = _write_hf(tmp_path / "hf", _hf_tensors(jcfg, np.random.default_rng(3)))
    out = tmp_path / "ck"
    args = ["--src", str(hf), "--output", str(out), "-q"]
    assert main([*args, "--model", "no-such-preset"]) == 1
    assert main(["--src", str(tmp_path / "empty"), "--output", str(out),
                 "--model", "tiny-moe", "-q"]) == 1
    assert main([*args, "--model", "tiny-moe"]) == 1  # 4 layers, files have 2
    with pytest.raises(SystemExit) as exc:
        main([*args, "--model", "tiny-moe", "--family", "qwen"])
    assert exc.value.code == 2
    assert main([*args, "--model", "bench-smoke", "--family", "gemma"]) == 1
    capsys.readouterr()
    from lmrs_tpu_torch import config as tconfig

    tconfig._PRESETS["tiny-moe-2l"] = dict(tconfig._PRESETS["tiny-moe"], n_layers=2)
    try:
        assert main([*args, "--model", "tiny-moe-2l"]) == 0
        cfg = t_preset("tiny-moe-2l")
    finally:
        del tconfig._PRESETS["tiny-moe-2l"]
    assert f"--checkpoint {out}" in capsys.readouterr().out
    mem = tloader.convert_hf_llama(str(hf), cfg)
    kw = dict(max_tokens=6, num_pages=32, page_size=16, temperature=0.0)
    texts = []
    for engine in (TorchEngine(EngineConfig(checkpoint_path=str(out), **kw), cfg,
                               device="cpu"),
                   TorchEngine(EngineConfig(**kw), cfg, device="cpu", params=mem)):
        res = engine.generate_batch([GenerationRequest(prompt=p, request_id=i)
                                     for i, p in enumerate(["hello", "a b c d"])])
        assert engine.audit() == [] and all(r.error is None for r in res)
        texts.append([(r.text, r.completion_tokens) for r in res])
    assert texts[0] == texts[1]
    with pytest.raises(ValueError, match="not both"):
        TorchEngine(EngineConfig(checkpoint_path=str(out), **kw), cfg,
                    device="cpu", params=mem)


# ----------------------------------------------------------------- (e)

@pytest.mark.parametrize("value", [None, "64", "512"])
def test_mixed_token_budget_reads_env(monkeypatch, value):
    from lmrs_tpu.config import EngineConfig as JEngineConfig
    from lmrs_tpu_torch.config import EngineConfig

    if value is None:
        monkeypatch.delenv("LMRS_MIXED_TOKEN_BUDGET", raising=False)
    else:
        monkeypatch.setenv("LMRS_MIXED_TOKEN_BUDGET", value)
    got = EngineConfig().mixed_token_budget
    assert got == JEngineConfig().mixed_token_budget == int(value or 256)


def test_presets_match_reference():
    from lmrs_tpu.config import model_preset as j_preset

    for name in ("tiny-moe", "mixtral-8x7b"):
        j = dataclasses.asdict(j_preset(name))
        t = dataclasses.asdict(t_preset(name))
        assert {k: j[k] for k in t} == t


@pytest.fixture
def tok_dir(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator([s["text"] for s in make_segments(200, seed=7)],
                            trainers.BpeTrainer(vocab_size=300, special_tokens=[
                                "<pad>", "<s>", "</s>", "<unk>"]))
    d = tmp_path / "tok"
    d.mkdir()
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"bos_token": "<s>", "eos_token": "</s>", "pad_token": "<pad>",
         "unk_token": "<unk>"}))
    return str(d)


def test_cli_checkpoint_and_tokenizer_reach_engine_and_chunker(tmp_path, tok_dir):
    from lmrs_tpu_torch.cli import build_parser, config_from_args, main
    from lmrs_tpu_torch.data.tokenizer import HFTokenizer
    from lmrs_tpu_torch.models.transformer import init_params
    from lmrs_tpu_torch.pipeline import TranscriptSummarizer

    ck = tmp_path / "ck"
    cfg = t_preset("bench-smoke")
    params = init_params(cfg, seed=5)
    tloader.save_checkpoint(str(ck), params)
    argv = ["--input", "x.json", "--model", "bench-smoke", "--checkpoint",
            str(ck), "--tokenizer", tok_dir]
    pc = config_from_args(build_parser().parse_args(argv))
    assert pc.engine.checkpoint_path == str(ck)
    assert pc.engine.tokenizer == pc.chunk.tokenizer == tok_dir
    s = TranscriptSummarizer(pc, device="cpu")
    engine = s.executor.engine
    assert isinstance(engine.tokenizer, HFTokenizer)
    assert isinstance(s.chunker.tokenizer, HFTokenizer)
    assert s.chunker.tokenizer.vocab_size == engine.tokenizer.vocab_size
    _assert_params_equal(engine.params, params)
    src = tmp_path / "t.json"
    src.write_text(json.dumps({"segments": make_segments(12)}))
    out = tmp_path / "s.txt"
    rc = main(["--input", str(src), "--output", str(out), "--model",
               "bench-smoke", "--checkpoint", str(ck), "--tokenizer", tok_dir,
               "--device", "cpu", "--max-tokens", "4", "--report", "-q"])
    assert rc == 0
    report = json.loads((tmp_path / "s.txt.report.json").read_text())
    assert report["failed_requests"] == 0 and report["num_chunks"] >= 1
