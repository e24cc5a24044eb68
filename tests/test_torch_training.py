"""Port parity of the training slice: ``models.transformer.forward``
(cache-less and dense-cache), ``training.train`` (loss, gradients, AdamW
steps, remat, the warmup-cosine schedule) and ``training.cli``
(``lmrs-train-torch``), held against the JAX package on the CPU in f32 at
tiny widths, inputs drawn with numpy from a seed.  Tolerances are stated
at each test; the slice as a whole is a model trained a few steps in each
package, then decoded greedily by the port's engine and checked token by
token against the JAX-trained model's logits."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lmrs_tpu.config import ModelConfig as JModelConfig
from lmrs_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from lmrs_tpu.models.transformer import forward as j_forward
from lmrs_tpu.models.transformer import init_kv_cache as j_init_kv_cache
from lmrs_tpu.models.transformer import init_params as j_init_params
from lmrs_tpu.training import cli as j_cli
from lmrs_tpu.training.train import causal_lm_loss as j_loss
from lmrs_tpu.training.train import make_train_step as j_make_train_step
from lmrs_tpu_torch.config import EngineConfig, model_preset
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
from lmrs_tpu_torch.engine.api import GenerationRequest
from lmrs_tpu_torch.engine.torch_engine import TorchEngine
from lmrs_tpu_torch.models.convert import params_from_jax, params_to_jax
from lmrs_tpu_torch.models.loader import load_checkpoint
from lmrs_tpu_torch.models.transformer import (forward, init_kv_cache,
                                               init_params)
from lmrs_tpu_torch.training import cli
from lmrs_tpu_torch.training.train import (adamw, causal_lm_loss, grads_of,
                                           make_train_step, trainable,
                                           warmup_cosine_decay)

DENSE = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
             hidden_dim=48, max_seq_len=64, dtype="float32")
MOE = dict(DENSE, n_experts=4, n_experts_per_token=2,
           expert_capacity_factor=1.25)
GEMMA = dict(DENSE, embed_scale=True, logit_softcap=30.0, activation="gelu",
             tie_embeddings=True, norm_eps=1e-6)


def _models(widths: dict, seed: int = 0):
    jcfg = JModelConfig(name="t", **widths)
    tcfg = TModelConfig(name="t", **widths)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, tree


def _batch(vocab: int, b: int = 2, s: int = 16, seed: int = 1):
    r = np.random.default_rng(seed)
    tokens = r.integers(0, vocab, (b, s)).astype(np.int32)
    mask = (r.random((b, s)) < 0.7).astype(np.int32)
    return tokens, mask


def _close(got: dict, want: dict, scale_tol: float, where: str = "") -> None:
    """Every leaf of two reference-layout trees within ``scale_tol`` times
    max(1, max |want|) of that leaf."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close(got[k], want[k], scale_tol, f"{where}/{k}")
        return
    want = np.asarray(want, np.float32)
    tol = scale_tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol, (where, err, tol)


@pytest.mark.parametrize("widths", [DENSE, MOE, GEMMA],
                         ids=["dense", "moe", "gemma"])
def test_loss_and_grads_match_jax(widths):
    """Masked loss (rtol 1e-5) and every gradient leaf (<= 1e-5 *
    max(1, max |g|)); the MoE case includes the router's aux term, and at
    capacity 1.25 equal shapes give equal drops."""
    jcfg, tcfg, tree = _models(widths)
    tokens, mask = _batch(widths["vocab_size"])
    want_loss, want_grads = jax.value_and_grad(j_loss)(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(tokens),
        loss_mask=jnp.asarray(mask))
    params = trainable(params_from_jax(tree, tcfg))
    loss = causal_lm_loss(params, tcfg, torch.from_numpy(tokens),
                          torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _close(params_to_jax(grads_of(params), tcfg),
           jax.tree.map(np.asarray, want_grads), 1e-5)


def test_adamw_steps_match_optax():
    """Three ``make_train_step`` updates against ``optax.adamw(1e-3)`` from
    the same init and batches: per-step losses rtol 1e-4, params after
    step 3 within 1e-5 * max(1, max |p|) (a step moves a param by at most
    ~lr = 1e-3; fp rounding of the gradients moves it by far less)."""
    jcfg, tcfg, tree = _models(DENSE)
    opt = optax.adamw(1e-3)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = opt.init(jparams)
    jstep = j_make_train_step(jcfg, opt, masked=True)
    params = trainable(params_from_jax(tree, tcfg))
    step = make_train_step(tcfg, adamw(params, 1e-3), masked=True)
    for i in range(3):
        tokens, mask = _batch(DENSE["vocab_size"], seed=10 + i)
        jparams, jstate, jl = jstep(jparams, jstate, jnp.asarray(tokens),
                                    jnp.asarray(mask))
        tl = step(params, torch.from_numpy(tokens), torch.from_numpy(mask))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    _close(params_to_jax(params, tcfg), jax.tree.map(np.asarray, jparams),
           1e-5)


def test_adamw_defaults_are_optax():
    params = trainable(params_from_jax(_models(DENSE)[2],
                                       TModelConfig(name="t", **DENSE)))
    opt = adamw(params, 3e-4)
    (group,) = opt.param_groups
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8
    assert group["betas"] == (0.9, 0.999) and group["lr"] == 3e-4
    n_layer_leaves = sum(len(lp) for lp in params["layers"])
    assert len(group["params"]) == n_layer_leaves + 2  # embed, final_norm


@pytest.mark.parametrize("widths", [DENSE, MOE], ids=["dense", "moe"])
def test_remat_matches_no_remat(widths):
    """``remat=True`` recomputes each layer in backward: the same loss and
    gradients (<= 1e-6 * max(1, max |g|))."""
    _, tcfg, tree = _models(widths)
    tokens, mask = _batch(widths["vocab_size"])
    out = []
    for remat in (False, True):
        params = trainable(params_from_jax(tree, tcfg))
        loss = causal_lm_loss(params, tcfg, torch.from_numpy(tokens),
                              torch.from_numpy(mask), remat=remat)
        loss.backward()
        out.append((loss.item(), params_to_jax(grads_of(params), tcfg)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    _close(out[1][1], out[0][1], 1e-6)


def test_warmup_cosine_matches_optax():
    """Every step of the 1,500-step schedule of the quality gate, the
    first update's lr 0 included (rtol 1e-5: optax evaluates the schedule
    in f32, the port in f64)."""
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 100, 1500, 6e-5)
    got = warmup_cosine_decay(0.0, 3e-3, 100, 1500, 6e-5)
    steps = np.arange(1600)
    np.testing.assert_allclose([got(int(i)) for i in steps],
                               np.asarray(want(steps)), rtol=1e-5, atol=1e-12)
    assert got(0) == 0.0


@pytest.mark.parametrize("widths", [DENSE, GEMMA], ids=["dense", "gemma"])
def test_forward_matches_jax(widths):
    """Cache-less logits over a padded batch (kv_length) and the
    dense-cache branch (a prefill, then two decode steps) against the
    reference's ``forward``: f32 logits within 1e-4."""
    jcfg, tcfg, tree = _models(widths)
    params = params_from_jax(tree, tcfg)
    tokens, _ = _batch(widths["vocab_size"], b=2, s=12)
    lens = np.array([12, 7], np.int32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    jp = jax.tree.map(jnp.asarray, tree)
    want, _ = j_forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(pos),
                        kv_length=jnp.asarray(lens))
    with torch.no_grad():
        got, cache = forward(params, tcfg, torch.from_numpy(tokens),
                             torch.from_numpy(pos),
                             kv_length=torch.from_numpy(lens))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    jcache = j_init_kv_cache(jcfg, 2, 16)
    tcache = init_kv_cache(tcfg, 2, 16)
    want, jcache = j_forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(pos),
                             jcache, jnp.asarray(lens))
    with torch.no_grad():
        got, tcache = forward(params, tcfg, torch.from_numpy(tokens),
                              torch.from_numpy(pos), tcache,
                              torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    tok = np.asarray(want)[np.arange(2), lens - 1].argmax(-1)
    for step in range(2):
        tok = tok.astype(np.int32)[:, None]
        p = (lens + step)[:, None]
        want, jcache = j_forward(jp, jcfg, jnp.asarray(tok), jnp.asarray(p),
                                 jcache, jnp.asarray(lens + step + 1))
        with torch.no_grad():
            got, tcache = forward(params, tcfg, torch.from_numpy(tok).long(),
                                  torch.from_numpy(p), tcache,
                                  torch.from_numpy(lens + step + 1))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        tok = np.asarray(want)[:, 0].argmax(-1)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-4)


def test_forward_refuses_ring_attention_and_meshes():
    _, tcfg, tree = _models(DENSE)
    params = params_from_jax(tree, tcfg)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="multi-GPU"):
        forward(params, tcfg, tokens, torch.arange(4)[None],
                attn_fn=lambda *a: None)
    opt = adamw(trainable(params), 1e-3)
    with pytest.raises(ValueError, match="mesh is not in the port"):
        make_train_step(tcfg, opt, mesh=object())
    with pytest.raises(ValueError, match="sequence-sharded"):
        make_train_step(tcfg, opt, seq_sharded=True)


class IdTokenizer:
    """Byte ids in, decimal ids out: the test reads exactly what the
    engine sampled."""

    pad_id, bos_id, eos_id, vocab_size = 0, 1, 2, 259

    def encode(self, text):
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)

    def count(self, text):
        return len(text.encode("utf-8"))


def _write_rows(path, rows):
    path.write_text("\n".join(json.dumps(r) for r in rows), encoding="utf-8")


ROWS = [{"text": "plain text example one"},
        {"prompt": "List the topics.\n[00:00] budget talk", "summary": " budget."},
        {"text": "ünïcode bytes too"},
        {"prompt": "summarize:", "summary": " short"},
        {"text": "x" * 40}]


def test_data_pipeline_matches_reference(tmp_path):
    """``load_examples`` and the first batches of ``batches`` (seeded numpy
    shuffle, tail topped up by cycling) identical to the reference's."""
    data = tmp_path / "d.jsonl"
    _write_rows(data, ROWS)
    seqs, masks = cli.load_examples(str(data), ByteTokenizer())
    assert (seqs, masks) == j_cli.load_examples(str(data), JByteTokenizer())
    got = cli.batches(seqs, masks, 2, 24, 3)
    want = j_cli.batches(seqs, masks, 2, 24, 3)
    for _ in range(7):  # past two epochs of 3 batches
        (t, m), (jt, jm) = next(got), next(want)
        assert t.dtype == jt.dtype == np.int32
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(m, jm)


def test_cli_refuses_bad_inputs(tmp_path, caplog):
    """A malformed row and an id past the model's vocabulary exit 1 with the
    reason logged; ``--mesh`` exits 2 naming the slice that brings it."""
    bad = tmp_path / "bad.jsonl"
    _write_rows(bad, [{"text": "ok"}, {"question": "no such keys"}])
    with pytest.raises(ValueError, match=r"bad.jsonl:2: row needs"):
        cli.load_examples(str(bad), ByteTokenizer())
    out = str(tmp_path / "out")
    assert cli.main(["--data", str(bad), "--output", out, "--device", "cpu",
                     "--model", "bench-smoke"]) == 1
    assert "could not set up training" in caplog.text
    good = tmp_path / "good.jsonl"
    _write_rows(good, ROWS)
    # tiny's vocabulary is 512: the byte tokenizer's ids fit, approx's
    # (hashed words, up to 32,767) run past it
    assert cli.main(["--data", str(good), "--output", out, "--device", "cpu",
                     "--model", "tiny", "--tokenizer", "approx"]) == 1
    assert "vocab_size 512" in caplog.text
    with pytest.raises(SystemExit) as e:
        cli.main(["--data", str(good), "--output", out, "--mesh", "1,2"])
    assert e.value.code == 2


def test_cli_raises_without_cuda_unless_cpu_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    good = tmp_path / "good.jsonl"
    _write_rows(good, ROWS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--data", str(good), "--output", str(tmp_path / "o")])


def test_cli_trains_saves_and_resumes_on_cpu(tmp_path):
    """``lmrs-train-torch --device cpu``: its checkpoint serves through
    ``TorchEngine(checkpoint_path=)``, and ``--init-checkpoint`` resumes
    from it (one step at lr 0 writes back the loaded weights exactly)."""
    data = tmp_path / "d.jsonl"
    _write_rows(data, ROWS)
    out, out2 = tmp_path / "ck", tmp_path / "ck2"
    common = ["--data", str(data), "--model", "bench-smoke", "--device", "cpu",
              "--batch-size", "2", "--seq-len", "32", "-q"]
    assert cli.main(common + ["--output", str(out), "--steps", "3"]) == 0
    cfg = model_preset("bench-smoke")
    trained = load_checkpoint(str(out), cfg)
    init = init_params(cfg, 0)
    assert not torch.equal(trained["embed"], init["embed"])  # it trained
    engine = TorchEngine(EngineConfig(checkpoint_path=str(out), max_tokens=4,
                                      max_batch_slots=2, page_size=16,
                                      num_pages=64),
                         cfg, device="cpu")
    (res,) = engine.generate_batch([GenerationRequest(
        prompt="summarize:", temperature=0.0, max_new_tokens=4)])
    assert res.error is None and res.completion_tokens >= 1
    assert cli.main(common + ["--output", str(out2), "--steps", "1",
                              "--lr", "0", "--init-checkpoint", str(out)]) == 0
    resumed = load_checkpoint(str(out2), cfg)
    assert torch.equal(resumed["embed"], trained["embed"])
    for a, b in zip(resumed["layers"], trained["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_slice_trained_in_each_package_decodes_alike():
    """The slice as a whole: the same init trained 4 AdamW steps in each
    package, then the port's engine decodes greedily from its weights; the
    JAX-trained model's logits, teacher-forced over the port's tokens, pick
    every token whose top-2 margin exceeds 1e-3 (far above the f32 logit
    gap between the two trainings)."""
    widths = dict(DENSE, vocab_size=300, max_seq_len=128)
    jcfg, tcfg, tree = _models(widths, seed=3)
    r = np.random.default_rng(5)
    batches = [r.integers(3, 120, (4, 24)).astype(np.int32) for _ in range(4)]
    opt = optax.adamw(1e-2)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = opt.init(jparams)
    jstep = j_make_train_step(jcfg, opt)
    params = trainable(params_from_jax(tree, tcfg))
    step = make_train_step(tcfg, adamw(params, 1e-2))
    for t in batches:
        jparams, jstate, _ = jstep(jparams, jstate, jnp.asarray(t))
        step(params, torch.from_numpy(t))
    tok = IdTokenizer()
    engine = TorchEngine(EngineConfig(max_tokens=12, max_batch_slots=2,
                                      page_size=16, num_pages=64,
                                      decode_block=4),
                         tcfg, device="cpu",
                         params={k: v for k, v in params.items()},
                         tokenizer=tok)
    prompts = ["the budget review", "hiring plan next"]
    results = engine.generate_batch([
        GenerationRequest(prompt=p, request_id=i, temperature=0.0,
                          max_new_tokens=12) for i, p in enumerate(prompts)])
    checked = 0
    for p, res in zip(prompts, results):
        ids = [tok.bos_id] + tok.encode(p)
        gen = [int(t) for t in res.text.split()]
        assert len(gen) == res.completion_tokens
        seq = np.asarray([ids + gen], np.int32)
        logits, _ = j_forward(jparams, jcfg, jnp.asarray(seq),
                              jnp.arange(seq.shape[1])[None])
        rows = np.asarray(logits)[0, len(ids) - 1: -1, : tok.vocab_size]
        for row, want in zip(rows, gen):
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] > 1e-3:
                assert int(row.argmax()) == want
                checked += 1
    assert checked >= 12
