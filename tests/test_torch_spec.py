"""Port parity, linear speculative decoding: the plain PyTorch version of the
port's multi-token verify kernel (``paged_decode_multi_ref``) against the
JAX package's XLA twin ``paged_decode_multi_xla`` and (once) its Pallas
``paged_decode_pallas_multi`` in interpret mode; the walk-only
``paged_decode_ref`` against the Pallas ``paged_decode_pallas`` (once);
drafting, verification and ``filtered_probs`` against the JAX functions;
``forward_paged(multi_decode=True)`` against the JAX one; and the
speculative engine against the port's own non-speculative run and the JAX
teacher-forced loop.  Inputs from numpy seeds.  Tolerances: f32 atol 2e-5
on attention outputs (the reference's own kernel tests), 1e-4 on logits;
pools exact outside the null page.  The CUDA kernels themselves are held
against these plain versions on the card by ``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.config import ModelConfig as JModelConfig
from lmrs_tpu.models.transformer import forward_paged as j_forward_paged
from lmrs_tpu.models.transformer import init_params as j_init_params
from lmrs_tpu.ops import speculative as jspec
from lmrs_tpu.ops.paged_attention import (paged_decode_multi_xla,
                                          paged_decode_pallas,
                                          paged_decode_pallas_multi)
from lmrs_tpu.ops.sampling import filtered_probs as j_filtered_probs
from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.engine.api import GenerationRequest
from lmrs_tpu_torch.engine.torch_engine import TorchEngine
from lmrs_tpu_torch.models.convert import params_from_jax
from lmrs_tpu_torch.models.transformer import forward_paged as t_forward_paged
from lmrs_tpu_torch.ops import paged_attention as tpa
from lmrs_tpu_torch.ops import speculative as tspec
from lmrs_tpu_torch.ops.sampling import filtered_probs

from test_torch_engine import CFG, IdTokenizer, _jax_greedy_check

ATOL = 2e-5
PS = 16


def _multi_fixture(seed, kv_lens, tables, t=5, h=8, kh=4, hd=128, n_pages=16):
    r = np.random.default_rng(seed)
    b = len(kv_lens)
    f = lambda *shape: r.standard_normal(shape).astype(np.float32)  # noqa: E731
    return dict(q=f(b, t, h, hd), k_new=f(b, t, kh, hd), v_new=f(b, t, kh, hd),
                k_pages=f(n_pages, kh, PS, hd), v_pages=f(n_pages, kh, PS, hd),
                page_tables=np.asarray(tables, np.int32),
                kv_lens=np.asarray(kv_lens, np.int32))


def _port_multi(x, max_pos=None):
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    out = tpa.paged_decode_multi(**t, max_pos=max_pos)
    return out.numpy(), t["k_pages"].numpy(), t["v_pages"].numpy()


@pytest.mark.parametrize("max_pos", [None, 40])
def test_multi_ref_matches_xla_twin(max_pos):
    """Row 0's span (13..17) straddles a page; row 1's (45..49) overhangs
    its 3-page table (W·ps = 48); row 2 carries the null table with the
    length the scheduler gives an empty slot (T); row 3's span (37..41)
    overhangs ``max_pos`` = 40 when it is set (row 1 then lies wholly past
    it).  Outputs agree on the rows with real tables; pools agree bit for
    bit everywhere but the null page, where the twin parks skipped writes."""
    tables = [[1, 2, 3], [4, 5, 6], [0, 0, 0], [7, 8, 9]]
    x = _multi_fixture(0, [18, 50, 5, 42], tables)
    got, kp, vp = _port_multi(x, max_pos)
    want, j_kp, j_vp = paged_decode_multi_xla(
        *(jnp.asarray(x[k]) for k in ("q", "k_new", "v_new", "k_pages",
                                       "v_pages", "page_tables", "kv_lens")),
        max_pos=max_pos)
    real = [0, 1, 3]
    np.testing.assert_allclose(got[real], np.asarray(want)[real], atol=ATOL)
    np.testing.assert_array_equal(kp[1:], np.asarray(j_kp)[1:])
    np.testing.assert_array_equal(vp[1:], np.asarray(j_vp)[1:])
    # row 1's in-table tokens 45..47 are written, 48..49 skipped
    written = (kp[6] != x["k_pages"][6]).any(axis=(0, 2))
    expect = [13, 14, 15] if max_pos is None else []  # 45..47 % 16
    assert list(np.flatnonzero(written)) == expect


def test_multi_ref_matches_pallas_kernel():
    """The reference kernel test's shapes (tests/test_kernels.py): spans
    straddling a page and an 8-row window; outputs and pools."""
    x = _multi_fixture(3, [18, 6, 35], [[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    got, kp, vp = _port_multi(x)
    want, j_kp, j_vp = paged_decode_pallas_multi(
        *(jnp.asarray(x[k]) for k in ("q", "k_new", "v_new", "k_pages",
                                       "v_pages", "page_tables", "kv_lens")),
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(kp, np.asarray(j_kp))
    np.testing.assert_array_equal(vp, np.asarray(j_vp))
    assert tpa.paged_decode_multi.launches == 0  # CPU tensors: plain version


def test_walk_only_ref_matches_pallas_kernel():
    r = np.random.default_rng(4)
    b, h, kh, hd, n_pages = 5, 4, 2, 128, 16
    q = r.standard_normal((b, h, hd)).astype(np.float32)
    kp = r.standard_normal((n_pages, kh, PS * 2, hd)).astype(np.float32)
    vp = r.standard_normal((n_pages, kh, PS * 2, hd)).astype(np.float32)
    tables = (r.permutation(n_pages - 1)[: b * 3].reshape(b, 3) + 1).astype(np.int32)
    kv_lens = np.asarray([40, 0, 17, 64, 1], np.int32)  # empty, full-table rows
    want = paged_decode_pallas(*(jnp.asarray(a) for a in (q, kp, vp, tables, kv_lens)),
                               interpret=True)
    got = tpa.paged_decode(*(torch.from_numpy(a) for a in (q, kp, vp, tables, kv_lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not got[1].any()
    assert tpa.paged_decode.launches == 0


@pytest.mark.parametrize("n", [2, 3])
def test_draft_lookup_matches_jax(n):
    """Random histories over 3 tokens (matches everywhere), rows of
    distinct tokens (no match), histories shorter than n, and a match whose
    draft window runs into the live end (n_valid clipped)."""
    r = np.random.default_rng(n)
    b, L, k = 24, 40, 4
    buf = r.integers(0, 3, (b, L)).astype(np.int32)
    hist = r.integers(0, L + 1, b).astype(np.int32)
    buf[0] = np.arange(L)          # no match anywhere
    hist[0] = 30
    hist[1], hist[2] = 1, n - 1    # shorter than n (the latter for n=3)
    buf[3, :8] = [7, 8, 9, 7, 8, 9, 7, 8]  # the match just before the end
    hist[3] = 8
    j_draft, j_n = jspec.draft_lookup(jnp.asarray(buf), jnp.asarray(hist), k,
                                      pad_id=2, n=n)
    t_draft, t_n = tspec.draft_lookup(torch.from_numpy(buf),
                                      torch.from_numpy(hist), k, pad_id=2, n=n)
    np.testing.assert_array_equal(t_draft.numpy(), np.asarray(j_draft))
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    assert t_n[0] == 0 and t_n[1] == 0 and 0 < t_n[3] < k
    assert (t_n > 0).sum() > b // 3  # most histories have a match


def test_verify_tokens_greedy_matches_jax():
    """One-hot probs: accept while the draft equals the argmax, then emit
    the argmax — emit and count identical to the JAX function's."""
    r = np.random.default_rng(5)
    b, k, v = 64, 4, 6
    want_tok = r.integers(0, v, (b, k + 1))
    probs = np.eye(v, dtype=np.float32)[want_tok]
    # drafts agree with the argmax for a random prefix, then differ
    agree = r.integers(0, k + 1, b)
    draft = want_tok[:, :k].copy()
    for i, a in enumerate(agree):
        draft[i, a:] = (want_tok[i, a:k] + 1) % v
    n_valid = r.integers(0, k + 1, b).astype(np.int32)
    j_emit, j_count = jspec.verify_tokens(jnp.asarray(probs), jnp.asarray(draft),
                                          jnp.asarray(n_valid),
                                          jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    t_emit, t_count = tspec.verify_tokens(torch.from_numpy(probs),
                                          torch.from_numpy(draft),
                                          torch.from_numpy(n_valid), gen)
    np.testing.assert_array_equal(t_count.numpy(), np.asarray(j_count))
    np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
    assert (t_count.numpy() == np.minimum(agree, n_valid) + 1).all()


def test_verify_tokens_sampled_marginal():
    """The first emitted token's marginal equals the model's p0 whatever
    the draft (the speculative-sampling guarantee): 20k rows in one call,
    every frequency within 4 sigma."""
    r = np.random.default_rng(6)
    n, v = 20000, 5
    p = r.dirichlet(np.ones(v), size=2).astype(np.float32)
    probs = torch.from_numpy(np.broadcast_to(p, (n, 2, v)).copy())
    draft = torch.full((n, 1), 2, dtype=torch.int32)
    emit, count = tspec.verify_tokens(probs, draft,
                                      torch.ones(n, dtype=torch.int32),
                                      torch.Generator().manual_seed(1))
    freq = np.bincount(emit[:, 0].numpy(), minlength=v) / n
    sigma = np.sqrt(p[0] * (1 - p[0]) / n)
    assert (np.abs(freq - p[0]) <= 4 * sigma).all(), (freq, p[0])
    # an accepted draft (first token == 2) earns a second token
    assert ((emit[:, 0] == 2) == (count == 2)).all()


def test_filtered_probs_matches_jax():
    r = np.random.default_rng(7)
    logits = r.standard_normal((4, 50)).astype(np.float32) * 3
    temps = np.asarray([0.0, 0.7, 1.0, 0.5], np.float32)
    top_k = np.asarray([0, 0, 5, 0], np.int32)
    top_p = np.asarray([1.0, 1.0, 1.0, 0.8], np.float32)
    want = j_filtered_probs(*(jnp.asarray(a) for a in (logits, temps, top_k, top_p)))
    got = filtered_probs(torch.from_numpy(logits), temps, top_k, top_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # every row greedy: one-hot without the softmax
    got0 = filtered_probs(torch.from_numpy(logits), np.zeros(4), top_k, top_p)
    np.testing.assert_array_equal(got0.numpy(), np.eye(50)[logits.argmax(-1)])


def test_forward_paged_multi_decode_matches_jax():
    """A verify step of 3 rows x 5 tokens through both packages'
    ``forward_paged(multi_decode=True)`` (the JAX one on its XLA twin):
    row 0 straddles a page, row 1 overhangs ``max_seq_len`` (its positions
    clamp, its kv_lens does not), row 2 carries the null table.  Logits on
    the rows with real tables, and the pools outside the null pages."""
    jcfg, tcfg = JModelConfig(name="t", **CFG), TModelConfig(name="t", **CFG)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(5)))
    r = np.random.default_rng(8)
    t, n_pool = 5, 12
    shape = (jcfg.n_layers * n_pool, jcfg.n_kv_heads, PS, jcfg.hd)
    kp = r.standard_normal(shape).astype(np.float32)
    vp = r.standard_normal(shape).astype(np.float32)
    tables = np.array([[1, 2, 3, 0, 0, 0, 0, 0], [4, 5, 6, 7, 8, 9, 10, 11],
                       [0] * 8], np.int32)
    lens = np.array([14, 126, 0], np.int64)  # context before the step
    kv_lens = (lens + t).astype(np.int32)
    positions = np.minimum(lens[:, None] + np.arange(t), jcfg.max_seq_len - 1)
    tokens = r.integers(3, 300, (3, t))
    j_logits, j_kp, j_vp = j_forward_paged(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(positions, jnp.int32), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(kv_lens), jcfg.max_seq_len,
        use_ragged_kernel=False, multi_decode=True)
    t_kp, t_vp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t_logits = t_forward_paged(
        params_from_jax(tree, tcfg), tcfg, torch.from_numpy(tokens),
        torch.from_numpy(positions), t_kp, t_vp, torch.from_numpy(tables),
        torch.from_numpy(kv_lens), tcfg.max_seq_len, multi_decode=True)
    assert t_logits.shape == j_logits.shape == (3, t, CFG["vocab_size"])
    np.testing.assert_allclose(t_logits.numpy()[:2], np.asarray(j_logits)[:2],
                               atol=1e-4)
    keep = np.ones(shape[0], bool)
    keep[::n_pool] = False  # the null page of each layer
    np.testing.assert_allclose(t_kp.numpy()[keep], np.asarray(j_kp)[keep], atol=1e-5)
    np.testing.assert_allclose(t_vp.numpy()[keep], np.asarray(j_vp)[keep], atol=1e-5)


def test_spec_engine_matches_plain_and_jax_loop():
    """Greedy speculative decoding (k = 4, mixed steps off) on repetitive
    prompts under pool pressure: 2 slots, a 9-page pool (one preemption), a
    shared 3-page preamble (prefix hits, whose tails prefill as span
    chunks).  Its texts equal the port's own non-speculative run, its tokens
    agree with the JAX teacher-forced loop above the margin, drafts are
    accepted, and the audit is clean."""
    jcfg, tcfg = JModelConfig(name="t", **CFG), TModelConfig(name="t", **CFG)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(7)))
    tok = IdTokenizer()
    max_new = 24
    preamble = "You are summarizing. Keep facts and numbers!!!\n"  # 47 chars
    bodies = ["abab abab ab", "the cat the ", "x" * 12, "0101010101ab"]
    reqs = [GenerationRequest(prompt=preamble + body, request_id=i,
                              temperature=0.0, cache_prefix=len(preamble))
            for i, body in enumerate(bodies)]

    def run(k):
        engine = TorchEngine(
            EngineConfig(max_batch_slots=2, page_size=16, num_pages=9,
                         decode_block=4, max_tokens=max_new, prefill_chunk=32,
                         mixed_batch=False, speculate_k=k),
            tcfg, device="cpu", params=params_from_jax(tree, tcfg),
            tokenizer=tok)
        results = engine.generate_batch(reqs)
        assert engine.audit() == []
        return results, engine.engine_metrics()

    plain, m_plain = run(0)
    spec, m = run(4)
    assert "spec_accepted_tokens" not in m_plain
    assert [r.text for r in spec] == [r.text for r in plain]
    assert m["spec_accepted_tokens"] > 0
    assert m["preemptions"] >= 1
    assert m["prefix_cache"]["hits"] >= 1 and m["rpa"]["dispatches"] >= 1
    assert m["mixed_batch"]["dispatches"] == 0
    checked = 0
    for body, res in zip(bodies, spec):
        assert res.error is None
        gen = [int(t) for t in res.text.split()]
        assert len(gen) == res.completion_tokens <= max_new
        checked += _jax_greedy_check(
            tree, jcfg, [tok.bos_id] + tok.encode(preamble + body), gen,
            max_new, tok.eos_id)
    assert checked >= 40  # the margin rule must leave most tokens checked


def test_config_refuses_speculation_with_mixed_steps():
    """What the config and the CLI refuse of speculation since tree
    speculation is ported: a negative k only.  ``speculate_k`` with mixed
    steps (the reference's tree speculation) is accepted by
    ``EngineConfig`` and by ``lmrs-torch --speculate-k``, which shows in
    the help; without mixed steps it stays linear speculation."""
    from lmrs_tpu_torch.cli import build_parser, config_from_args
    from lmrs_tpu_torch.engine.scheduler import spec_tree_width

    for mixed in (True, False):
        with pytest.raises(ValueError, match="speculate_k"):
            EngineConfig(speculate_k=-1, mixed_batch=mixed)
    assert spec_tree_width(EngineConfig(speculate_k=2)) == 2
    assert EngineConfig(speculate_k=2, mixed_batch=False).speculate_ngram == 3
    assert spec_tree_width(EngineConfig(speculate_k=2, mixed_batch=False)) == 0
    cfg = config_from_args(build_parser().parse_args(
        ["--input", "x.json", "--speculate-k", "4"]))
    assert cfg.engine.speculate_k == 4 and cfg.engine.mixed_batch
    assert "--speculate-k" in build_parser().format_help()
