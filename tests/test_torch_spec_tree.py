"""Port parity, tree speculation: the plain PyTorch version of the span
kernel's ancestor-mask build (``ragged_spans_ref(anc_masks=)``) against the
JAX package's ``ragged_spans_xla(anc_masks=)`` (f32 and int8 pools) and
against per-branch linear dispatches of the same tokens; the tree drafting
and verification functions against the JAX ones; ``forward_paged(span_anc=)``
against the JAX one; the scheduler's span template and adaptive depth
against the reference's methods; the heal protocol against a linear run's
pool; and the tree-speculation engine against the port's no-speculation and
linear runs and the JAX teacher-forced loop.  Inputs from numpy seeds.
Tolerances: f32 atol 2e-5 on attention outputs (the reference's own kernel
tests), 1e-4 on logits, 1e-5 on pool values written by different dispatch
shapes; pools exact where one function wrote both.  The CUDA build itself is
held against this plain version on the card by ``tests/test_torch_cuda.py``."""

from collections import deque
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.config import ModelConfig as JModelConfig
from lmrs_tpu.engine.scheduler import ContinuousScheduler as JScheduler
from lmrs_tpu.models.transformer import forward_paged as j_forward_paged
from lmrs_tpu.models.transformer import init_params as j_init_params
from lmrs_tpu.ops import speculative as jspec
from lmrs_tpu.ops.paged_attention import ragged_spans_xla
from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.engine.api import GenerationRequest
from lmrs_tpu_torch.engine.kv_cache import SequencePages
from lmrs_tpu_torch.engine.scheduler import (ContinuousScheduler, _SlotState,
                                             spec_tree_width)
from lmrs_tpu_torch.engine.torch_engine import TorchEngine
from lmrs_tpu_torch.models.convert import params_from_jax
from lmrs_tpu_torch.models.transformer import forward_paged as t_forward_paged
from lmrs_tpu_torch.ops import paged_attention as tpa
from lmrs_tpu_torch.ops import speculative as tspec

from test_torch_engine import CFG, IdTokenizer, _jax_greedy_check
from test_torch_int8 import _int8_pools, _tie_scales, _ties

ATOL = 2e-5
PS = 16
K, W = 4, 2  # speculate_k and the default tree width


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The 2-layer test models run thousands of tiny ops: one intra-op
    thread runs them fastest, and keeps the file cheap beside other test
    workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(hl, width=W, k=K):
    """The port scheduler's ancestor masks of a [heal (hl), cur, width
    chains of k] span."""
    ns = SimpleNamespace(_spec_tmpl={}, _spec_width=width, spec_k=k)
    return ContinuousScheduler._tree_span_template(ns, hl)[1]


# tree spans at heal 0-4, a 32-token tree whose last token has bit 31
# (heal 3, two chains of 14), a mask-0 prefill slice, a mask-0 decode row,
# an inactive row: (base, masks)
TREE_ROWS = [(20, _masks(0)), (33, _masks(1)), (47, _masks(2)), (5, _masks(3)),
             (60, _masks(4)), (10, _masks(3, 2, 14)), (16, np.zeros(21, np.int32)),
             (30, np.zeros(1, np.int32)), (0, np.zeros(0, np.int32))]


def _tree_fixture(seed, rows, h=4, kh=2, hd=32, width=8, int8=False):
    """Flat span buffers over ``rows``, random pools and disjoint tables;
    int8: int8 pools, scales [B, K, hd] with row 3's new K/V exact ties."""
    r = np.random.default_rng(seed)
    q_lens = [len(m) for _, m in rows]
    qs, total = tpa.pack_spans(q_lens)
    b = len(rows)
    n_pages = b * width + 1
    row_flat = np.full((total,), b, np.int32)
    anc = np.zeros((total,), np.int32)
    for i, (s, (_, m)) in enumerate(zip(qs, rows)):
        row_flat[s:s + len(m)] = i
        anc[s:s + len(m)] = m
    f = lambda *shape: r.standard_normal(shape).astype(np.float32)  # noqa: E731
    x = dict(q=f(total, h, hd), k_new=f(total, kh, hd), v_new=f(total, kh, hd),
             k_pages=f(n_pages, kh, PS, hd), v_pages=f(n_pages, kh, PS, hd),
             page_tables=(r.permutation(n_pages - 1)[: b * width]
                          .reshape(b, width) + 1).astype(np.int32),
             kv_lens=np.asarray([base for base, _ in rows], np.int32),
             q_starts=qs, q_lens=np.asarray(q_lens, np.int32))
    scales = None
    if int8:
        x["k_pages"], x["v_pages"] = _int8_pools(r, n_pages, kh, hd)
        x["k_new"][qs[3]: qs[3] + q_lens[3]] = _ties(r, (q_lens[3], kh, hd))
        scales = (_tie_scales(r, (b, kh, hd), 3), _tie_scales(r, (b, kh, hd), 3))
    return x, row_flat, anc, scales


def _port_spans(x, anc=None, scales=None):
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    kw = {} if scales is None else dict(kscale=torch.from_numpy(scales[0]),
                                        vscale=torch.from_numpy(scales[1]))
    out = tpa.ragged_spans(**t, **kw,
                           anc_masks=None if anc is None else torch.from_numpy(anc))
    return out.numpy(), t["k_pages"].numpy(), t["v_pages"].numpy()


@pytest.mark.parametrize("int8", [False, True])
def test_anc_ref_matches_xla_twin(int8):
    """One dispatch of tree spans at heal 0-4, a 32-token tree whose last
    token has bit 31 set, a mask-0 prefill slice, a mask-0 decode row and an
    inactive row, through ``ragged_spans_ref(anc_masks=)`` and the JAX
    ``ragged_spans_xla(anc_masks=)``: in-span outputs within 2e-5, pools
    exact outside the null page; int8 pools quantize each token with its
    row's scales (row 3's new K/V exact .5 ties)."""
    x, row_flat, anc, scales = _tree_fixture(1, TREE_ROWS, int8=int8)
    assert (anc < 0).any()  # bit 31: the uint32 word viewed as int32
    got, kp, vp = _port_spans(x, anc, scales)
    want, j_kp, j_vp = ragged_spans_xla(
        **{k: jnp.asarray(v) for k, v in x.items()},
        row_flat=jnp.asarray(row_flat), anc_masks=jnp.asarray(anc),
        kv_scales=None if scales is None else tuple(map(jnp.asarray, scales)))
    in_span = row_flat < len(TREE_ROWS)
    np.testing.assert_allclose(got[in_span], np.asarray(want)[in_span], atol=ATOL)
    np.testing.assert_array_equal(kp[1:], np.asarray(j_kp)[1:])
    np.testing.assert_array_equal(vp[1:], np.asarray(j_vp)[1:])
    # mask-0 rows keep the causal rule: the same outputs without masks
    plain, _, _ = _port_spans(x, None, scales)
    lin = np.isin(row_flat, [6, 7])
    np.testing.assert_array_equal(got[lin], plain[lin])
    assert not (got[~in_span]).any()


@pytest.mark.parametrize("hl", [0, 2])
def test_anc_ref_matches_per_branch_linear_dispatch(hl):
    """A tree span [heal, cur, chain 0, chain 1] beside a mask-0 slice:
    every node's output equals what a LINEAR span [heal, cur, chain c]
    gives it on the same pools (its chain lands at other columns, but the
    visible keys and values are the same set)."""
    rows = [(40, _masks(hl)), (16, np.zeros(21, np.int32))]
    x, _, anc, _ = _tree_fixture(2, rows)
    got, _, _ = _port_spans(x, anc)
    s0, s1 = x["q_starts"]
    for c in range(W):
        sel = ([s0 + i for i in range(hl + 1)]
               + [s0 + hl + 1 + c * K + j for j in range(K)]
               + [s1 + i for i in range(21)])
        lin_lens = [hl + 1 + K, 21]
        lqs, ltotal = tpa.pack_spans(lin_lens)
        at = list(range(lqs[0], lqs[0] + lin_lens[0])) + list(range(lqs[1], lqs[1] + 21))
        y = dict(x, q_starts=lqs, q_lens=np.asarray(lin_lens, np.int32))
        for name in ("q", "k_new", "v_new"):
            buf = np.zeros((ltotal,) + x[name].shape[1:], np.float32)
            buf[at] = x[name][sel]
            y[name] = buf
        want, _, _ = _port_spans(y)
        np.testing.assert_allclose(got[sel], want[at], atol=ATOL)


def test_draft_tree_lookup_matches_jax():
    """Random histories over 3 tokens (many matches) at width 2 and 3,
    with per-row depth clamps, plus the cases the contract names: the two
    most recent matches most recent first, a duplicate root dropped, a
    depth clamp, no match, a history shorter than n."""
    r = np.random.default_rng(3)
    b, L, k = 24, 40, 3
    buf = r.integers(0, 3, (b, L)).astype(np.int32)
    hist = r.integers(0, L + 1, b).astype(np.int32)
    depth = r.integers(0, k + 1, b).astype(np.int32)
    # recency: (5, 6) recurs at 0 (-> 7), 4 (-> 8), 8 (-> 9)
    buf[0, :14] = [5, 6, 7, 1, 5, 6, 8, 2, 5, 6, 9, 3, 5, 6]
    # a duplicate root: both earlier (5, 6) continue with 7
    buf[1, :11] = [5, 6, 7, 1, 5, 6, 7, 2, 4, 5, 6]
    buf[2] = np.arange(L)  # no match
    hist[:4] = [14, 11, 30, 1]
    depth[:4] = [k, k, k, k]
    for width in (2, 3):
        j_ch, j_nv = jspec.draft_tree_lookup(
            jnp.asarray(buf), jnp.asarray(hist), k, width, pad_id=2, n=2,
            depth=jnp.asarray(depth))
        t_ch, t_nv = tspec.draft_tree_lookup(
            torch.from_numpy(buf), torch.from_numpy(hist), k, width, pad_id=2,
            n=2, depth=torch.from_numpy(depth))
        np.testing.assert_array_equal(t_ch.numpy(), np.asarray(j_ch))
        np.testing.assert_array_equal(t_nv.numpy(), np.asarray(j_nv))
        assert t_ch[0, 0, :2].tolist() == [9, 3] and t_ch[0, 1, :2].tolist() == [8, 2]
        assert t_nv[1, 0] > 0 and t_nv[1, 1] == 0      # duplicate root dropped
        assert (t_nv[2] == 0).all() and (t_nv[3] == 0).all()
        assert (t_nv.numpy() <= depth[:, None]).all()  # the clamp
        assert (t_nv > 0).sum() > b // 2


def test_verify_tree_greedy_matches_jax():
    """One-hot node distributions: the chain whose first token is the
    root argmax wins, then accepts while its tokens are the argmax; emit,
    count, chain and depth identical to the JAX function's, including rows
    where no chain matches (chain -1, one token) and rows with no drafts."""
    r = np.random.default_rng(5)
    b, v, k, width = 64, 7, 3, 3
    n_nodes = 1 + width * k
    argmax = r.integers(0, v, (b, n_nodes))
    probs = np.eye(v, dtype=np.float32)[argmax]
    chains = r.integers(0, v, (b, width, k))
    for i in range(b):  # plant the argmax path in a random chain, cut at random
        c, a = r.integers(0, width), r.integers(0, k + 1)
        path = [argmax[i, 0]] + [argmax[i, 1 + c * k + j] for j in range(k - 1)]
        chains[i, c, :a] = path[:a]
    n_valid = r.integers(0, k + 1, (b, width)).astype(np.int32)
    j_out = jspec.verify_tree(jnp.asarray(probs), jnp.asarray(chains, jnp.int32),
                              jnp.asarray(n_valid), jax.random.PRNGKey(0))
    t_out = tspec.verify_tree(torch.from_numpy(probs), torch.from_numpy(chains),
                              torch.from_numpy(n_valid), torch.Generator().manual_seed(0))
    for t, j in zip(t_out, j_out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    emit, count, chain, depth = (x.numpy() for x in t_out)
    assert (chain == -1).any() and (chain > 0).any() and (depth == k).any()


def test_verify_tree_root_marginal_and_count_bounds():
    """Sampled rows: the first emitted token's marginal equals the root
    distribution whatever the candidates (sequential rejection keeps it
    exactly): 20k rows in one call, every frequency within 4 sigma.  And
    on random distributions 1 <= count <= k+1, depth = count - 1, and a
    row whose every root candidate was rejected emits one token."""
    r = np.random.default_rng(6)
    n, v, k, width = 20000, 5, 2, 2
    p0 = np.array([0.4, 0.25, 0.2, 0.1, 0.05], np.float32)
    probs = np.tile(r.dirichlet(np.ones(v), 1 + width * k).astype(np.float32), (n, 1, 1))
    probs[:, 0] = p0
    chains = np.tile(np.array([[1, 3], [0, 2]]), (n, 1, 1))
    n_valid = np.full((n, width), k, np.int32)
    emit, count, chain, depth = tspec.verify_tree(
        torch.from_numpy(probs), torch.from_numpy(chains),
        torch.from_numpy(n_valid), torch.Generator().manual_seed(1))
    freq = np.bincount(emit[:, 0].numpy(), minlength=v) / n
    sigma = np.sqrt(p0 * (1 - p0) / n)
    assert (np.abs(freq - p0) < 4 * sigma).all(), (freq, p0)
    rand = r.dirichlet(np.ones(v), (64, 1 + width * k)).astype(np.float32)
    chains = r.integers(0, v, (64, width, k))
    n_valid = r.integers(0, k + 1, (64, width)).astype(np.int32)
    emit, count, chain, depth = (x.numpy() for x in tspec.verify_tree(
        torch.from_numpy(rand), torch.from_numpy(chains),
        torch.from_numpy(n_valid), torch.Generator().manual_seed(2)))
    assert ((1 <= count) & (count <= k + 1)).all() and (depth == count - 1).all()
    assert (count[chain == -1] == 1).all()
    best = n_valid[np.arange(64), np.maximum(chain, 0)]
    assert (depth <= np.where(chain >= 0, best, 0)).all()


def test_forward_paged_span_anc_matches_jax():
    """A tree-speculation dispatch through both packages'
    ``forward_paged(spans=..., span_anc=...)``: a tree row after a 2-token
    heal (depth-based rope positions), a mask-0 prefill slice and a decode
    row; logits at every node and the pools outside the null pages."""
    jcfg, tcfg = JModelConfig(name="t", **CFG), TModelConfig(name="t", **CFG)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(5)))
    r = np.random.default_rng(6)
    n_pool = 12
    shape = (jcfg.n_layers * n_pool, jcfg.n_kv_heads, PS, jcfg.hd)
    kp = r.standard_normal(shape).astype(np.float32)
    vp = r.standard_normal(shape).astype(np.float32)
    hl = 2
    pos_off, masks = ContinuousScheduler._tree_span_template(
        SimpleNamespace(_spec_tmpl={}, _spec_width=W, spec_k=K), hl)
    q_lens = np.array([len(masks), 21, 1], np.int32)
    base = np.array([28, 16, 5], np.int32)
    tables = np.array([[1, 2, 3], [4, 5, 6], [7, 0, 0]], np.int32)
    qs, total = tpa.pack_spans(q_lens)
    row_flat = np.full((total,), 3, np.int32)
    offs = np.zeros((total,), np.int32)
    anc = np.zeros((total,), np.int32)
    for i, (s, n) in enumerate(zip(qs, q_lens)):
        row_flat[s:s + n] = i
        offs[s:s + n] = np.arange(n)
    offs[qs[0]: qs[0] + q_lens[0]] = pos_off
    anc[qs[0]: qs[0] + q_lens[0]] = masks
    rf = np.clip(row_flat, 0, 2)
    positions = np.clip(base[rf] + offs, 0, jcfg.max_seq_len - 1)[None]
    tokens = r.integers(3, 300, (1, total)).astype(np.int32)
    gidx = np.concatenate([np.arange(s, s + n) for s, n in zip(qs, q_lens)]).astype(np.int32)
    j_logits, j_kp, j_vp = j_forward_paged(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(tokens),
        jnp.asarray(positions), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(base), jcfg.max_seq_len,
        packed_last_idx=jnp.asarray(gidx),
        spans=(jnp.asarray(qs), jnp.asarray(q_lens), jnp.asarray(row_flat)),
        span_anc=jnp.asarray(anc))
    t_kp, t_vp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t = torch.from_numpy
    t_logits = t_forward_paged(
        params_from_jax(tree, tcfg), tcfg, t(tokens).long(), t(positions),
        t_kp, t_vp, t(tables), t(base), tcfg.max_seq_len,
        packed_last_idx=t(gidx), spans=(t(qs), t(q_lens), t(row_flat)),
        span_anc=t(anc))
    assert t_logits.shape == j_logits.shape == (1, len(gidx), CFG["vocab_size"])
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4)
    keep = np.ones(shape[0], bool)
    keep[::n_pool] = False
    np.testing.assert_allclose(t_kp.numpy()[keep], np.asarray(j_kp)[keep], atol=1e-5)
    np.testing.assert_allclose(t_vp.numpy()[keep], np.asarray(j_vp)[keep], atol=1e-5)


@pytest.mark.parametrize("width,k", [(2, 4), (3, 2), (1, 7)])
def test_template_and_ramp_match_reference(width, k):
    """``_tree_span_template`` for every heal length and ``_spec_ramp``
    over a stream of depths and EMAs, on the port's and the reference's
    methods called with the same namespaces (no engine built)."""
    ns = lambda: SimpleNamespace(_spec_tmpl={}, _spec_width=width, spec_k=k)  # noqa: E731
    for hl in range(k + 1):
        for got, want in zip(ContinuousScheduler._tree_span_template(ns(), hl),
                             JScheduler._tree_span_template(ns(), hl)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    r = np.random.default_rng(k)
    st_t = SimpleNamespace(spec_ema=0.5, spec_probe=0)
    st_j = SimpleNamespace(spec_ema=0.5, spec_probe=0)
    for _ in range(60):
        ema, used = float(r.choice([0.05, 0.25, 0.5, 0.9])), int(r.integers(0, k + 1))
        if r.random() < 0.5:
            st_t.spec_ema = st_j.spec_ema = ema
        assert (ContinuousScheduler._spec_ramp(ns(), st_t, used)
                == JScheduler._spec_ramp(ns(), st_j, used))
        assert vars(st_t) == vars(st_j)


def test_tree_width_clamp_and_switches(monkeypatch):
    """``spec_tree_width``: 2 chains by default, narrowed until [heal,
    cur, chains] fits 32 offsets, 0 (linear) for a k too deep, with mixed
    steps off, or under ``LMRS_SPEC_TREE=0``; the env width clamps to 1-8."""
    assert spec_tree_width(EngineConfig(speculate_k=4)) == 2
    assert spec_tree_width(EngineConfig(speculate_k=0)) == 0
    assert spec_tree_width(EngineConfig(speculate_k=4, mixed_batch=False)) == 0
    assert spec_tree_width(EngineConfig(speculate_k=10)) == 2   # 1 + 10*3 = 31
    assert spec_tree_width(EngineConfig(speculate_k=11)) == 1   # 1 + 11*2 = 23
    assert spec_tree_width(EngineConfig(speculate_k=16)) == 0   # 1 + 16*2 = 33
    monkeypatch.setenv("LMRS_SPEC_TREE_WIDTH", "20")
    assert spec_tree_width(EngineConfig(speculate_k=2)) == 8
    monkeypatch.setenv("LMRS_SPEC_TREE", "0")
    assert spec_tree_width(EngineConfig(speculate_k=2)) == 0


# ------------------------------------------------------------- the engine


def _cycle_tree(seed=3):
    """JAX params of the test config whose greedy next byte is the byte
    after the current one (ids 3..258 cycle): each embedding row's
    direction is copied into the LM-head column of its successor, and the
    attention and MLP outputs are scaled by 0.1, so they move the logits
    without changing the cycle.  n-gram drafts from a prompt that repeats
    a byte run are then accepted, on whichever chain continues it."""
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


# a shared preamble (prefix-cache hits), then a byte run, the same run's
# first 3 bytes with another continuation, and the run's first 2 bytes: the
# first step's most recent match drafts "~~~~", the older one the run, and
# the model continues the run, so the second chain wins (a heal follows)
PREAMBLE = "0123456789" * 4 + "\n"


def _cycle_prompts(n=5):
    out = []
    for i in range(n):
        s = "".join(chr(65 + 5 * i + j) for j in range(8))
        out.append(PREAMBLE + s + "|" + s[:3] + "~~~~|" + s[:2])
    return out


def _engine(params, tcfg, k, **kw):
    cfg = dict(max_batch_slots=3, page_size=32, num_pages=24, decode_block=4,
               max_tokens=24, prefill_chunk=4096, speculate_k=k)
    cfg.update(kw)
    return TorchEngine(EngineConfig(**cfg), tcfg, device="cpu", params=params,
                       tokenizer=IdTokenizer())


def _run(engine, prompts):
    """Greedy, budgets 12-24 tokens (uneven, so slots fall out of step and
    admissions meet decoding rows in mixed steps)."""
    res = engine.generate_batch([
        GenerationRequest(prompt=p, request_id=i, temperature=0.0,
                          max_new_tokens=12 + 3 * (i % 5))
        for i, p in enumerate(prompts)])
    assert engine.audit() == []
    assert all(r.error is None for r in res)
    return [r.text for r in res], engine.engine_metrics()


@pytest.mark.parametrize("kv_quantize", [None, "int8"])
def test_tree_engine_greedy_identity(monkeypatch, kv_quantize):
    """Greedy texts identical across no speculation, linear span
    speculation (``LMRS_SPEC_TREE=0``: mixed steps carry [cur, k drafts]
    spans, pure decode the verify block) and tree speculation, with the
    prefix cache (bf16 rule, f32 here) and with int8 KV pages (cache off).
    The tree run dispatches tree spans, accepts drafts and heals; the
    linear one keeps every tree counter at 0.  Then one teacher-forced JAX
    loop over the tree run's tokens (f32, cache on)."""
    jcfg, tree = _cycle_tree()
    tcfg = TModelConfig(name="cycle", **CFG)
    params = params_from_jax(tree, tcfg)
    prompts = _cycle_prompts()
    kw = dict(kv_quantize=kv_quantize)
    plain, m0 = _run(_engine(params, tcfg, 0, **kw), prompts)
    monkeypatch.setenv("LMRS_SPEC_TREE", "0")
    lin, m_lin = _run(_engine(params, tcfg, K, **kw), prompts)
    monkeypatch.delenv("LMRS_SPEC_TREE")
    tree_txt, m = _run(_engine(params, tcfg, K, **kw), prompts)
    assert lin == plain and tree_txt == plain
    assert m_lin["spec_tree_dispatches"] == 0 and not m_lin["spec_tree"]["enabled"]
    assert m_lin["spec_accepted_tokens"] > 0
    blk = m["spec_tree"]
    assert blk["enabled"] and blk["width"] == W
    assert m["spec_tree_dispatches"] == blk["dispatches"] > 0
    assert m["spec_accepted_tokens"] > 0 and blk["heal_spans"] > 0
    assert m["mixed_batch"]["dispatches"] > 0 and m["decode_blocks"] > 0
    assert blk["mean_accept_depth"] == pytest.approx(
        m["spec_accept_depth_sum"] / m["spec_tree_rows"], abs=1e-3)
    if kv_quantize is None:
        assert m["prefix_cache"]["hits"] > 0
        tok = IdTokenizer()
        checked = sum(_jax_greedy_check(tree, jcfg, [tok.bos_id] + tok.encode(p),
                                        [int(t) for t in txt.split()], 12 + 3 * i,
                                        tok.eos_id)
                      for i, (p, txt) in enumerate(zip(prompts[:2], tree_txt[:2])))
        assert checked >= 20  # the margin rule leaves most tokens checked


def _kv_snapshots(engine):
    """Record each slot's K/V window [0, kv_len) and pending heal when it
    finishes (before its pages are freed)."""
    sched = engine._scheduler
    cache, finish = sched.cache, sched._finish_slot
    snaps = {}

    def hook(b, slots, *args, **kw):
        st = slots[b]
        n_pool = cache.num_pages
        pages = torch.tensor(st.seq.pages)
        win = [torch.cat([pool[li * n_pool + pages].permute(1, 0, 2, 3)
                          .reshape(pool.shape[1], -1, pool.shape[3])
                          for li in range(sched.model_cfg.n_layers)])[:, : st.kv_len].clone()
               for pool in (cache.k, cache.v)]
        snaps[st.req.request_id] = (win, len(st.spec_heal))
        return finish(b, slots, *args, **kw)

    sched._finish_slot = hook
    return snaps


def test_heal_leaves_the_pool_of_a_linear_run():
    """A non-first chain's accepted tokens land at its span-offset columns;
    the next span re-sends them first and rewrites them at the true ones.
    Every finished slot's K/V, up to the columns of a heal still pending
    (never read: the slot is gone), equals the no-speculation run's."""
    jcfg, tree = _cycle_tree()
    tcfg = TModelConfig(name="cycle", **CFG)
    params = params_from_jax(tree, tcfg)
    prompts = _cycle_prompts(3)
    lin_eng, tree_eng = _engine(params, tcfg, 0), _engine(params, tcfg, K)
    lin, tre = _kv_snapshots(lin_eng), _kv_snapshots(tree_eng)
    _run(lin_eng, prompts)
    _, m = _run(tree_eng, prompts)
    assert m["spec_tree"]["heal_spans"] >= len(prompts)
    for rid, ((tk, tv), pending) in tre.items():
        (lk, lv), _ = lin[rid]
        n = min(tk.shape[1] - pending, lk.shape[1])
        assert n > len(prompts[rid]) + 8  # past the first heal's columns
        torch.testing.assert_close(tk[:, :n], lk[:, :n], atol=1e-5, rtol=0)
        torch.testing.assert_close(tv[:, :n], lv[:, :n], atol=1e-5, rtol=0)


def test_preempted_heal_reprefills_its_tokens(monkeypatch):
    """A slot preempted with a heal pending requeues prompt + generated
    tokens (the ones to heal included, so the continuation recomputes
    their K/V) and donates prompt pages only, which no heal touches; the
    continuation starts without a heal.  Then a tree run under a pool that
    preempts, with depth pinned (``LMRS_SPEC_ADAPTIVE=0``: page pressure
    would otherwise collapse drafting), heals and gives the
    no-speculation run's texts with a clean audit."""
    jcfg, tree = _cycle_tree()
    tcfg = TModelConfig(name="cycle", **CFG)
    params = params_from_jax(tree, tcfg)
    eng = _engine(params, tcfg, K)
    sched = eng._scheduler
    tok = IdTokenizer()
    prompt = [tok.bos_id] + tok.encode(_cycle_prompts(1)[0])
    generated = [70, 71, 72, 73, 74, 75]
    req = GenerationRequest(prompt="x", request_id=0, temperature=0.0)
    seq = SequencePages(pages=sched.cache.alloc_pages(3))
    st = _SlotState(req=req, prompt_ids=prompt, max_new=24, seq=seq,
                    generated=generated, kv_len=len(prompt) + 5,
                    phase="decode", n_prompt=len(prompt), spec_heal=[71, 72, 73, 74])
    slots, queue = [st, None, None], deque()
    arrays = (np.zeros(3, np.int32), np.zeros(3, np.int64), np.ones(3, bool))
    sched._preempt(0, slots, queue, *arrays)
    assert slots[0] is None and len(queue) == 1
    assert queue[0][1] == prompt + generated and queue[0][4] == generated
    pages, cached = sched._prefix_cache.match(prompt + generated)
    assert 0 < cached <= len(prompt)
    sched.cache.allocator.free(pages)  # the match's own references
    assert eng.audit() == []
    prompts = _cycle_prompts(3)
    plain, _ = _run(_engine(params, tcfg, 0, num_pages=8), prompts)
    monkeypatch.setenv("LMRS_SPEC_ADAPTIVE", "0")
    got, m = _run(_engine(params, tcfg, K, num_pages=8), prompts)
    assert got == plain
    assert m["preemptions"] > 0 and m["spec_tree"]["heal_spans"] > 0


def test_fuzzed_admission_audit_clean():
    """Varied lengths, budgets and temperatures through the tree path with
    3 slots and a small pool (admission churn, preemption): the audit stays
    clean, every request ends within its budget, tree spans dispatched."""
    rng = np.random.default_rng(11)
    tcfg = TModelConfig(name="t", **CFG)
    jcfg = JModelConfig(name="t", **CFG)
    params = params_from_jax(jax.tree.map(np.asarray, j_init_params(
        jcfg, jax.random.PRNGKey(2))), tcfg)
    words = ["alpha", "beta", "gamma", "the", "cat", "sat"]
    reqs = [GenerationRequest(
        prompt=" ".join(rng.choice(words, 6 + 5 * (i % 3)).tolist()) * (1 + i % 2),
        request_id=i, temperature=float(rng.choice([0.0, 0.8])),
        top_k=int(rng.choice([0, 40])), max_new_tokens=int(rng.integers(4, 18)))
        for i in range(8)]
    eng = _engine(params, tcfg, 3, num_pages=12, max_tokens=18)
    out = eng.generate_batch(reqs)
    m = eng.engine_metrics()
    assert eng.audit() == []
    assert m["spec_tree_dispatches"] > 0
    for req, res in zip(reqs, out):
        assert res.error is None
        assert 0 < res.completion_tokens <= req.max_new_tokens


def test_cli_runs_tree_speculation(tmp_path):
    """``lmrs-torch --speculate-k 4`` on the CPU: tree speculation under
    the default mixed steps, no failed request, tree dispatches in the
    report."""
    import json
    from pathlib import Path

    from lmrs_tpu_torch.cli import main

    from conftest import make_segments

    src = tmp_path / "t.json"
    src.write_text(json.dumps({"segments": make_segments(12)}))
    out = tmp_path / "s.txt"
    rc = main(["--input", str(src), "--output", str(out), "--model",
               "bench-smoke", "--tokenizer", "byte", "--device", "cpu",
               "--max-tokens", "12", "--speculate-k", "4", "--report", "-q"])
    assert rc == 0 and out.read_text(encoding="utf-8")
    report = json.loads(Path(str(out) + ".report.json").read_text())
    em = report["engine_metrics"]
    assert report["failed_requests"] == 0
    assert em["spec_tree"]["enabled"] and em["spec_tree_dispatches"] > 0
