"""Port parity at head dim 256, the Gemma presets' (``gemma-2b``: 8 query
heads over one kv head; ``gemma-7b``: 16 over 16).

(a) The plain PyTorch version of every kernel function at hd 256 against
    the JAX package's Pallas kernels in interpret mode, on the same numpy
    inputs, at both head groupings (H/K 1 and 8): ``flash_attention``
    (packed and not), ``paged_decode_pallas_fused`` (bf16 and int8 pools),
    the walk-only ``paged_decode_pallas``, ``ragged_spans_pallas`` and
    ``paged_decode_pallas_multi`` (bf16 and int8).  f32 outputs within
    2e-5; pools exact (the verify kernel's outside the null page, the span
    kernel's inside each row's written window: the Pallas kernel also
    writes tile padding past it).
(b) ``forward_paged`` of a Gemma-style model whose ``head_dim`` (256) is
    not ``dim // n_heads`` (128 / 2), against the JAX ``forward_paged`` on
    the fresh, packed, decode, span and verify routes: f32 logits within
    1e-4, pools within 1e-5 (the model tests' tolerances).
(c) The engine's default path (preemption, mixed steps, prefix hits) at
    that model against the JAX teacher-forced greedy loop.

The CUDA hd-256 builds are held against these plain versions on the card
(``tests/test_torch_cuda.py::test_kernels_at_hd256``, ``chip_smoke.py``
phase 3c)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.config import ModelConfig as JModelConfig
from lmrs_tpu.models.transformer import forward_paged as j_forward_paged
from lmrs_tpu.models.transformer import init_params as j_init_params
from lmrs_tpu.ops.flash_attention import flash_attention as j_flash
from lmrs_tpu.ops.paged_attention import (paged_decode_pallas,
                                          paged_decode_pallas_fused,
                                          paged_decode_pallas_multi,
                                          ragged_spans_pallas)
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.models.convert import params_from_jax
from lmrs_tpu_torch.models.transformer import forward_paged as t_forward_paged
from lmrs_tpu_torch.ops import flash_attention as tfa
from lmrs_tpu_torch.ops import paged_attention as tpa

from test_torch_engine import check_default_path

ATOL = 2e-5
HD = 256
PS = 32  # int8 pools need page_size % 32 == 0; bf16 ones use it too
GROUPS = {"h2k2": (2, 2), "h8k1": (8, 1)}  # (H, K): H/K 1 and 8

t_ = torch.from_numpy


def _normal(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def _ties(r, shape):
    """Values (m + 0.5) * 2^-5: every x / 2^-5 is an exact .5 tie, and
    some saturate past +-127."""
    return ((r.integers(-140, 140, shape) + 0.5) * 2.0 ** -5).astype(np.float32)


def _scales(r, shape, tie_row):
    """Per-(row, kv head, channel) scales; ``tie_row``'s are 2^-5."""
    s = r.uniform(0.01, 0.05, shape).astype(np.float32)
    s[tie_row] = 2.0 ** -5
    return s


def _pools(r, n_pages, kh, int8):
    shape = (n_pages, kh, PS, HD)
    if int8:
        return (r.integers(-127, 128, shape).astype(np.int8),
                r.integers(-127, 128, shape).astype(np.int8))
    return _normal(r, *shape), _normal(r, *shape)


def _tables(r, b, w, n_pages):
    return (r.permutation(n_pages - 1)[: b * w].reshape(b, w) + 1).astype(np.int32)


# ----------------------------------------------------------------- (a)


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("packed", [False, True])
def test_flash_ref_matches_jax_kernel_at_hd256(packed, group):
    """Lengths < S, S = 200 not a multiple of the 128 block, and (packed)
    three segments and a padded tail."""
    h, kh = GROUPS[group]
    b, s = (1 if packed else 2), 200
    r = np.random.default_rng(0)
    q, k, v = _normal(r, b, s, h, HD), _normal(r, b, s, kh, HD), _normal(r, b, s, kh, HD)
    if packed:
        seg = np.full((1, s), -1, np.int32)
        seg[0, :70], seg[0, 70:131], seg[0, 131:190] = 0, 1, 2
        lens = np.array([190], np.int32)
    else:
        seg, lens = None, np.array([200, 77], np.int32)
    want = np.asarray(j_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        q_block=128, kv_block=128, interpret=True,
        segment_ids=None if seg is None else jnp.asarray(seg)))
    got = tfa.flash_attention(t_(q), t_(k), t_(v), t_(lens),
                              segment_ids=None if seg is None else t_(seg)).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=ATOL)
        assert not got[i, n:].any()  # rows past the length: zero (contract)
    assert tfa.flash_attention.launches == 0  # CPU tensors: plain version


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("kind", ["bf16", "int8", "walk"])
def test_decode_refs_match_jax_kernels_at_hd256(kind, group):
    """3 rows: mid-page, a page boundary, the table's full width; row 1's
    new K/V are exact ties of x / s (int8).  The write-fused kernel's
    output and pools, or the walk-only kernel's output."""
    h, kh = GROUPS[group]
    int8 = kind == "int8"
    r = np.random.default_rng(1)
    b, w, n_pages = 3, 3, 12
    kp, vp = _pools(r, n_pages, kh, int8)
    tables = _tables(r, b, w, n_pages)
    lens = np.array([2 * PS + 17, PS, 3 * PS], np.int32)
    q = _normal(r, b, h, HD)
    if kind == "walk":
        want = paged_decode_pallas(*map(jnp.asarray, (q, kp, vp, tables, lens)),
                                   interpret=True)
        got = tpa.paged_decode(*map(t_, (q, kp, vp, tables, lens)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        assert tpa.paged_decode.launches == 0
        return
    kn, vn = _normal(r, b, kh, HD), _normal(r, b, kh, HD)
    scales = {}
    if int8:
        kn[1], vn[1] = _ties(r, (kh, HD)), _ties(r, (kh, HD))
        scales = dict(kscale=_scales(r, (b, kh, HD), 1),
                      vscale=_scales(r, (b, kh, HD), 1))
    want, j_kp, j_vp = paged_decode_pallas_fused(
        *map(jnp.asarray, (q, kn, vn, kp, vp, tables, lens)), interpret=True,
        **{k: jnp.asarray(v) for k, v in scales.items()})
    tk, tv = t_(kp.copy()), t_(vp.copy())
    got = tpa.paged_decode_fused(t_(q), t_(kn), t_(vn), tk, tv, t_(tables),
                                 t_(lens), **{k: t_(v) for k, v in scales.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(j_kp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(j_vp))
    assert (tpa.paged_decode_fused.launches, tpa.paged_decode_fused.launches_int8) == (0, 0)


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("int8", [False, True])
def test_multi_ref_matches_jax_kernel_at_hd256(int8, group):
    """A verify batch of 3 rows x T=5 (40 query rows a kv head at H/K 8):
    row 0 straddles a page, row 1's tokens are exact ties (int8), row 2
    runs past ``max_pos`` = 90 (two tokens written, three skipped).
    Outputs; pools outside the null page."""
    h, kh = GROUPS[group]
    r = np.random.default_rng(2)
    b, t, w, n_pages, max_pos = 3, 5, 3, 16, 90
    kp, vp = _pools(r, n_pages, kh, int8)
    tables = _tables(r, b, w, n_pages)
    lens = np.array([PS + 3, 40, 93], np.int32)  # counting the T tokens
    q, kn, vn = _normal(r, b, t, h, HD), _normal(r, b, t, kh, HD), _normal(r, b, t, kh, HD)
    scales = {}
    if int8:
        kn[1], vn[1] = _ties(r, (t, kh, HD)), _ties(r, (t, kh, HD))
        scales = dict(kscale=_scales(r, (b, kh, HD), 1),
                      vscale=_scales(r, (b, kh, HD), 1))
    want, j_kp, j_vp = paged_decode_pallas_multi(
        *map(jnp.asarray, (q, kn, vn, kp, vp, tables, lens)), interpret=True,
        max_pos=max_pos, **{k: jnp.asarray(v) for k, v in scales.items()})
    tk, tv = t_(kp.copy()), t_(vp.copy())
    got = tpa.paged_decode_multi(t_(q), t_(kn), t_(vn), tk, tv, t_(tables),
                                 t_(lens), max_pos,
                                 **{k: t_(v) for k, v in scales.items()}).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(j_kp)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(j_vp)[1:])


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("int8", [False, True])
def test_spans_ref_matches_jax_kernel_at_hd256(int8, group):
    """A decode row, a base-0 span, a continuation span crossing a page, a
    decode row with exact ties (int8) and an inactive row.  Outputs on
    in-span tokens; pools within each row's written window."""
    h, kh = GROUPS[group]
    r = np.random.default_rng(3)
    q_lens, bases = [1, 21, 9, 1, 0], [40, 0, 50, 7, 0]
    qs, total = tpa.pack_spans(q_lens)
    b, w, n_pages = len(q_lens), 3, 24
    kp, vp = _pools(r, n_pages, kh, int8)
    tables = _tables(r, b, w, n_pages)
    q, kn, vn = _normal(r, total, h, HD), _normal(r, total, kh, HD), _normal(r, total, kh, HD)
    scales = {}
    if int8:
        kn[qs[3]], vn[qs[3]] = _ties(r, (kh, HD)), _ties(r, (kh, HD))
        scales = dict(kscale=_scales(r, (b, kh, HD), 3),
                      vscale=_scales(r, (b, kh, HD), 3))
    x = dict(q=q, k_new=kn, v_new=vn, k_pages=kp, v_pages=vp,
             page_tables=tables, kv_lens=np.asarray(bases, np.int32),
             q_starts=qs, q_lens=np.asarray(q_lens, np.int32))
    want, j_kp, j_vp = ragged_spans_pallas(
        **{k: jnp.asarray(v) for k, v in x.items()}, interpret=True,
        **{k: jnp.asarray(v) for k, v in scales.items()})
    t = {k: t_(v.copy()) for k, v in x.items()}
    got = tpa.ragged_spans(**t, **{k: t_(v) for k, v in scales.items()}).numpy()
    in_span = np.zeros(total, bool)
    for s, n in zip(qs, q_lens):
        in_span[s:s + n] = True
    np.testing.assert_allclose(got[in_span], np.asarray(want)[in_span], atol=ATOL)
    assert not got[~in_span].any()
    upto = np.asarray(bases) + np.asarray(q_lens)
    for mine, pal in ((t["k_pages"], j_kp), (t["v_pages"], j_vp)):
        for row, u in enumerate(upto):
            a = mine.numpy()[tables[row]].transpose(0, 2, 1, 3).reshape(-1, kh, HD)[:u]
            c = np.asarray(pal)[tables[row]].transpose(0, 2, 1, 3).reshape(-1, kh, HD)[:u]
            np.testing.assert_array_equal(a, c)


def test_decode_split_halves_for_few_kv_groups():
    """The decode split comes from shapes alone: 256 tokens for bench-8b's
    and gemma-7b's 8 rows x 8 or 16 kv heads, 128 for gemma-2b's 8 rows x
    one kv head (more blocks for the card), a multiple of the kernel's
    32-token tile either way."""
    assert tpa.decode_split(8, 8) == tpa.decode_split(8, 16) == tpa.DECODE_SPLIT
    assert tpa.decode_split(8, 1) == tpa.DECODE_SPLIT // 2
    assert all(tpa.decode_split(b, k) % 32 == 0 for b in (1, 8) for k in (1, 8))


# ----------------------------------------------------------------- (b)

# Gemma's differences (tied embeddings, embed_scale, tanh-GELU, the
# (1 + w) norm at eps 1e-6, rope theta 1e4) with an explicit head_dim
GEMMA_HD256 = dict(vocab_size=300, dim=128, n_layers=2, n_heads=2,
                   n_kv_heads=1, hidden_dim=160, max_seq_len=128,
                   dtype="float32", head_dim=HD, tie_embeddings=True,
                   embed_scale=True, activation="gelu", norm_eps=1e-6,
                   rope_theta=10000.0)
N_POOL, T = 8, 4


def _route(route, r):
    """One dispatch of each kind as the scheduler issues it: keyword
    arguments of ``forward_paged`` (numpy) besides the pools."""
    if route == "fresh":
        n = 20
        return dict(tokens=r.integers(3, 300, (1, n)), positions=np.arange(n)[None],
                    page_tables=np.array([[3, 5]]), kv_lens=np.array([n]),
                    last_pos=np.array([n - 1]))
    if route == "packed":
        lens = [12, 18]
        pages = [[2], [4, 6]]
        return dict(
            tokens=r.integers(3, 300, (1, sum(lens))),
            positions=np.concatenate([np.arange(n) for n in lens])[None],
            page_tables=np.zeros((1, 1), np.int64),
            kv_lens=np.array([sum(lens)]),
            token_pages=np.concatenate([np.asarray(p)[np.arange(n) // 16]
                                        for p, n in zip(pages, lens)])[None],
            segment_ids=np.concatenate([np.full(n, i) for i, n in enumerate(lens)])[None],
            packed_last_idx=np.cumsum(lens) - 1)
    lens = np.array([5, 17, 33])
    tables = np.array([[1, 0, 0], [2, 3, 0], [4, 5, 6]])
    if route == "decode":
        return dict(tokens=r.integers(3, 300, (3, 1)), positions=(lens - 1)[:, None],
                    page_tables=tables, kv_lens=lens)
    if route == "verify":  # T tokens a row after its context; kv_lens counts them
        return dict(tokens=r.integers(3, 300, (3, T)),
                    positions=lens[:, None] + np.arange(T), page_tables=tables,
                    kv_lens=lens + T, multi_decode=True)
    # span: a decode row, a continuation span crossing a page and a base-0
    # span, each inside its row's table
    q_lens, base = np.array([1, 9, 21]), np.array([4, 20, 0])
    qs, total = tpa.pack_spans(q_lens)
    row_flat = np.full((total,), 3)
    for i, (s, n) in enumerate(zip(qs, q_lens)):
        row_flat[s:s + n] = i
    rf = np.clip(row_flat, 0, 2)
    return dict(tokens=r.integers(3, 300, (1, total)),
                positions=np.clip(base[rf] + np.arange(total) - qs[rf], 0, 127)[None],
                page_tables=tables, kv_lens=base,
                packed_last_idx=qs + q_lens - 1, spans=(qs, q_lens, row_flat))


@pytest.mark.parametrize("kv", [1, 2])
@pytest.mark.parametrize("route", ["fresh", "packed", "decode", "span", "verify"])
def test_forward_paged_gemma_hd256_matches_jax(route, kv):
    cfg = dict(GEMMA_HD256, n_kv_heads=kv)
    jcfg, tcfg = JModelConfig(name="g", **cfg), TModelConfig(name="g", **cfg)
    assert tcfg.hd == HD != tcfg.dim // tcfg.n_heads
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(5)))
    r = np.random.default_rng(6)
    for name in ("ln_attn", "ln_mlp"):  # exercise the (1 + w) norm
        sc = tree["layers"][name]["scale"]
        tree["layers"][name]["scale"] = (0.1 * r.standard_normal(sc.shape)).astype(np.float32)
    shape = (jcfg.n_layers * N_POOL, kv, 16, HD)
    kp, vp = _normal(r, *shape), _normal(r, *shape)
    x = _route(route, r)
    flags = {k: x.pop(k) for k in ("multi_decode",) if k in x}
    spans = x.pop("spans", None)
    ints = {k: np.asarray(v).astype(np.int32) for k, v in x.items()}
    extra = ("token_pages", "segment_ids", "packed_last_idx", "last_pos")
    j = {k: jnp.asarray(v) for k, v in ints.items()}
    j_logits, j_kp, j_vp = j_forward_paged(
        jax.tree.map(jnp.asarray, tree), jcfg, j["tokens"], j["positions"],
        jnp.asarray(kp), jnp.asarray(vp), j["page_tables"], j["kv_lens"],
        jcfg.max_seq_len, **flags,
        **({} if spans is None else
           {"spans": tuple(jnp.asarray(np.asarray(a, np.int32)) for a in spans)}),
        **{k: j[k] for k in extra if k in j})
    t_kp, t_vp = t_(kp.copy()), t_(vp.copy())
    t_logits = t_forward_paged(
        params_from_jax(tree, tcfg), tcfg, t_(x["tokens"]), t_(x["positions"]),
        t_kp, t_vp, t_(x["page_tables"]), t_(ints["kv_lens"]), tcfg.max_seq_len,
        **flags,
        **({} if spans is None else
           {"spans": tuple(t_(np.asarray(a, np.int32)) for a in spans)}),
        **{k: t_(np.asarray(x[k])) for k in extra if k in x})
    assert t_logits.shape == j_logits.shape
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4)
    # the XLA span twin parks out-of-span writes on each layer's null page
    keep = np.ones(shape[0], bool)
    if spans is not None:
        keep[::N_POOL] = False
    np.testing.assert_allclose(t_kp.numpy()[keep], np.asarray(j_kp)[keep], atol=1e-5)
    np.testing.assert_allclose(t_vp.numpy()[keep], np.asarray(j_vp)[keep], atol=1e-5)


# ----------------------------------------------------------------- (c)


def test_engine_default_path_at_hd256_matches_jax_loop():
    """``test_torch_engine.check_default_path`` (preemption, mixed steps,
    continuation chunks, prefix hits) at the hd-256 Gemma-style model."""
    check_default_path(GEMMA_HD256, name="gemma-hd256")
