"""Port parity, int8: weights and KV pages.

(a) ``lmrs_tpu_torch/ops/quant.py`` against ``lmrs_tpu/ops/quant.py``:
    exactly equal int8 values and scales (constructed ``.5`` ties included:
    both round half to even), ``qmatmul`` against ``qeinsum`` within 1e-5.
(b) The int8 plain versions of the three writing kernels against the JAX
    Pallas kernels in interpret mode and their XLA twins: outputs within
    2e-3 (f32; the Pallas kernel folds the scales into q and the output,
    the plain versions dequantize the pages — the reference's own int8
    kernel test uses 2e-3), int8 pools bit-exact outside the null page.
(c) ``forward_paged`` with quantized weights and int8 pools against the JAX
    ``forward_paged`` for each dispatch kind: logits within 1e-3, scale
    buffers rtol 1e-5 (a scale is max|k| / 127 of K that the two packages'
    f32 products sum in another order: up to 1.6e-6 relative found), int8
    pools equal but for entries one apart where those products fall on two
    sides of a rounding boundary (share asserted below 1e-3; none found on
    these inputs).
(d) The int8 engine against ``JaxEngine`` with the same config and weights:
    identical greedy texts through packed prefill, mixed steps and
    preemptions; int8 + linear speculation equals int8 without it.
(e) Config, CLI and the wrappers' refusals.

The CUDA int8 kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.config import EngineConfig as JEngineConfig
from lmrs_tpu.config import ModelConfig as JModelConfig
from lmrs_tpu.engine.api import GenerationRequest as JRequest
from lmrs_tpu.engine.jax_engine import JaxEngine
from lmrs_tpu.models.transformer import forward_paged as j_forward_paged
from lmrs_tpu.models.transformer import init_params as j_init_params
from lmrs_tpu.ops import quant as jq
from lmrs_tpu.ops.paged_attention import (paged_decode_multi_xla,
                                          paged_decode_pallas_fused,
                                          paged_decode_pallas_multi,
                                          paged_decode_xla,
                                          ragged_spans_pallas,
                                          ragged_spans_xla)
from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.engine.api import GenerationRequest
from lmrs_tpu_torch.engine.torch_engine import TorchEngine
from lmrs_tpu_torch.models.convert import params_from_jax, params_to_jax
from lmrs_tpu_torch.models.transformer import forward_paged as t_forward_paged
from lmrs_tpu_torch.ops import paged_attention as tpa
from lmrs_tpu_torch.ops import quant as tq

from conftest import make_segments
from test_torch_engine import CFG, IdTokenizer

ATOL = 2e-3
LOGIT_ATOL = 1e-3
SCALE_RTOL = 1e-5
PS = 32
# the engine tests' model with the tokenizer's vocabulary, so both
# packages' samplers see the same ids (the port never samples ids the
# tokenizer cannot decode)
ECFG = dict(CFG, vocab_size=IdTokenizer.vocab_size)

t_ = torch.from_numpy


def _tie_scales(r, shape, tie_rows):
    """Random scales, with ``tie_rows`` set to a power of two so that new
    K/V values built as half-integer multiples divide to exact ``.5``."""
    s = r.uniform(0.01, 0.05, shape).astype(np.float32)
    s[tie_rows] = 2.0 ** -5
    return s


def _ties(r, shape):
    """Values (m + 0.5) * 2^-5, m in [-140, 139]: every x / 2^-5 is a tie,
    and some saturate past +-127."""
    return ((r.integers(-140, 140, shape) + 0.5) * 2.0 ** -5).astype(np.float32)


# ----------------------------------------------------------------- (a)


def test_kv_quant_matches_jax_exactly():
    r = np.random.default_rng(0)
    kv = (r.standard_normal((3, 16, 2, 8)) * 4.0).astype(np.float32)
    kv[1] = _ties(r, kv[1].shape)  # every entry of row 1 is an exact tie
    valid = np.arange(16)[None, :] < np.array([16, 7, 1])[:, None]
    s_j = jq.kv_scale_from(jnp.asarray(kv), jnp.asarray(valid))
    s_t = tq.kv_scale_from(t_(kv), t_(valid))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    tie_s = np.full((3, 2, 8), 2.0 ** -5, np.float32)
    for scale in (np.array(s_j), tie_s):
        want = np.asarray(jq.kv_quant(jnp.asarray(kv), jnp.asarray(scale)))
        got = tq.kv_quant(t_(kv), t_(scale)).numpy()
        np.testing.assert_array_equal(got, want)
        tok = np.broadcast_to(scale[:, None], kv.shape).copy()
        np.testing.assert_array_equal(
            tq.kv_quant_tokens(t_(kv), t_(tok)).numpy(),
            np.asarray(jq.kv_quant_tokens(jnp.asarray(kv), jnp.asarray(tok))))
    got = tq.kv_quant(t_(kv), t_(tie_s)).numpy()[1]
    # half to even: 2.5 -> 2, 3.5 -> 4, -2.5 -> -2; beyond 127 saturates
    m = kv[1] / 2.0 ** -5
    np.testing.assert_array_equal(got, np.clip(np.round(m), -127, 127))
    assert (np.abs(m) > 127).any() and (np.round(m) != np.floor(m + 0.5)).any()
    q8 = tq.kv_quant(t_(kv), s_t)
    np.testing.assert_allclose(
        tq.kv_dequant(q8, s_t, torch.float32).numpy(),
        np.asarray(jq.kv_dequant(jnp.asarray(q8.numpy()), s_j, jnp.float32)))


def test_segment_scales_match_segment_max():
    """The packed/span scale rule: per segment max over its own tokens,
    pads (segment n) dropped, empty segments floored at 1e-8."""
    r = np.random.default_rng(1)
    kv = r.standard_normal((20, 2, 8)).astype(np.float32)
    seg = np.array([0] * 7 + [2] * 9 + [3] * 4)  # segment 1 empty, 3 = pad
    a = jnp.abs(jnp.asarray(kv))
    want = jnp.maximum(jax.ops.segment_max(a, jnp.asarray(seg),
                                           num_segments=4)[:3] / 127.0, 1e-8)
    got = tq.segment_scales(t_(kv), t_(seg), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[1].max()) == np.float32(1e-8)


@pytest.fixture(scope="module")
def qtree():
    """The engine tests' f32 model, quantized by the JAX package, with its
    f32 source tree."""
    jcfg = JModelConfig(name="t", **ECFG)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(7)))
    return tree, jax.tree.map(np.asarray, jq.quantize_params(tree))


def test_quantize_params_matches_jax_fused_layout(qtree):
    """Every projection (wq/wk/wv fused as wqkv, wo, w_gate/w_up fused,
    w_down, lm_head): the port quantizing its own fused layout gives the
    int8 values and scales of the JAX tree carried across, exactly; the
    embedding and norms stay f32; the carry back is exact too."""
    tree, jtree = qtree
    tcfg = TModelConfig(name="t", **ECFG)
    mine = tq.quantize_params(params_from_jax(tree, tcfg))
    theirs = params_from_jax(jtree, tcfg)
    names = sorted(tq.QUANT_NAMES)
    for lp_m, lp_t in zip(mine["layers"], theirs["layers"]):
        for n in names:
            assert lp_m[n]["q"].dtype == torch.int8
            assert lp_m[n]["s"].shape == (1, lp_m[n]["q"].shape[1])
            for k in ("q", "s"):
                assert torch.equal(lp_m[n][k], lp_t[n][k]), n
        assert lp_m["ln_attn"].dtype == torch.float32
    for k in ("q", "s"):
        assert torch.equal(mine["lm_head"][k], theirs["lm_head"][k])
    assert torch.equal(mine["embed"], theirs["embed"])
    back = params_to_jax(mine, tcfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)


def test_qmatmul_matches_qeinsum(qtree):
    tree, jtree = qtree
    tcfg = TModelConfig(name="t", **ECFG)
    p = params_from_jax(jtree, tcfg)
    x = np.random.default_rng(2).standard_normal((2, 3, tcfg.dim)).astype(np.float32)
    want = jq.qeinsum("bsd,dv->bsv", jnp.asarray(x), jtree["lm_head"]["weight"],
                      jnp.float32)
    np.testing.assert_allclose(tq.qmatmul(t_(x), p["lm_head"]).numpy(),
                               np.asarray(want), atol=1e-5)
    # the fused q/k/v product equals the three reference products
    att = {k: jax.tree.map(lambda a: a[0], v) for k, v in jtree["layers"]["attn"].items()}
    parts = [jq.qeinsum("bsd,dhk->bshk", jnp.asarray(x), att[n], jnp.float32)
             for n in ("wq", "wk", "wv")]
    want = np.concatenate([np.asarray(a).reshape(2, 3, -1) for a in parts], -1)
    np.testing.assert_allclose(tq.qmatmul(t_(x), p["layers"][0]["wqkv"]).numpy(),
                               want, atol=1e-5)


# ----------------------------------------------------------------- (b)


def _int8_pools(r, n_pages, kh, hd):
    return (r.integers(-127, 128, (n_pages, kh, PS, hd)).astype(np.int8),
            r.integers(-127, 128, (n_pages, kh, PS, hd)).astype(np.int8))


def test_decode_int8_ref_matches_pallas_and_xla():
    """3 rows (mid-page, a page boundary, the table's full width); row 1's
    new K/V are exact ties of x / s.  Outputs and int8 pools."""
    r = np.random.default_rng(3)
    b, h, kh, hd, n_pages, w = 3, 4, 2, 128, 16, 3
    kp, vp = _int8_pools(r, n_pages, kh, hd)
    tables = (r.permutation(n_pages - 1)[: b * w].reshape(b, w) + 1).astype(np.int32)
    lens = np.asarray([PS * 2 + 17, PS, PS * 3], np.int32)
    q = r.standard_normal((b, h, hd)).astype(np.float32)
    kn = r.standard_normal((b, kh, hd)).astype(np.float32)
    vn = r.standard_normal((b, kh, hd)).astype(np.float32)
    kn[1], vn[1] = _ties(r, (kh, hd)), _ties(r, (kh, hd))
    ks, vs = _tie_scales(r, (b, kh, hd), 1), _tie_scales(r, (b, kh, hd), 1)
    j = [jnp.asarray(a) for a in (q, kn, vn, kp, vp, tables, lens)]
    want, j_kp, j_vp = paged_decode_pallas_fused(
        *j, interpret=True, kscale=jnp.asarray(ks), vscale=jnp.asarray(vs))
    tk, tv = t_(kp.copy()), t_(vp.copy())
    got = tpa.paged_decode_fused(t_(q), t_(kn), t_(vn), tk, tv, t_(tables),
                                 t_(lens), kscale=t_(ks), vscale=t_(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(j_kp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(j_vp))
    # the XLA twin over the port's written pools
    twin = paged_decode_xla(jnp.asarray(q), jnp.asarray(tk.numpy()),
                            jnp.asarray(tv.numpy()), j[5], j[6],
                            kv_scales=(jnp.asarray(ks), jnp.asarray(vs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(twin), atol=ATOL)
    assert tpa.paged_decode_fused.launches_int8 == 0  # CPU: plain version


def test_multi_int8_ref_matches_pallas_and_xla():
    """A verify batch of 3 rows x T=5: row 0 straddles a page, row 1's
    tokens are exact ties, row 2 runs past ``max_pos`` = 90 (tokens 88..92:
    two written, three skipped).  Outputs; pools outside the null page."""
    r = np.random.default_rng(4)
    b, t, h, kh, hd, n_pages, w, max_pos = 3, 5, 4, 2, 128, 16, 3, 90
    kp, vp = _int8_pools(r, n_pages, kh, hd)
    tables = (r.permutation(n_pages - 1)[: b * w].reshape(b, w) + 1).astype(np.int32)
    lens = np.asarray([PS + 3, 40, 93], np.int32)  # counting the T tokens
    q = r.standard_normal((b, t, h, hd)).astype(np.float32)
    kn = r.standard_normal((b, t, kh, hd)).astype(np.float32)
    vn = r.standard_normal((b, t, kh, hd)).astype(np.float32)
    kn[1], vn[1] = _ties(r, (t, kh, hd)), _ties(r, (t, kh, hd))
    ks, vs = _tie_scales(r, (b, kh, hd), 1), _tie_scales(r, (b, kh, hd), 1)
    j = [jnp.asarray(a) for a in (q, kn, vn, kp, vp, tables, lens)]
    js = dict(kscale=jnp.asarray(ks), vscale=jnp.asarray(vs))
    want, j_kp, j_vp = paged_decode_pallas_multi(*j, interpret=True,
                                                 max_pos=max_pos, **js)
    twin, x_kp, x_vp = paged_decode_multi_xla(
        *j, max_pos=max_pos, kv_scales=(js["kscale"], js["vscale"]))
    tk, tv = t_(kp.copy()), t_(vp.copy())
    got = tpa.paged_decode_multi(t_(q), t_(kn), t_(vn), tk, tv, t_(tables),
                                 t_(lens), max_pos, kscale=t_(ks),
                                 vscale=t_(vs)).numpy()
    # row 2's queries past max_pos see the real prefix only: all rows agree
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(twin), atol=ATOL)
    for mine, *refs in ((tk, j_kp, x_kp), (tv, j_vp, x_vp)):
        for ref in refs:
            np.testing.assert_array_equal(mine.numpy()[1:], np.asarray(ref)[1:])
    written = (tk.numpy()[tables[2, 2]] != kp[tables[2, 2]]).any(axis=(0, 2))
    assert list(np.flatnonzero(written)) == [88 % PS, 89 % PS]


def test_spans_int8_ref_matches_pallas_and_xla():
    """Decode rows, a base-0 span (a prompt's first tokens, its own row's
    scales) and a continuation span; each flat token quantizes with its own
    row's scales; row 3's tokens are exact ties.  Outputs on in-span
    tokens; pools within each row's written window (the Pallas kernel also
    writes tile padding past it) and, against the XLA twin, outside the
    null page."""
    r = np.random.default_rng(5)
    q_lens, bases = [1, 21, 9, 1, 0], [40, 0, 50, 7, 0]
    h, kh, hd, n_pages, w = 4, 2, 128, 24, 3
    qs, total = tpa.pack_spans(q_lens)
    b = len(q_lens)
    row_flat = np.full((total,), b, np.int32)
    for i, (s, n) in enumerate(zip(qs, q_lens)):
        row_flat[s:s + n] = i
    kp, vp = _int8_pools(r, n_pages, kh, hd)
    tables = (r.permutation(n_pages - 1)[: b * w].reshape(b, w) + 1).astype(np.int32)
    q = r.standard_normal((total, h, hd)).astype(np.float32)
    kn = r.standard_normal((total, kh, hd)).astype(np.float32)
    vn = r.standard_normal((total, kh, hd)).astype(np.float32)
    tie = qs[3]
    kn[tie], vn[tie] = _ties(r, (kh, hd)), _ties(r, (kh, hd))
    ks, vs = _tie_scales(r, (b, kh, hd), 3), _tie_scales(r, (b, kh, hd), 3)
    x = dict(q=q, k_new=kn, v_new=vn, k_pages=kp, v_pages=vp,
             page_tables=tables, kv_lens=np.asarray(bases, np.int32),
             q_starts=qs, q_lens=np.asarray(q_lens, np.int32))
    j = {k: jnp.asarray(v) for k, v in x.items()}
    js = dict(kscale=jnp.asarray(ks), vscale=jnp.asarray(vs))
    want, j_kp, j_vp = ragged_spans_pallas(**j, interpret=True, **js)
    twin, x_kp, x_vp = ragged_spans_xla(**j, row_flat=jnp.asarray(row_flat),
                                        kv_scales=(js["kscale"], js["vscale"]))
    t = {k: t_(v.copy()) for k, v in x.items()}
    got = tpa.ragged_spans(**t, kscale=t_(ks), vscale=t_(vs)).numpy()
    in_span = row_flat < b
    np.testing.assert_allclose(got[in_span], np.asarray(want)[in_span], atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(twin), atol=ATOL)
    upto = np.asarray(bases) + np.asarray(q_lens)
    for mine, pal, xla in ((t["k_pages"], j_kp, x_kp), (t["v_pages"], j_vp, x_vp)):
        mine = mine.numpy()
        np.testing.assert_array_equal(mine[1:], np.asarray(xla)[1:])
        for row, u in enumerate(upto):
            a = mine[tables[row]].transpose(0, 2, 1, 3).reshape(-1, kh, hd)[:u]
            c = np.asarray(pal)[tables[row]].transpose(0, 2, 1, 3).reshape(-1, kh, hd)[:u]
            np.testing.assert_array_equal(a, c)


# ----------------------------------------------------------------- (c)

N_POOL, BS = 12, 3  # pages per layer, scale-buffer slots


def _dispatch(mode, r):
    """One dispatch of each kind as the scheduler issues it: (tokens,
    positions, tables, kv_lens, keyword arguments for both packages)."""
    if mode == "fresh":  # 2 prompts (one padded) onto slots 2 and 0
        lens = np.array([40, 23], np.int32)
        return (r.integers(3, 259, (2, 40)), np.tile(np.arange(40), (2, 1)),
                np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32), lens,
                dict(last_pos=lens - 1, scale_rows=np.array([2, 0], np.int32)))
    if mode == "packed":  # 2 segments onto slots 1 and 2, + 3 pad tokens
        n = [30, 25]
        seg = np.array([0] * n[0] + [1] * n[1] + [-1] * 3, np.int32)[None]
        pos = np.concatenate([np.arange(n[0]), np.arange(n[1]), [0] * 3])[None]
        pages = np.concatenate([np.array([5, 6])[np.arange(n[0]) // PS],
                                [7] * n[1], [0] * 3])[None].astype(np.int32)
        return (r.integers(3, 259, (1, 58)), pos, np.zeros((1, 1), np.int32),
                np.array([58], np.int32),
                dict(token_pages=pages, segment_ids=seg,
                     packed_last_idx=np.array([29, 54], np.int32),
                     scale_rows=np.array([1, 2], np.int32)))
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 0]], np.int32)
    if mode == "decode":  # mid-page, page boundary, two full pages
        lens = np.array([45, 33, 64], np.int32)
        return r.integers(3, 259, (3, 1)), (lens - 1)[:, None], tables, lens, {}
    if mode == "multi":  # T = 4; row 2 overhangs max_seq_len (128)
        ctx = np.array([30, 60, 125])
        pos = np.minimum(ctx[:, None] + np.arange(4), 127)
        return (r.integers(3, 259, (3, 4)), pos, tables,
                (ctx + 4).astype(np.int32), dict(multi_decode=True))
    # spans: a decode row, a base-0 span (owns its slot's scales) and a
    # continuation span (reuses its slot's frozen scales)
    q_lens, base = np.array([1, 21, 9], np.int32), np.array([40, 0, 50], np.int32)
    qs, total = tpa.pack_spans(q_lens)
    row_flat = np.full((total,), 3, np.int32)
    for i, (s_, n) in enumerate(zip(qs, q_lens)):
        row_flat[s_:s_ + n] = i
    rf = np.clip(row_flat, 0, 2)
    pos = np.clip(base[rf] + np.arange(total) - qs[rf], 0, 127)[None]
    gidx = (qs + q_lens - 1).astype(np.int32)
    return (r.integers(3, 259, (1, total)), pos, tables, base,
            dict(packed_last_idx=gidx, spans=(qs, q_lens, row_flat)))


@pytest.mark.parametrize("mode", ["fresh", "packed", "decode", "spans", "multi"])
def test_forward_paged_int8_matches_jax(qtree, mode):
    """Quantized weights and int8 pools through both packages'
    ``forward_paged`` (the JAX one on its XLA routes): logits, the scale
    buffers after the dispatch (owners rewritten, the rest untouched) and
    the int8 pools."""
    _, jtree = qtree
    jcfg, tcfg = JModelConfig(name="t", **ECFG), TModelConfig(name="t", **ECFG)
    r = np.random.default_rng(10)
    L, K, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.hd
    shape = (L * N_POOL, K, PS, hd)
    kp = r.integers(-127, 128, shape).astype(np.int8)
    vp = r.integers(-127, 128, shape).astype(np.int8)
    ksc = r.uniform(0.01, 0.05, (L, BS, K, hd)).astype(np.float32)
    vsc = r.uniform(0.01, 0.05, (L, BS, K, hd)).astype(np.float32)
    tokens, pos, tables, lens, kw = _dispatch(mode, r)
    j_kw = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
                else v if isinstance(v, bool) else jnp.asarray(v))
            for k, v in kw.items()}
    j_logits, j_kp, j_vp, (j_ks, j_vs) = j_forward_paged(
        jax.tree.map(jnp.asarray, jtree), jcfg, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), jcfg.max_seq_len,
        kv_scales=(jnp.asarray(ksc), jnp.asarray(vsc)), **j_kw)
    t_kw = {k: (tuple(t_(a) for a in v) if isinstance(v, tuple)
                else v if isinstance(v, bool) else t_(v)) for k, v in kw.items()}
    tk, tv, tks, tvs = (t_(a.copy()) for a in (kp, vp, ksc, vsc))
    t_logits = t_forward_paged(
        params_from_jax(jtree, tcfg), tcfg, t_(tokens).long(), t_(pos),
        tk, tv, t_(tables), t_(lens), tcfg.max_seq_len, kv_scales=(tks, tvs),
        **t_kw)
    rows = slice(0, 2) if mode == "multi" else slice(None)  # row 2 overhangs
    np.testing.assert_allclose(t_logits.numpy()[rows], np.asarray(j_logits)[rows],
                               atol=LOGIT_ATOL)
    for mine, theirs, before in ((tks, j_ks, ksc), (tvs, j_vs, vsc)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=SCALE_RTOL)
        owners = {"fresh": [2, 0], "packed": [1, 2], "spans": [1]}.get(mode, [])
        kept = [s_ for s_ in range(BS) if s_ not in owners]
        np.testing.assert_array_equal(mine.numpy()[:, kept], before[:, kept])
        assert not np.array_equal(mine.numpy()[:, owners], before[:, owners]) or not owners
    keep = np.ones(shape[:3], bool)
    keep[::N_POOL] = False  # each layer's null page: the twins park writes there
    if mode == "fresh":
        # row 1's pad tokens (positions 23..39, pages 3 and 4): the port's
        # attention zeroes rows past a length (ROADMAP Queue C), so from
        # layer 1 on their K/V differ; nothing ever reads them
        for li in range(L):
            keep[li * N_POOL + 3, :, 23:] = keep[li * N_POOL + 4, :, :8] = False
    for mine, theirs, before in ((tk, j_kp, kp), (tv, j_vp, vp)):
        d = np.abs(mine.numpy()[keep].astype(np.int32)
                   - np.asarray(theirs)[keep].astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, ((d > 0).mean(), d.max())
        assert (mine.numpy() != before).any()  # the dispatch wrote the pool


# ----------------------------------------------------------------- (d)

PREAMBLE = "You are summarizing. Keep facts!\n"
BODIES = ["alpha beta gamma delta", "the quick brown fox", "x" * 20,
          "0123456789abcdefghij"]


def _port_engine(tree, **kw):
    tcfg = TModelConfig(name="t", **ECFG)
    return TorchEngine(EngineConfig(**kw), tcfg, device="cpu",
                       params=params_from_jax(tree, tcfg),
                       tokenizer=IdTokenizer())


def test_int8_engine_matches_jax_engine(qtree, caplog):
    """2 slots, 32-token pages and a 6-page pool (the floor: one full
    sequence + the null page): the first wave prefills packed, page growth
    preempts (the continuation re-prefills and fixes new scales), later
    prompts prefill through mixed steps.  Same weights (the f32 tree, each
    engine quantizing it), same config: identical greedy texts.  The prefix
    cache is off under int8 KV, and the audit is clean."""
    tree, _ = qtree
    kw = dict(max_batch_slots=2, page_size=PS, num_pages=6, decode_block=4,
              max_tokens=24, prefill_chunk=64, mixed_token_budget=32,
              quantize="int8", kv_quantize="int8")
    prompts = [PREAMBLE + b for b in BODIES]
    jeng = JaxEngine(JEngineConfig(backend="jax", scheduler="continuous",
                                   seed=0, retry_delay=0.0, **kw),
                     JModelConfig(name="t", **ECFG),
                     params=jax.tree.map(jnp.asarray, tree),
                     tokenizer=IdTokenizer())
    want = jeng.generate_batch([JRequest(prompt=p, request_id=i,
                                         temperature=0.0)
                                for i, p in enumerate(prompts)])
    jeng.shutdown()
    with caplog.at_level("INFO", logger="lmrs_torch.scheduler"):
        eng = _port_engine(tree, **kw)
    assert "prefix cache disabled" in caplog.text
    assert eng._scheduler.cache.k.dtype == torch.int8
    assert eng._scheduler.kv_scales[0].shape == (2, 2, 1, ECFG["dim"] // 2)
    got = eng.generate_batch([GenerationRequest(prompt=p, request_id=i,
                                                temperature=0.0)
                              for i, p in enumerate(prompts)])
    m = eng.engine_metrics()
    assert eng.audit() == []
    assert m["packed_prefill_dispatches"] >= 1 and m["preemptions"] >= 1
    assert m["mixed_batch"]["dispatches"] >= 1
    assert "prefix_cache" not in m and eng._scheduler.counters["prefix_queries"] == 0
    assert all(r.error is None and w.error is None for r, w in zip(got, want))
    assert [r.text for r in got] == [w.text for w in want]


def test_int8_speculation_matches_plain_int8(qtree):
    """Linear speculation over int8 pools emits what plain int8 decode
    emits: drafts are quantized with the slot's frozen scales."""
    tree, _ = qtree
    reqs = [GenerationRequest(prompt="the cat sat on the mat the cat sat " * 2,
                              request_id=i, temperature=0.0) for i in range(2)]
    texts = []
    for k in (0, 4):
        eng = _port_engine(tree, max_batch_slots=2, page_size=PS,
                           num_pages=40, decode_block=10, max_tokens=16,
                           mixed_batch=False, speculate_k=k,
                           quantize="int8", kv_quantize="int8")
        res = eng.generate_batch(list(reqs))
        assert eng.audit() == [] and all(r.error is None for r in res)
        texts.append([r.text for r in res])
    assert eng.engine_metrics()["spec_accepted_tokens"] > 0
    assert texts[1] == texts[0]


# ----------------------------------------------------------------- (e)


def test_int8_config_and_cli(tmp_path):
    from lmrs_tpu_torch.cli import build_parser, config_from_args, main

    with pytest.raises(ValueError, match="kv_quantize"):
        EngineConfig(kv_quantize="int4")
    with pytest.raises(ValueError, match="quantize"):
        EngineConfig(quantize="fp8")
    with pytest.raises(ValueError, match="page_size"):
        TorchEngine(EngineConfig(page_size=16, kv_quantize="int8"),
                    TModelConfig(name="t", **ECFG), device="cpu")
    args = build_parser().parse_args(["--input", "x.json", "--quantize", "int8",
                                      "--kv-quantize", "int8"])
    eng = config_from_args(args).engine
    assert (eng.quantize, eng.kv_quantize) == ("int8", "int8")
    src = tmp_path / "t.json"
    src.write_text(json.dumps({"segments": make_segments(10)}))
    out = tmp_path / "s.txt"
    rc = main(["--input", str(src), "--output", str(out), "--model",
               "bench-smoke", "--tokenizer", "byte", "--device", "cpu",
               "--max-tokens", "4", "--quantize", "int8", "--kv-quantize",
               "int8", "--report", "-q"])
    assert rc == 0 and out.read_text(encoding="utf-8")
    report = json.loads((tmp_path / "s.txt.report.json").read_text())
    assert report["failed_requests"] == 0
    assert "prefix_cache" not in report["engine_metrics"]


@pytest.mark.parametrize("op", ["decode", "multi", "spans"])
def test_wrappers_refuse_mismatched_int8(op):
    """An int8 pool without scales, scales with a float pool, or one of
    the two scale tensors alone: every writing wrapper raises (the
    reference asserts the same)."""
    f = torch.zeros
    b, t, h, kh, hd = 2, 3, 4, 2, 64
    pools8 = (f(4, kh, PS, hd, dtype=torch.int8),) * 2
    poolsf = (f(4, kh, PS, hd),) * 2
    sc = (torch.ones(b, kh, hd),) * 2
    tables, lens = torch.ones(b, 1, dtype=torch.int32), torch.ones(b, dtype=torch.int32)
    if op == "decode":
        def call(pools, ks, vs):
            return tpa.paged_decode_fused(f(b, h, hd), f(b, kh, hd), f(b, kh, hd),
                                          *pools, tables, lens, ks, vs)
    elif op == "multi":
        def call(pools, ks, vs):
            return tpa.paged_decode_multi(f(b, t, h, hd), f(b, t, kh, hd),
                                          f(b, t, kh, hd), *pools, tables,
                                          lens + t, None, ks, vs)
    else:
        def call(pools, ks, vs):
            return tpa.ragged_spans(f(16, h, hd), f(16, kh, hd), f(16, kh, hd),
                                    *pools, tables, lens,
                                    torch.tensor([0, 8], dtype=torch.int32),
                                    lens, None, ks, vs)
    for pools, ks, vs in ((pools8, None, None), (poolsf, *sc), (pools8, sc[0], None)):
        with pytest.raises(ValueError, match="kscale|int8"):
            call(pools, ks, vs)
    assert call(pools8, *sc).shape[-1] == hd  # the matched pair runs
