"""Port parity, ragged spans: the plain PyTorch version of the port's span
kernel (``ragged_spans_ref``) against the JAX package's Pallas
``ragged_spans_pallas`` (interpret mode, one call) and its XLA twin
``ragged_spans_xla``, and the port's ``forward_paged(spans=...)`` against
the JAX one, on the same numpy inputs.  Tolerance: f32 atol 2e-5 (the
reference's own span tests); pool contents exact.  The CUDA kernel itself
is held against this plain version on the card by
``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.config import ModelConfig as JModelConfig
from lmrs_tpu.models.transformer import forward_paged as j_forward_paged
from lmrs_tpu.models.transformer import init_params as j_init_params
from lmrs_tpu.ops.paged_attention import pack_spans as j_pack_spans
from lmrs_tpu.ops.paged_attention import ragged_spans_pallas, ragged_spans_xla
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.models.convert import params_from_jax
from lmrs_tpu_torch.models.transformer import forward_paged as t_forward_paged
from lmrs_tpu_torch.ops import paged_attention as tpa

ATOL = 2e-5
PS = 16


def _fixture(seed, q_lens, bases, h=8, kh=2, hd=128, n_pages=32, width=4):
    """Flat span buffers (random in the alignment padding too, so parity
    proves the padding is masked) + pools + disjoint per-row tables."""
    r = np.random.default_rng(seed)
    qs, total = tpa.pack_spans(q_lens)
    j_qs, j_total = j_pack_spans(np.asarray(q_lens))
    assert total == j_total and np.array_equal(qs, j_qs)
    b = len(q_lens)
    row_flat = np.full((total,), b, np.int32)
    for i, (s, n) in enumerate(zip(qs, q_lens)):
        row_flat[s:s + n] = i
    f32 = np.float32
    return dict(
        q=r.standard_normal((total, h, hd)).astype(f32),
        k_new=r.standard_normal((total, kh, hd)).astype(f32),
        v_new=r.standard_normal((total, kh, hd)).astype(f32),
        k_pages=r.standard_normal((n_pages, kh, PS, hd)).astype(f32),
        v_pages=r.standard_normal((n_pages, kh, PS, hd)).astype(f32),
        page_tables=(r.permutation(n_pages - 1)[: b * width].reshape(b, width)
                     + 1).astype(np.int32),
        kv_lens=np.asarray(bases, np.int32),
        q_starts=qs,
        q_lens=np.asarray(q_lens, np.int32)), row_flat


def _port(x, max_pos=None):
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    out = tpa.ragged_spans(**t, max_pos=max_pos)
    return out.numpy(), t["k_pages"].numpy(), t["v_pages"].numpy()


def _jax_xla(x, row_flat, max_pos=None):
    j = {k: jnp.asarray(v) for k, v in x.items()}
    out, kp, vp = ragged_spans_xla(**j, row_flat=jnp.asarray(row_flat),
                                   max_pos=max_pos)
    return np.asarray(out), np.asarray(kp), np.asarray(vp)


def _windows(pool, tables, upto):
    """Each row's gathered page window up to ``upto[b]`` tokens."""
    win = pool[tables]                                   # [B, W, K, ps, hd]
    win = win.transpose(0, 1, 3, 2, 4).reshape(win.shape[0], -1,
                                               win.shape[2], win.shape[4])
    return [win[i, :u] for i, u in enumerate(upto)]


# decode rows (one at a page boundary), a 13-token slice crossing a page
# boundary (not a multiple of SPAN_QT), an inactive row, a fresh decode row
MIXED = dict(q_lens=[1, 13, 1, 0, 1], bases=[20, 7, 16, 0, 0])


def test_spans_ref_matches_pallas_kernel():
    x, row_flat = _fixture(0, **MIXED)
    got, kp, vp = _port(x)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    want, j_kp, j_vp = ragged_spans_pallas(**j, interpret=True)
    in_span = row_flat < len(MIXED["q_lens"])
    np.testing.assert_allclose(got[in_span], np.asarray(want)[in_span],
                               atol=ATOL)
    assert not got[~in_span].any()  # out-of-span rows: zero (contract)
    upto = np.asarray(MIXED["bases"]) + np.asarray(MIXED["q_lens"])
    for a, b in ((kp, j_kp), (vp, j_vp)):
        for g, w in zip(_windows(a, x["page_tables"], upto),
                        _windows(np.asarray(b), x["page_tables"], upto)):
            np.testing.assert_array_equal(g, w)
    assert tpa.ragged_spans.launches == 0  # CPU tensors: plain version


def test_spans_ref_matches_xla_twin():
    """Outputs agree everywhere; pools agree bit for bit everywhere but the
    null page, where the XLA twin parks its out-of-span writes."""
    x, row_flat = _fixture(0, **MIXED)
    got, kp, vp = _port(x)
    want, j_kp, j_vp = _jax_xla(x, row_flat)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(kp[1:], j_kp[1:])
    np.testing.assert_array_equal(vp[1:], j_vp[1:])
    np.testing.assert_array_equal(kp[0], x["k_pages"][0])  # port: untouched


@pytest.mark.parametrize("case", ["max_pos", "overhang"])
def test_spans_ref_cap(case):
    """``max_pos``: row 0's span (positions 33..44) runs past max_pos=40,
    so only 33..39 are written and no token sees a column >= 40.
    ``overhang``: row 0's span (58..66) runs past its 4-page table, so
    58..63 are written and the tokens past the table attend the whole
    window.  Row 1 is an ordinary decode row in both."""
    max_pos, bases = (40, [33, 5]) if case == "max_pos" else (None, [58, 5])
    q_lens = [12 if case == "max_pos" else 9, 1]
    x, row_flat = _fixture(1, q_lens=q_lens, bases=bases)
    got, kp, vp = _port(x, max_pos=max_pos)
    want, j_kp, j_vp = _jax_xla(x, row_flat, max_pos=max_pos)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(kp[1:], j_kp[1:])
    np.testing.assert_array_equal(vp[1:], j_vp[1:])
    changed = np.flatnonzero((kp != x["k_pages"]).any(axis=(1, 2, 3)))
    tab = x["page_tables"]
    assert sorted(changed) == sorted({int(tab[0, bases[0] // PS]), int(tab[1, 0])})
    written = (kp[tab[0, bases[0] // PS]] != x["k_pages"][tab[0, bases[0] // PS]]
               ).any(axis=(0, 2))
    last = (max_pos if max_pos else 4 * PS) - 1
    assert list(np.flatnonzero(written)) == list(range(bases[0] % PS, last % PS + 1))


def test_forward_paged_spans_matches_jax():
    """A mixed dispatch (two decode rows + a prefill slice over a cached
    prefix) through both packages' ``forward_paged(spans=...)``: logits at
    the gathered rows and the pools."""
    kw = dict(vocab_size=300, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
              hidden_dim=160, max_seq_len=128, dtype="float32",
              tie_embeddings=False)
    jcfg, tcfg = JModelConfig(name="t", **kw), TModelConfig(name="t", **kw)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(5)))
    r = np.random.default_rng(6)
    n_pool = 12
    shape = (jcfg.n_layers * n_pool, jcfg.n_kv_heads, PS, jcfg.hd)
    kp = r.standard_normal(shape).astype(np.float32)
    vp = r.standard_normal(shape).astype(np.float32)
    q_lens = np.array([1, 21, 1], np.int32)
    base = np.array([30, 16, 5], np.int32)
    tables = np.array([[1, 2, 3], [4, 5, 6], [7, 0, 0]], np.int32)
    qs, total = tpa.pack_spans(q_lens)
    row_flat = np.full((total,), 3, np.int32)
    for i, (s, n) in enumerate(zip(qs, q_lens)):
        row_flat[s:s + n] = i
    rf = np.clip(row_flat, 0, 2)
    positions = np.clip(base[rf] + np.arange(total) - qs[rf], 0,
                        jcfg.max_seq_len - 1)[None].astype(np.int32)
    tokens = r.integers(3, 300, (1, total)).astype(np.int32)
    gidx = (qs + np.maximum(q_lens, 1) - 1).astype(np.int32)
    j_logits, j_kp, j_vp = j_forward_paged(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(tokens),
        jnp.asarray(positions), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(base), jcfg.max_seq_len,
        packed_last_idx=jnp.asarray(gidx),
        spans=(jnp.asarray(qs), jnp.asarray(q_lens), jnp.asarray(row_flat)))
    t_kp, t_vp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t = torch.from_numpy
    t_logits = t_forward_paged(
        params_from_jax(tree, tcfg), tcfg, t(tokens).long(), t(positions),
        t_kp, t_vp, t(tables), t(base), tcfg.max_seq_len,
        packed_last_idx=t(gidx), spans=(t(qs), t(q_lens), t(row_flat)))
    assert t_logits.shape == j_logits.shape
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4)
    # the XLA twin parks out-of-span writes on the null page (id 0 of
    # each layer): compare every other page
    keep = np.ones(shape[0], bool)
    keep[::n_pool] = False
    np.testing.assert_allclose(t_kp.numpy()[keep], np.asarray(j_kp)[keep],
                               atol=1e-5)
    np.testing.assert_allclose(t_vp.numpy()[keep], np.asarray(j_vp)[keep],
                               atol=1e-5)
