"""Split-sequence cases of the decode and span kernels, on the CPU.

The card kernels split each decode row's walk into ``DECODE_SPLIT``-token
pieces and each span query tile's columns into ``SPAN_SPLIT``-column
pieces, one block each, and merge the pieces' partial softmax states in
split order.  ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold them
against the plain versions at the split boundaries: a row of exactly one
split, one token more (the write lands in a new split), the table's full
width, a stale length past it, 0 and 1, and a continuation span that
crosses several splits.  Here, scaled down (page size 32, splits of 64,
an 8-page table):

(a) the plain versions ``paged_decode_fused_ref`` and ``ragged_spans_ref``
    against the JAX package's XLA twins ``paged_decode_xla`` and
    ``ragged_spans_xla`` at those cases (f32, atol 2e-5 as the kernel
    parity tests; pool writes exact), so the reference the card compares
    with is right there;
(b) a torch emulation of the kernels' split walk and fixed-order merge at
    the same cases against the unsplit plain versions, within f32 rounding
    (atol 1e-5), and bit-identical on a repeat.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.ops.paged_attention import paged_decode_xla, ragged_spans_xla
from lmrs_tpu_torch.ops import paged_attention as tpa

ATOL = 2e-5        # plain version vs the XLA twin, f32
MERGE_ATOL = 1e-5  # split walk + merge vs the unsplit plain version, f32
PS, W, SPLIT = 32, 8, 64  # scaled-down page size, table width, split
H, KH, HD = 8, 2, 64
NEG = -1e30
LOG2E = 1.4426950408889634

# decode lengths: one split, one split + 1, W·ps, stale past W·ps, 0, 1
DECODE_LENS = [SPLIT, SPLIT + 1, W * PS, W * PS + 44, 0, 1]
# span rows (base, q_len): a decode row ending on a split boundary, one
# whose token opens the next split, a short continuation (2 query tiles)
# whose walk crosses three splits, a long one (10 tiles, walked unsplit),
# a decode row at W·ps - 1, a stale base past W·ps, an inactive row, a
# fresh one-token row
SPAN_ROWS = [(SPLIT - 1, 1), (SPLIT, 1), (100, 30), (40, 150), (W * PS - 1, 1),
             (W * PS + 44, 1), (0, 0), (0, 1)]


def _pools(r, n_pages):
    return (r.standard_normal((n_pages, KH, PS, HD)).astype(np.float32),
            r.standard_normal((n_pages, KH, PS, HD)).astype(np.float32))


def _tables(r, b, n_pages):
    return (r.permutation(n_pages - 1)[: b * W].reshape(b, W) + 1).astype(np.int32)


def _decode_case():
    r = np.random.default_rng(11)
    b = len(DECODE_LENS)
    n_pages = b * W + 1
    kp, vp = _pools(r, n_pages)
    tables = _tables(r, b, n_pages)
    tables[DECODE_LENS.index(0)] = 0  # the empty row carries the null table
    return dict(q=r.standard_normal((b, H, HD)).astype(np.float32),
                k_new=r.standard_normal((b, KH, HD)).astype(np.float32),
                v_new=r.standard_normal((b, KH, HD)).astype(np.float32),
                k_pages=kp, v_pages=vp, page_tables=tables,
                kv_lens=np.asarray(DECODE_LENS, np.int32))


def _span_case():
    r = np.random.default_rng(12)
    bases = [base for base, _ in SPAN_ROWS]
    q_lens = [n for _, n in SPAN_ROWS]
    q_starts, tp = tpa.pack_spans(q_lens)
    b = len(SPAN_ROWS)
    n_pages = b * W + 1
    kp, vp = _pools(r, n_pages)
    row_flat = np.full((tp,), b, np.int32)
    for i, (s, n) in enumerate(zip(q_starts, q_lens)):
        row_flat[s:s + n] = i
    return dict(q=r.standard_normal((tp, H, HD)).astype(np.float32),
                k_new=r.standard_normal((tp, KH, HD)).astype(np.float32),
                v_new=r.standard_normal((tp, KH, HD)).astype(np.float32),
                k_pages=kp, v_pages=vp, page_tables=_tables(r, b, n_pages),
                kv_lens=np.asarray(bases, np.int32), q_starts=q_starts,
                q_lens=np.asarray(q_lens, np.int32)), row_flat


def _torch(x):
    return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}


# ------------------------------------------------- (a) plain vs XLA twins


def test_decode_ref_matches_xla_at_split_boundaries():
    x = _decode_case()
    t = _torch(x)
    got = tpa.paged_decode_fused_ref(**t).numpy()
    # the twin: scatter each writing row's token, then paged_decode_xla
    kp, vp = x["k_pages"].copy(), x["v_pages"].copy()
    for row, n in enumerate(DECODE_LENS):
        if 0 < n <= W * PS:
            page = x["page_tables"][row, (n - 1) // PS]
            kp[page, :, (n - 1) % PS] = x["k_new"][row]
            vp[page, :, (n - 1) % PS] = x["v_new"][row]
    want = np.asarray(paged_decode_xla(
        jnp.asarray(x["q"]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(x["page_tables"]), jnp.asarray(x["kv_lens"])))
    live = [i for i, n in enumerate(DECODE_LENS) if n > 0]
    np.testing.assert_allclose(got[live], want[live], atol=ATOL)
    assert not got[DECODE_LENS.index(0)].any()  # the port's zero row
    np.testing.assert_array_equal(t["k_pages"].numpy(), kp)
    np.testing.assert_array_equal(t["v_pages"].numpy(), vp)


def test_span_ref_matches_xla_at_split_boundaries():
    x, row_flat = _span_case()
    t = _torch(x)
    got = tpa.ragged_spans_ref(**t).numpy()
    want, j_kp, j_vp = ragged_spans_xla(
        **{k: jnp.asarray(v) for k, v in x.items()},
        row_flat=jnp.asarray(row_flat))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    # the twin parks the stale row's write on the null page; elsewhere the
    # pools agree bit for bit
    np.testing.assert_array_equal(t["k_pages"].numpy()[1:], np.asarray(j_kp)[1:])
    np.testing.assert_array_equal(t["v_pages"].numpy()[1:], np.asarray(j_vp)[1:])


# ---------------------------------- (b) the split walk and its merge


def _partial(s, v):
    """One split's partial state per query row: s [R, C] log2-domain scores
    (NEG where masked), v [C, hd] -> (m [R], l [R], acc [R, hd])."""
    if s.shape[1] == 0:
        return (torch.full((s.shape[0],), NEG), torch.zeros(s.shape[0]),
                torch.zeros(s.shape[0], v.shape[1]))
    m = s.max(-1).values
    p = torch.where(s > 0.5 * NEG, torch.exp2(s - m[:, None]), torch.zeros(()))
    return m, p.sum(-1), p @ v


def _merge(parts):
    """The kernels' merge, splits in index order: sum acc·2^(m - M) over
    sum l·2^(m - M), 0 where nothing was attended."""
    m = torch.stack([p[0] for p in parts]).max(0).values
    l_tot = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for ms, ls, a in parts:
        f = torch.where(ls > 0, torch.exp2(ms - m), torch.zeros(()))
        l_tot = l_tot + ls * f
        acc = acc + a * f[:, None]
    inv = torch.where(l_tot > 0, 1 / l_tot, torch.zeros(()))
    return acc * inv[:, None]


def _window(pool, table):
    """[W·ps, K, hd] gathered page window of one row."""
    return pool[table.long()].permute(0, 2, 1, 3).reshape(-1, KH, HD)


def _split_decode(t, split):
    """The decode kernel's walk: splits of ``split`` tokens over
    n_tok = min(len, W·ps), merged in order; zero rows for len 0."""
    b = t["q"].shape[0]
    n_rep = H // KH
    out = torch.zeros_like(t["q"])
    for row in range(b):
        n_tok = min(int(t["kv_lens"][row]), W * PS)
        if n_tok <= 0:
            continue
        kw = _window(t["k_pages"], t["page_tables"][row])
        vw = _window(t["v_pages"], t["page_tables"][row])
        live = -(-n_tok // split)
        assert live <= -(-(W * PS) // split)  # the grid's splits suffice
        for kvh in range(KH):
            qh = t["q"][row, kvh * n_rep:(kvh + 1) * n_rep] * HD ** -0.5 * LOG2E
            parts = []
            for sp in range(live):
                lo, hi = sp * split, min((sp + 1) * split, n_tok)
                parts.append(_partial(qh @ kw[lo:hi, kvh].T, vw[lo:hi, kvh]))
            out[row, kvh * n_rep:(kvh + 1) * n_rep] = _merge(parts)
    return out


def _split_spans(t, split, split_tiles, qrows=tpa.SPAN_QROWS):
    """The span kernel's attention pass: query tiles of qrows / n_rep span
    tokens, each walking columns [0, kv_hi) — in splits of ``split`` (a
    split may hold no column a given query row attends) when its span has
    at most ``split_tiles`` tiles, whole otherwise — merged in order."""
    n_rep = H // KH
    tok = qrows // n_rep
    cap = W * PS
    out = torch.zeros_like(t["q"])
    b = t["page_tables"].shape[0]
    tiles = 0
    for row in range(b):
        ql, base = int(t["q_lens"][row]), int(t["kv_lens"][row])
        qs = int(t["q_starts"][row])
        if ql <= 0:
            continue
        kw = _window(t["k_pages"], t["page_tables"][row])
        vw = _window(t["v_pages"], t["page_tables"][row])
        col = torch.arange(cap)
        step = split if -(-ql // tok) <= split_tiles else cap
        for j0 in range(0, ql, tok):
            tiles += 1
            js = torch.arange(j0, min(j0 + tok, ql))
            kv_hi = min(base + int(js[-1]) + 1, cap)
            live = -(-kv_hi // step)
            lim = torch.clamp(base + js, max=cap - 1)
            for kvh in range(KH):
                qh = (t["q"][qs + js, kvh * n_rep:(kvh + 1) * n_rep]
                      .reshape(-1, HD) * HD ** -0.5 * LOG2E)  # rows j x head
                lim_r = lim.repeat_interleave(n_rep)
                parts = []
                for sp in range(live):
                    lo, hi = sp * step, min((sp + 1) * step, kv_hi)
                    s = qh @ kw[lo:hi, kvh].T
                    s = torch.where(col[lo:hi][None] <= lim_r[:, None], s,
                                    torch.full((), NEG))
                    parts.append(_partial(s, vw[lo:hi, kvh]))
                o = _merge(parts).reshape(len(js), n_rep, HD)
                out[qs + js, kvh * n_rep:(kvh + 1) * n_rep] = o
    # the kernel's grid bound on the query tiles holds for this layout
    assert tiles <= -(-t["q"].shape[0] // tok) + b
    return out


def test_split_decode_merge_matches_unsplit():
    t = _torch(_decode_case())
    want = tpa.paged_decode_fused_ref(**t)  # writes the pools in place
    got = _split_decode(t, SPLIT)
    torch.testing.assert_close(got, want, atol=MERGE_ATOL, rtol=0)
    assert torch.equal(got, _split_decode(t, SPLIT))  # fixed order: same bits


@pytest.mark.parametrize("split,split_tiles", [
    (SPLIT, tpa.SPAN_SPLIT_TILES), (2 * SPLIT, tpa.SPAN_SPLIT_TILES),
    (SPLIT, 1000)])  # the last: every span split, the long one too
def test_split_span_merge_matches_unsplit(split, split_tiles):
    x, _ = _span_case()
    t = _torch(x)
    want = tpa.ragged_spans_ref(**t)  # writes the pools in place
    got = _split_spans(t, split, split_tiles)
    torch.testing.assert_close(got, want, atol=MERGE_ATOL, rtol=0)
    assert torch.equal(got, _split_spans(t, split, split_tiles))


def test_split_counts_come_from_shapes():
    """The wrappers size the grid and scratch from shapes: the splits of
    the table's span cover every live length, the splits are multiples of
    the kernels' tiles (32 tokens, 64 columns), and pack_spans layouts
    keep every row's query tiles inside ceil(Tp / tile) + B."""
    assert tpa.DECODE_SPLIT % 32 == 0 and tpa.SPAN_SPLIT % 64 == 0
    r = np.random.default_rng(13)
    for _ in range(50):
        q_lens = r.integers(0, 300, size=int(r.integers(1, 9)))
        _, tp = tpa.pack_spans(q_lens)
        for n_rep in (1, 2, 4, 8):
            tok = tpa.SPAN_QROWS // n_rep
            assert sum(-(-int(n) // tok) for n in q_lens) <= -(-tp // tok) + len(q_lens)
