"""The split-sequence verify kernel's cases on the CPU, the shared shape rule
of the CUDA kernels, and the default ``tiny`` preset's head dim (32).

The card's multi-token verify kernel (``csrc/paged_decode_multi.cu``)
splits each row's columns into ``MULTI_SPLIT``-column pieces, one block
each: a block writes the new tokens whose positions fall in its own piece,
walks the piece, and the last block of the (row, kv head) merges the
pieces' partial softmax states in split order.  ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against the plain version at the split
boundaries on the card.  Here, scaled down (page size 32, splits of 64, an
8-page table), at hd 32 with 4 query heads per kv head and T = 5:

(a) the plain version ``paged_decode_multi_ref`` against the JAX package's
    XLA twin ``paged_decode_multi_xla`` at those cases (f32, atol 2e-5;
    pool writes exact outside the null page, where the twin parks skipped
    tokens);
(b) a torch emulation of the kernel's per-split writes, split walk and
    fixed-order merge against the unsplit plain version (atol 1e-5),
    bit-identical on a repeat, with a query row that attends nothing in its
    row's last split;
(c) the split count comes from shapes and covers every live length;
(d) the shape rule the wrappers and ``TorchEngine`` share
    (``ops/kernels.shape_problems``, ``engine/torch_engine.check_cuda_config``);
(e) ``forward_paged`` at the ``tiny`` preset's widths (hd 32, 2 layers)
    against the JAX package's, on the packed-prefill, decode and verify
    routes (f32 logits atol 1e-4, pools atol 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.config import ModelConfig as JModelConfig
from lmrs_tpu.models.transformer import forward_paged as j_forward_paged
from lmrs_tpu.models.transformer import init_params as j_init_params
from lmrs_tpu.ops.paged_attention import paged_decode_multi_xla
from lmrs_tpu_torch.config import EngineConfig, ModelConfig, model_preset
from lmrs_tpu_torch.engine.torch_engine import check_cuda_config
from lmrs_tpu_torch.models.convert import params_from_jax
from lmrs_tpu_torch.models.transformer import forward_paged as t_forward_paged
from lmrs_tpu_torch.ops import kernels
from lmrs_tpu_torch.ops import paged_attention as tpa

ATOL = 2e-5        # plain version vs the XLA twin, f32
MERGE_ATOL = 1e-5  # split walk + merge vs the unsplit plain version, f32
PS, W, SPLIT, T = 32, 8, 64, 5  # scaled-down page size, table width, split
H, KH, HD = 8, 2, 32
NEG = -1e30
LOG2E = 1.4426950408889634

# kv_lens (counting the T tokens): tokens straddling a split (62..66), a
# last token on a split's last column (123..127), tokens overhanging W·ps
# (253..257), T tokens inside one split (95..99), a stale length past
# W·ps, the null-table row of an empty slot (kv_lens = T), tokens opening
# a split (192..196), a fresh row
LENS = [67, 128, 258, 100, W * PS + 44, T, 197, T]
NULL_ROW = 5


def _case(seed=31):
    r = np.random.default_rng(seed)
    b = len(LENS)
    n_pages = b * W + 1
    tables = (r.permutation(n_pages - 1)[: b * W].reshape(b, W) + 1).astype(np.int32)
    tables[NULL_ROW] = 0
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(b, T, H, HD), k_new=f(b, T, KH, HD), v_new=f(b, T, KH, HD),
                k_pages=f(n_pages, KH, PS, HD), v_pages=f(n_pages, KH, PS, HD),
                page_tables=tables, kv_lens=np.asarray(LENS, np.int32))


def _torch(x):
    return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}


# ------------------------------------------------- (a) plain vs XLA twin


@pytest.mark.parametrize("max_pos", [None, 250])
def test_multi_ref_matches_xla_at_split_boundaries(max_pos):
    x = _case()
    t = _torch(x)
    got = tpa.paged_decode_multi_ref(**t, max_pos=max_pos).numpy()
    want, j_kp, j_vp = paged_decode_multi_xla(
        **{k: jnp.asarray(v) for k, v in x.items()}, max_pos=max_pos)
    real = [i for i in range(len(LENS)) if i != NULL_ROW]
    np.testing.assert_allclose(got[real], np.asarray(want)[real], atol=ATOL)
    np.testing.assert_array_equal(t["k_pages"].numpy()[1:], np.asarray(j_kp)[1:])
    np.testing.assert_array_equal(t["v_pages"].numpy()[1:], np.asarray(j_vp)[1:])


# ---------------------------------- (b) the split walk and its merge


def _partial(s, v):
    """One split's partial state per query row: s [R, C] log2-domain scores
    (NEG where masked), v [C, hd] -> (m [R], l [R], acc [R, hd])."""
    m = s.max(-1).values
    p = torch.where(s > 0.5 * NEG, torch.exp2(s - m[:, None]), torch.zeros(()))
    return m, p.sum(-1), p @ v


def _merge(parts):
    """The kernel's merge, splits in index order: sum acc·2^(m - M) over
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


def _split_multi(t, split, max_pos=None):
    """The verify kernel on the CPU: per (row, split) block, the write of
    the tokens whose positions fall in the split (each token by exactly one
    block), then the split's walk for the T x n_rep query rows, merged in
    split order.  Returns (out, number of empty partials seen)."""
    b = t["q"].shape[0]
    n_rep = H // KH
    cap = W * PS if max_pos is None else min(W * PS, max_pos)
    n_split = -(-cap // split)  # the wrapper's grid, from shapes
    out = torch.zeros_like(t["q"])
    empty = 0
    for row in range(b):
        base = max(int(t["kv_lens"][row]) - T, 0)
        kv_hi = min(base + T, cap)
        live = -(-kv_hi // split)
        assert 1 <= live <= n_split
        table = t["page_tables"][row].long()
        written = []
        for sp in range(live):  # 1. the blocks' writes
            lo, hi = sp * split, min((sp + 1) * split, kv_hi)
            for j in range(max(lo - base, 0), min(hi - base, T)):
                pos = base + j
                page = table[pos // PS]
                t["k_pages"][page, :, pos % PS] = t["k_new"][row, j]
                t["v_pages"][page, :, pos % PS] = t["v_new"][row, j]
                written.append(j)
        assert written == [j for j in range(T) if base + j < cap]
        kw = _window(t["k_pages"], t["page_tables"][row])
        vw = _window(t["v_pages"], t["page_tables"][row])
        col = torch.arange(W * PS)
        lim = torch.clamp(base + torch.arange(T), max=cap - 1).repeat_interleave(n_rep)
        for kvh in range(KH):  # 2. the walks, 3. the merge
            qh = (t["q"][row, :, kvh * n_rep:(kvh + 1) * n_rep].reshape(-1, HD)
                  * HD ** -0.5 * LOG2E)  # rows: token j x head
            parts = []
            for sp in range(live):
                lo, hi = sp * split, min((sp + 1) * split, kv_hi)
                s = qh @ kw[lo:hi, kvh].T
                s = torch.where(col[lo:hi][None] <= lim[:, None], s,
                                torch.full((), NEG))
                parts.append(_partial(s, vw[lo:hi, kvh]))
                empty += int((parts[-1][1] == 0).sum())
            o = _merge(parts).reshape(T, n_rep, HD)
            out[row, :, kvh * n_rep:(kvh + 1) * n_rep] = o
    return out, empty


@pytest.mark.parametrize("split,max_pos", [(SPLIT, None), (SPLIT, 250),
                                           (2 * SPLIT, None)])
def test_split_multi_matches_unsplit(split, max_pos):
    x = _case()
    want = tpa.paged_decode_multi_ref(**_torch(x), max_pos=max_pos)
    t = _torch(x)
    got, empty = _split_multi(t, split, max_pos)
    t_ref = _torch(x)
    tpa.paged_decode_multi_ref(**t_ref, max_pos=max_pos)
    for k in ("k_pages", "v_pages"):  # the split writes are the plain writes
        assert torch.equal(t[k], t_ref[k])
    torch.testing.assert_close(got, want, atol=MERGE_ATOL, rtol=0)
    again, _ = _split_multi(_torch(x), split, max_pos)
    assert torch.equal(got, again)  # fixed order: same bits
    if split == SPLIT:
        # the straddling row's first token attends nothing in split 1
        assert empty > 0


# ------------------------------------------ (c) split counts from shapes


def test_multi_split_count_comes_from_shapes():
    """The grid's splits, ceil(min(W·ps, max_pos) / MULTI_SPLIT), cover the
    live columns of every length the scheduler can pass (stale ones too),
    and the split is a multiple of the kernel's 64-column tile."""
    assert tpa.MULTI_SPLIT % 64 == 0
    r = np.random.default_rng(32)
    for _ in range(200):
        ps = int(r.choice([32, 64, 128]))
        w = int(r.integers(1, 65))
        t = int(r.integers(1, 17))
        max_pos = int(r.integers(1, 2 * w * ps))
        cap = min(w * ps, max_pos)
        n_split = -(-cap // tpa.MULTI_SPLIT)
        kv_len = int(r.integers(0, 3 * w * ps))
        kv_hi = min(max(kv_len - t, 0) + t, cap)
        assert -(-kv_hi // tpa.MULTI_SPLIT) <= n_split


# ------------------------------------------------------ (d) shape rule


@pytest.mark.parametrize("hd,ok", [(32, True), (64, True), (128, True),
                                   (256, True), (24, False), (96, False),
                                   (512, False)])
def test_shape_rule_head_dims(hd, ok):
    assert (kernels.shape_problems(hd, 8, 4, page_size=128) == []) == ok


def test_shape_rule_groups_pages_and_verify_rows():
    assert kernels.shape_problems(64, 12, 4)  # H/K = 3
    assert kernels.shape_problems(64, 6, 4)   # H % K != 0
    assert kernels.shape_problems(64, 8, 4, page_size=48)
    assert kernels.shape_problems(128, 32, 8, verify_tokens=16) == []  # 64 rows
    assert kernels.shape_problems(128, 32, 8, verify_tokens=17)        # 68 rows
    with pytest.raises(ValueError, match="query rows"):
        kernels.check_shapes("paged_decode_multi", 128, 32, 8, verify_tokens=17)


@pytest.mark.parametrize("preset", ["tiny", "tiny-gemma", "bench-smoke",
                                    "bench-1b", "bench-8b", "gemma-2b",
                                    "gemma-7b"])
def test_cuda_config_admits_presets(preset):
    check_cuda_config(EngineConfig(model=preset), model_preset(preset))
    check_cuda_config(EngineConfig(model=preset, speculate_k=4, mixed_batch=False),
                      model_preset(preset))


def test_cuda_config_refuses_by_name():
    with pytest.raises(ValueError, match="quality-tiny"):
        check_cuda_config(EngineConfig(), model_preset("quality-tiny"))
    bf16_hd24 = dataclasses.replace(model_preset("quality-tiny"), dtype="bfloat16")
    with pytest.raises(ValueError, match="hd in"):
        check_cuda_config(EngineConfig(), bf16_hd24)
    with pytest.raises(ValueError, match="page_size"):
        check_cuda_config(EngineConfig(page_size=48), model_preset("tiny"))
    # a head dim no build has is refused by name, whatever else the model is
    for hd in (96, 512):
        odd = dataclasses.replace(model_preset("gemma-7b"), name=f"gemma-hd{hd}",
                                  head_dim=hd)
        with pytest.raises(ValueError, match=rf"gemma-hd{hd} on cuda.*hd={hd}"):
            check_cuda_config(EngineConfig(), odd)
    # bench-8b has 4 query heads a kv head: 17 verify tokens are 68 rows
    with pytest.raises(ValueError, match="query rows"):
        check_cuda_config(EngineConfig(speculate_k=16, mixed_batch=False),
                          model_preset("bench-8b"))


# ------------------------------------------- (e) the tiny preset's hd 32


TINY2 = dict(dataclasses.asdict(model_preset("tiny")), n_layers=2,
             max_seq_len=128, dtype="float32")
N_POOL = 8


def _route(route, r):
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
    # verify: T tokens a row after its context; kv_lens counts them
    return dict(tokens=r.integers(3, 300, (3, T)),
                positions=lens[:, None] + np.arange(T), page_tables=tables,
                kv_lens=lens + T, multi_decode=True)


@pytest.mark.parametrize("route", ["packed", "decode", "verify"])
def test_forward_paged_at_hd32_matches_jax(route):
    jcfg, tcfg = JModelConfig(**TINY2), ModelConfig(**TINY2)
    assert tcfg.hd == 32
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(7)))
    r = np.random.default_rng(33)
    shape = (jcfg.n_layers * N_POOL, jcfg.n_kv_heads, 16, jcfg.hd)
    kp = r.standard_normal(shape).astype(np.float32)
    vp = r.standard_normal(shape).astype(np.float32)
    x = _route(route, r)
    multi = x.pop("multi_decode", False)
    ints = {k: np.asarray(v).astype(np.int32) for k, v in x.items()}
    extra = ("token_pages", "segment_ids", "packed_last_idx")
    j_logits, j_kp, j_vp = j_forward_paged(
        jax.tree.map(jnp.asarray, tree), jcfg, ints["tokens"], ints["positions"],
        jnp.asarray(kp), jnp.asarray(vp), ints["page_tables"], ints["kv_lens"],
        jcfg.max_seq_len, multi_decode=multi,
        **{k: jnp.asarray(ints[k]) for k in extra if k in ints})
    t_kp, t_vp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t_logits = t_forward_paged(
        params_from_jax(tree, tcfg), tcfg, torch.from_numpy(x["tokens"]),
        torch.from_numpy(x["positions"]), t_kp, t_vp,
        torch.from_numpy(x["page_tables"]), torch.from_numpy(ints["kv_lens"]),
        tcfg.max_seq_len, multi_decode=multi,
        **{k: torch.from_numpy(np.asarray(x[k])) for k in extra if k in x})
    assert t_logits.shape == j_logits.shape
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4)
    np.testing.assert_allclose(t_kp.numpy(), np.asarray(j_kp), atol=1e-5)
    np.testing.assert_allclose(t_vp.numpy(), np.asarray(j_vp), atol=1e-5)
