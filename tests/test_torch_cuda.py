"""The port's CUDA kernels against their plain PyTorch versions on the card
(bf16; atol 2e-2 on outputs of magnitude ~1, pool writes exact), and the
wrappers' refusals of what a kernel does not take.

Card-only: every test carries the ``cuda`` marker and skips without a GPU.
The file imports nothing of JAX, so on a machine with a card and no JAX it
runs alone:  ``python -m pytest tests/test_torch_cuda.py -q --noconftest``.
"""

import numpy as np
import pytest
import torch

from lmrs_tpu_torch.ops import flash_attention as tfa
from lmrs_tpu_torch.ops import paged_attention as tpa
from lmrs_tpu_torch.utils.kernel_ab import FLASH_CASES

TOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(dev, *arrays):
    return [torch.from_numpy(a).to(dev, torch.bfloat16) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_flash_kernel_matches_plain(cuda_device, packed):
    r = np.random.default_rng(2)
    b, s, h, kh, hd = 2, 300, 8, 2, 128
    q, k, v = _bf16(cuda_device, r.standard_normal((b, s, h, hd)).astype(np.float32),
                    r.standard_normal((b, s, kh, hd)).astype(np.float32),
                    r.standard_normal((b, s, kh, hd)).astype(np.float32))
    seg = None
    if packed:
        seg = torch.tensor([[0] * 100 + [1] * 150 + [-1] * 50] * b,
                           dtype=torch.int32, device=cuda_device)
        lens = torch.tensor([250, 250], dtype=torch.int32, device=cuda_device)
    else:
        lens = torch.tensor([300, 129], dtype=torch.int32, device=cuda_device)
    n0 = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, lens, seg)
    want = tfa.flash_attention_ref(q, k, v, lens, seg)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)


@pytest.mark.cuda
def test_decode_kernel_matches_plain(cuda_device):
    r = np.random.default_rng(3)
    b, h, kh, hd, ps, n_pages = 4, 8, 2, 128, 32, 16
    q, k_new, v_new, k_pages, v_pages = _bf16(
        cuda_device, *(r.standard_normal(shape).astype(np.float32) for shape in
                       ((b, h, hd), (b, kh, hd), (b, kh, hd),
                        (n_pages, kh, ps, hd), (n_pages, kh, ps, hd))))
    tables = torch.tensor([[3, 5, 7], [9, 2, 0], [0, 0, 0], [11, 12, 0]],
                          dtype=torch.int32, device=cuda_device)
    # mid-page, page boundary, empty row, stale length past the table
    lens = torch.tensor([65, 32, 0, 500], dtype=torch.int32, device=cuda_device)
    kp1, vp1, kp2, vp2 = k_pages.clone(), v_pages.clone(), k_pages.clone(), v_pages.clone()
    n0 = tpa.paged_decode_fused.launches
    got = tpa.paged_decode_fused(q, k_new, v_new, kp1, vp1, tables, lens)
    want = tpa.paged_decode_fused_ref(q, k_new, v_new, kp2, vp2, tables, lens)
    torch.cuda.synchronize()
    assert tpa.paged_decode_fused.launches == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)
    assert torch.equal(kp1, kp2) and torch.equal(vp1, vp2)
    assert not got[2].any()


def _span_case(dev, case):
    """The span dispatches chip_smoke.py holds the kernel to: a mixed step
    (7 decode rows + a 249-token slice at base 384, 512 flat tokens) and a
    1,300-token continuation at base 384; bench-8b widths, W=16, ps=128."""
    r = np.random.default_rng(4)
    h, kh, hd, ps, w, b = 32, 8, 128, 128, 16, 8
    if case == "mixed":
        q_lens = [1] * 7 + [249]
        bases = [100, 400, 700, 1000, 1300, 1600, 1900, 384]
    else:
        q_lens, bases = [1300] + [0] * 7, [384] + [0] * 7
    q_starts, total = tpa.pack_spans(q_lens)
    tp = 512 if case == "mixed" else total
    n_pages = b * w + 1
    q, k_new, v_new, k_pages, v_pages = _bf16(
        dev, *(r.standard_normal(shape).astype(np.float32) for shape in
               ((tp, h, hd), (tp, kh, hd), (tp, kh, hd),
                (n_pages, kh, ps, hd), (n_pages, kh, ps, hd))))
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)  # noqa: E731
    return dict(q=q, k_new=k_new, v_new=v_new, k_pages=k_pages,
                v_pages=v_pages,
                page_tables=i32(r.permutation(n_pages - 1)[: b * w].reshape(b, w) + 1),
                kv_lens=i32(bases), q_starts=i32(q_starts), q_lens=i32(q_lens))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "continuation"])
def test_span_kernel_matches_plain(cuda_device, case):
    x = _span_case(cuda_device, case)
    x2 = {k: v.clone() for k, v in x.items()}
    n0 = tpa.ragged_spans.launches
    got = tpa.ragged_spans(**x)
    want = tpa.ragged_spans_ref(**x2)
    torch.cuda.synchronize()
    assert tpa.ragged_spans.launches == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)
    assert torch.equal(x["k_pages"], x2["k_pages"])
    assert torch.equal(x["v_pages"], x2["v_pages"])
    in_span = torch.zeros(got.shape[0], dtype=torch.bool, device=cuda_device)
    for s, n in zip(x["q_starts"].tolist(), x["q_lens"].tolist()):
        in_span[s:s + n] = True
    assert not got[~in_span].any()  # out-of-span rows: zero


@pytest.mark.cuda
def test_span_kernel_refuses_what_it_does_not_take(cuda_device):
    x = _span_case(cuda_device, "mixed")
    with pytest.raises(ValueError, match="hd"):  # head dim outside 64/128
        tpa.ragged_spans(**{**x, "q": x["q"][..., :96].contiguous(),
                            "k_new": x["k_new"][..., :96].contiguous(),
                            "v_new": x["v_new"][..., :96].contiguous(),
                            "k_pages": x["k_pages"][..., :96].contiguous(),
                            "v_pages": x["v_pages"][..., :96].contiguous()})
    with pytest.raises(ValueError, match="bfloat16"):
        tpa.ragged_spans(**{**x, "q": x["q"].float()})
    with pytest.raises(ValueError, match="contiguous"):
        tpa.ragged_spans(**{**x, "q": x["q"].transpose(0, 1).contiguous().transpose(0, 1)})


def _multi_case(dev, null_row=False):
    """chip_smoke.py's verify step: 8 rows x T=5 at bench-8b widths, W=16,
    ps=128, max_pos 2048; row 2's span straddles a page boundary, row 5's
    overhangs the window.  ``null_row``: row 0 carries the null table and
    the length T, as an empty slot does in the scheduler."""
    r = np.random.default_rng(5)
    b, t, h, kh, hd, ps, w = 8, 5, 32, 8, 128, 128, 16
    lens = [6, 133, 130, 700, 1500, 2050, 1000, 305]
    n_pages = b * w + 1
    tables = r.permutation(n_pages - 1)[: b * w].reshape(b, w) + 1
    if null_row:
        tables[0], lens[0] = 0, t
    q, k_new, v_new, k_pages, v_pages = _bf16(
        dev, *(r.standard_normal(shape).astype(np.float32) for shape in
               ((b, t, h, hd), (b, t, kh, hd), (b, t, kh, hd),
                (n_pages, kh, ps, hd), (n_pages, kh, ps, hd))))
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)  # noqa: E731
    return dict(q=q, k_new=k_new, v_new=v_new, k_pages=k_pages,
                v_pages=v_pages, page_tables=i32(tables), kv_lens=i32(lens),
                max_pos=2048)


@pytest.mark.cuda
@pytest.mark.parametrize("null_row", [False, True])
def test_multi_kernel_matches_plain(cuda_device, null_row):
    """Outputs on the rows with real tables; pools outside the null page
    (null-table rows write page 0 concurrently on the card)."""
    x = _multi_case(cuda_device, null_row)
    x2 = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in x.items()}
    n0 = tpa.paged_decode_multi.launches
    got = tpa.paged_decode_multi(**x)
    want = tpa.paged_decode_multi_ref(**x2)
    torch.cuda.synchronize()
    assert tpa.paged_decode_multi.launches == n0 + 1
    real = slice(1 if null_row else 0, None)
    torch.testing.assert_close(got[real].float(), want[real].float(),
                               atol=TOL, rtol=0)
    assert torch.equal(x["k_pages"][1:], x2["k_pages"][1:])
    assert torch.equal(x["v_pages"][1:], x2["v_pages"][1:])


@pytest.mark.cuda
def test_walk_only_kernel_matches_plain(cuda_device):
    """The write-fused decode kernel's shape without the write: empty
    row, page boundaries, the table's full width; the pools stay
    untouched."""
    r = np.random.default_rng(6)
    b, h, kh, hd, ps, w, n_pages = 8, 32, 8, 128, 128, 16, 256
    q, k_pages, v_pages = _bf16(
        cuda_device, *(r.standard_normal(shape).astype(np.float32) for shape in
                       ((b, h, hd), (n_pages, kh, ps, hd), (n_pages, kh, ps, hd))))
    tables = torch.tensor(r.permutation(n_pages - 1)[: b * w].reshape(b, w) + 1,
                          dtype=torch.int32, device=cuda_device)
    tables[0] = 0
    lens = torch.tensor([0, 1, 128, 129, 700, 1500, 2048, 1000],
                        dtype=torch.int32, device=cuda_device)
    kp0, vp0 = k_pages.clone(), v_pages.clone()
    n0 = tpa.paged_decode.launches
    got = tpa.paged_decode(q, k_pages, v_pages, tables, lens)
    want = tpa.paged_decode_ref(q, k_pages, v_pages, tables, lens)
    torch.cuda.synchronize()
    assert tpa.paged_decode.launches == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)
    assert not got[0].any()
    assert torch.equal(k_pages, kp0) and torch.equal(v_pages, vp0)


@pytest.mark.cuda
def test_multi_and_walk_kernels_refuse_what_they_do_not_take(cuda_device):
    x = _multi_case(cuda_device)
    cut = {k: x[k][..., :96].contiguous()
           for k in ("q", "k_new", "v_new", "k_pages", "v_pages")}
    with pytest.raises(ValueError, match="hd"):  # head dim outside 64/128
        tpa.paged_decode_multi(**{**x, **cut})
    with pytest.raises(ValueError, match="bfloat16"):
        tpa.paged_decode_multi(**{**x, "q": x["q"].float()})
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_decode_multi(**{**x, "q": x["q"].transpose(1, 2).contiguous()
                                  .transpose(1, 2)})
    # 17 tokens x 4 heads = 68 query rows per kv head: above the kernel's 64
    t17 = {k: x[k][:, :1].expand(-1, 17, -1, -1).contiguous()
           for k in ("q", "k_new", "v_new")}
    with pytest.raises(ValueError, match="query rows"):
        tpa.paged_decode_multi(**{**x, **t17})
    q1 = x["q"][:, 0].contiguous()
    with pytest.raises(ValueError, match="hd"):
        tpa.paged_decode(cut["q"][:, 0].contiguous(), cut["k_pages"],
                         cut["v_pages"], x["page_tables"], x["kv_lens"])
    with pytest.raises(ValueError, match="bfloat16"):
        tpa.paged_decode(q1.float(), x["k_pages"], x["v_pages"],
                         x["page_tables"], x["kv_lens"])
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_decode(q1.transpose(0, 1).contiguous().transpose(0, 1),
                         x["k_pages"], x["v_pages"], x["page_tables"],
                         x["kv_lens"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_cases(cuda_device, case):
    """The flash kernel at its edges (``kernel_ab.FLASH_CASES``), q/k/v as
    the strided views of one qkv product that ``forward_paged`` passes:
    within 2e-2 of the plain version, and a repeat launch bit-identical."""
    b, s, h, kh, hd, lens, seg_lens = FLASH_CASES[case]
    r = np.random.default_rng(40 + sorted(FLASH_CASES).index(case))
    qkv, = _bf16(cuda_device, r.standard_normal(
        (b, s, (h + 2 * kh) * hd)).astype(np.float32))
    q = qkv[..., :h * hd].view(b, s, h, hd)
    k = qkv[..., h * hd:(h + kh) * hd].view(b, s, kh, hd)
    v = qkv[..., (h + kh) * hd:].view(b, s, kh, hd)
    seg = None
    if seg_lens is not None:
        ids = np.full((s,), -1, np.int32)
        ids[:sum(seg_lens)] = np.repeat(np.arange(len(seg_lens)), seg_lens)
        seg = torch.from_numpy(np.stack([ids] * b)).to(cuda_device)
        lens = [sum(seg_lens)] * b
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    n0 = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, lens, seg)
    again = tfa.flash_attention(q, k, v, lens, seg)
    want = tfa.flash_attention_ref(q, k, v, lens, seg)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == n0 + 2
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    q = torch.zeros(1, 64, 4, 96, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="hd"):
        tfa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q32 = torch.zeros(1, 64, 4, 128, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention(q32, q32[:, :, :2], q32[:, :, :2])


# ------------------------------------------------------------- int8 pools

TIE = 2.0 ** -5  # a scale that divides half-integer multiples to exact .5


def _int8ify(x, tie_tokens, tie_row, seed):
    """Turn a bf16 case into its int8 form: random int8 pools, scales
    [rows, K, hd] from ``kv_scale_from`` on random bf16 K/V, and one row
    whose scale is 2^-5 and whose new K/V (flat tokens ``tie_tokens``) are
    half-integer multiples of it, so every x / s is an exact tie (and a
    few values saturate past 127); bf16 holds them all exactly."""
    from lmrs_tpu_torch.ops.quant import kv_scale_from

    dev = x["q"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = dict(x)
    for name in ("k_pages", "v_pages"):
        y[name] = torch.randint(-127, 128, x[name].shape, generator=gen,
                                device=dev, dtype=torch.int8)
    rows, kh, hd = x["page_tables"].shape[0], x["k_pages"].shape[1], x["k_pages"].shape[3]
    for name, new in (("kscale", "k_new"), ("vscale", "v_new")):
        kv = torch.randn(rows, 64, kh, hd, generator=gen, device=dev).bfloat16()
        s = kv_scale_from(kv, torch.ones(rows, 64, dtype=torch.bool, device=dev))
        s[tie_row] = TIE
        y[name] = s.contiguous()
        m = torch.randint(-127, 127, y[new][tie_tokens].shape, generator=gen,
                          device=dev)
        ties = (m + 0.5) * TIE
        ties.view(-1)[:4] = torch.tensor([160, -160, 130, -130], device=dev) * TIE
        y[new] = y[new].clone()
        y[new][tie_tokens] = ties.bfloat16()
    return y


def _run_pair(fn, ref, x, counter):
    x2 = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in x.items()}
    n0 = counter.launches_int8
    got, want = fn(**x), ref(**x2)
    torch.cuda.synchronize()
    assert counter.launches_int8 == n0 + 1
    return got, want, x2


@pytest.mark.cuda
def test_int8_decode_kernel_matches_plain(cuda_device):
    """chip_smoke.py's decode shape (8 rows, empty row, page boundaries,
    full window) over int8 pools; row 4's new K/V are exact ties."""
    r = np.random.default_rng(7)
    b, h, kh, hd, ps, w, n_pages = 8, 32, 8, 128, 128, 16, 256
    q, k_new, v_new = _bf16(cuda_device, *(r.standard_normal(s).astype(np.float32)
                                           for s in ((b, h, hd), (b, kh, hd), (b, kh, hd))))
    tables = torch.tensor(r.permutation(n_pages - 1)[: b * w].reshape(b, w) + 1,
                          dtype=torch.int32, device=cuda_device)
    tables[0] = 0
    x = dict(q=q, k_new=k_new, v_new=v_new,
             k_pages=torch.zeros(n_pages, kh, ps, hd, device=cuda_device),
             v_pages=torch.zeros(n_pages, kh, ps, hd, device=cuda_device),
             page_tables=tables,
             kv_lens=torch.tensor([0, 1, 128, 129, 700, 1500, 2048, 1000],
                                  dtype=torch.int32, device=cuda_device))
    x = _int8ify(x, 4, 4, seed=7)
    got, want, x2 = _run_pair(tpa.paged_decode_fused, tpa.paged_decode_fused_ref,
                              x, tpa.paged_decode_fused)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)
    assert torch.equal(x["k_pages"], x2["k_pages"])
    assert torch.equal(x["v_pages"], x2["v_pages"])
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "continuation"])
def test_int8_span_kernel_matches_plain(cuda_device, case):
    """The span cases over int8 pools: each flat token quantizes with its
    own row's scales; the mixed step's slice row (7) and the continuation
    row (0) carry the exact ties."""
    x = _span_case(cuda_device, case)
    row = 7 if case == "mixed" else 0
    s, n = int(x["q_starts"][row]), int(x["q_lens"][row])
    x = _int8ify(x, slice(s, s + n), row, seed=8)
    got, want, x2 = _run_pair(tpa.ragged_spans, tpa.ragged_spans_ref, x,
                              tpa.ragged_spans)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)
    assert torch.equal(x["k_pages"], x2["k_pages"])
    assert torch.equal(x["v_pages"], x2["v_pages"])


@pytest.mark.cuda
@pytest.mark.parametrize("null_row", [False, True])
def test_int8_multi_kernel_matches_plain(cuda_device, null_row):
    """The verify step over int8 pools; row 3's 5 tokens are exact ties.
    Pools outside the null page."""
    x = _int8ify(_multi_case(cuda_device, null_row), 3, 3, seed=9)
    got, want, x2 = _run_pair(tpa.paged_decode_multi, tpa.paged_decode_multi_ref,
                              x, tpa.paged_decode_multi)
    real = slice(1 if null_row else 0, None)
    torch.testing.assert_close(got[real].float(), want[real].float(),
                               atol=TOL, rtol=0)
    assert torch.equal(x["k_pages"][1:], x2["k_pages"][1:])
    assert torch.equal(x["v_pages"][1:], x2["v_pages"][1:])


@pytest.mark.cuda
def test_int8_kernels_refuse_mismatched_scales(cuda_device):
    x = _int8ify(_multi_case(cuda_device), 3, 3, seed=10)
    with pytest.raises(ValueError, match="kscale"):  # int8 pools, no scales
        tpa.paged_decode_multi(**{**x, "kscale": None, "vscale": None})
    with pytest.raises(ValueError, match="must be"):  # [B, K, hd] f32 only
        tpa.paged_decode_multi(**{**x, "kscale": x["kscale"][:, :4].contiguous()})
    with pytest.raises(ValueError, match="float32"):
        tpa.paged_decode_multi(**{**x, "kscale": x["kscale"].bfloat16()})


# ------------------------------------------- split-sequence boundaries

def _split_decode_case(dev, seed, h=32, kh=8, hd=128):
    """Decode rows at the split boundaries (bench-8b widths unless given,
    ps=128, W=16): exactly one split (``decode_split``) of tokens, one more
    (the write opens a new split), W·ps, a stale length past W·ps, 0 (null
    table) and 1."""
    r = np.random.default_rng(seed)
    b, ps, w = 6, 128, 16
    split = tpa.decode_split(b, kh)
    lens = [split, split + 1, w * ps, w * ps + 100, 0, 1]
    n_pages = b * w + 1
    tables = r.permutation(n_pages - 1)[: b * w].reshape(b, w) + 1
    tables[4] = 0
    q, k_new, v_new, k_pages, v_pages = _bf16(
        dev, *(r.standard_normal(s).astype(np.float32) for s in
               ((b, h, hd), (b, kh, hd), (b, kh, hd), (n_pages, kh, ps, hd),
                (n_pages, kh, ps, hd))))
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)  # noqa: E731
    return dict(q=q, k_new=k_new, v_new=v_new, k_pages=k_pages,
                v_pages=v_pages, page_tables=i32(tables), kv_lens=i32(lens))


def _split_span_case(dev, seed, h=32, kh=8, hd=128):
    """Span rows at the split boundaries (bench-8b widths unless given):
    decode rows whose column range ends on a SPAN_SPLIT boundary and one
    past it, a 48-token continuation at base 1000 (3 query tiles at n_rep
    4: split) whose walk crosses three splits, a 900-token continuation at
    base 300 (walked unsplit), a decode row at W·ps - 1, a stale base past
    W·ps, an inactive row and a fresh one-token row."""
    r = np.random.default_rng(seed)
    ps, w = 128, 16
    split = tpa.SPAN_SPLIT
    rows = [(split - 1, 1), (split, 1), (1000, 48), (300, 900),
            (w * ps - 1, 1), (w * ps + 50, 1), (0, 0), (0, 1)]
    q_lens = [n for _, n in rows]
    q_starts, tp = tpa.pack_spans(q_lens)
    b = len(rows)
    n_pages = b * w + 1
    q, k_new, v_new, k_pages, v_pages = _bf16(
        dev, *(r.standard_normal(s).astype(np.float32) for s in
               ((tp, h, hd), (tp, kh, hd), (tp, kh, hd), (n_pages, kh, ps, hd),
                (n_pages, kh, ps, hd))))
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)  # noqa: E731
    return dict(q=q, k_new=k_new, v_new=v_new, k_pages=k_pages,
                v_pages=v_pages,
                page_tables=i32(r.permutation(n_pages - 1)[: b * w].reshape(b, w) + 1),
                kv_lens=i32([base for base, _ in rows]), q_starts=i32(q_starts),
                q_lens=i32(q_lens))


def _check_split_kernel(fn, ref, x, pool_keys=("k_pages", "v_pages"),
                        rows=slice(None), pages=slice(None)):
    """Kernel vs plain within TOL, pools bit-exact, and a second launch on
    the same inputs (pools restored) bit-identical to the first; ``rows``
    and ``pages`` leave out the verify kernel's null-table rows and the
    null page they all write."""
    x0 = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in x.items()}
    x2 = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in x.items()}
    got = fn(**x)
    want = ref(**x2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[rows].float(), want[rows].float(), atol=TOL,
                               rtol=0)
    for k in pool_keys:
        assert torch.equal(x[k][pages], x2[k][pages]), k
    again = fn(**{k: (v.clone() if torch.is_tensor(v) else v) for k, v in x0.items()})
    torch.cuda.synchronize()
    assert torch.equal(got[rows], again[rows])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "walk"])
def test_decode_kernels_at_split_boundaries(cuda_device, kind):
    x = _split_decode_case(cuda_device, 21)
    if kind == "int8":
        x = _int8ify(x, 1, 1, seed=22)  # row 1 (SPLIT + 1): exact ties
    if kind == "walk":
        kp0, vp0 = x["k_pages"].clone(), x["v_pages"].clone()
        walk = {k: x[k] for k in ("q", "k_pages", "v_pages", "page_tables", "kv_lens")}
        got = _check_split_kernel(tpa.paged_decode, tpa.paged_decode_ref, walk)
        assert torch.equal(x["k_pages"], kp0) and torch.equal(x["v_pages"], vp0)
    else:
        got = _check_split_kernel(tpa.paged_decode_fused,
                                  tpa.paged_decode_fused_ref, x)
    assert not got[4].any()  # the kv_len == 0 row


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_span_kernels_at_split_boundaries(cuda_device, int8):
    x = _split_span_case(cuda_device, 23)
    if int8:
        s, n = int(x["q_starts"][2]), int(x["q_lens"][2])
        x = _int8ify(x, slice(s, s + n), 2, seed=24)  # the continuation's ties
    got = _check_split_kernel(tpa.ragged_spans, tpa.ragged_spans_ref, x)
    in_span = torch.zeros(got.shape[0], dtype=torch.bool, device=cuda_device)
    for s, n in zip(x["q_starts"].tolist(), x["q_lens"].tolist()):
        in_span[s:s + n] = True
    assert not got[~in_span].any()


def _split_multi_case(dev, seed, h=32, kh=8, hd=128):
    """Verify rows (T = 5) at MULTI_SPLIT's boundaries (bench-8b widths
    unless given, ps=128, W=16, max_pos 2048): tokens straddling a split,
    a last token on a split's last column, tokens overhanging the window,
    T tokens inside one split, a stale length past W·ps, the null-table row
    of an empty slot (kv_lens = T, row 5), tokens opening a split and a
    fresh row."""
    r = np.random.default_rng(seed)
    t, ps, w = 5, 128, 16
    split = tpa.MULTI_SPLIT
    lens = [split + 3, split, w * ps + 2, 700, w * ps + 100, t, 2 * split + t, t]
    b = len(lens)
    n_pages = b * w + 1
    tables = r.permutation(n_pages - 1)[: b * w].reshape(b, w) + 1
    tables[5] = 0
    q, k_new, v_new, k_pages, v_pages = _bf16(
        dev, *(r.standard_normal(s).astype(np.float32) for s in
               ((b, t, h, hd), (b, t, kh, hd), (b, t, kh, hd),
                (n_pages, kh, ps, hd), (n_pages, kh, ps, hd))))
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)  # noqa: E731
    return dict(q=q, k_new=k_new, v_new=v_new, k_pages=k_pages,
                v_pages=v_pages, page_tables=i32(tables), kv_lens=i32(lens),
                max_pos=2048)


# every row of _split_multi_case but the null-table row; pages past the null page
MULTI_REAL = [0, 1, 2, 3, 4, 6, 7]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_multi_kernels_at_split_boundaries(cuda_device, int8):
    """The split verify kernel at its split boundaries, bench-8b widths:
    within TOL of the plain version, pools exact outside the null page, a
    repeat launch bit-identical."""
    x = _split_multi_case(cuda_device, 25)
    if int8:
        x = _int8ify(x, 0, 0, seed=26)  # the straddling row's ties
    _check_split_kernel(tpa.paged_decode_multi, tpa.paged_decode_multi_ref, x,
                        rows=MULTI_REAL, pages=slice(1, None))


# ------------------------------------------------- hd 32 (the tiny presets)

HD32 = dict(h=8, kh=4, hd=32)  # the tiny preset's heads: 256 / 8, n_rep 2


KINDS = ["flash", "flash_packed", "decode", "decode_int8", "walk", "spans",
         "spans_int8", "multi", "multi_int8"]


def _check_build(dev, kind, widths, seed):
    """One kernel build at these head widths against its plain version:
    flash on two rows (lengths < S; ``flash_packed``: two segments and a
    padded tail) with a repeat launch bit-identical, the paged kernels at
    the split boundaries (pools exact, a repeat launch bit-identical)."""
    h, kh, hd = widths["h"], widths["kh"], widths["hd"]
    if kind.startswith("flash"):
        r = np.random.default_rng(seed)
        b, s = 2, 300
        q, k, v = _bf16(dev, *(r.standard_normal(sh).astype(np.float32)
                               for sh in ((b, s, h, hd), (b, s, kh, hd),
                                          (b, s, kh, hd))))
        seg = None
        lens = torch.tensor([300, 129], dtype=torch.int32, device=dev)
        if kind == "flash_packed":
            seg = torch.tensor([[0] * 100 + [1] * 150 + [-1] * 50] * b,
                               dtype=torch.int32, device=dev)
            lens = torch.tensor([250, 250], dtype=torch.int32, device=dev)
        n0 = tfa.flash_attention.launches
        got = tfa.flash_attention(q, k, v, lens, seg)
        again = tfa.flash_attention(q, k, v, lens, seg)
        want = tfa.flash_attention_ref(q, k, v, lens, seg)
        torch.cuda.synchronize()
        assert tfa.flash_attention.launches == n0 + 2
        torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)
        assert torch.equal(got, again)
        return
    int8 = kind.endswith("_int8")
    if kind.startswith("decode") or kind == "walk":
        x = _split_decode_case(dev, seed + 1, **widths)
        if int8:
            x = _int8ify(x, 1, 1, seed=seed + 2)
        if kind == "walk":
            kp0, vp0 = x["k_pages"].clone(), x["v_pages"].clone()
            walk = {k: x[k] for k in ("q", "k_pages", "v_pages", "page_tables",
                                      "kv_lens")}
            got = _check_split_kernel(tpa.paged_decode, tpa.paged_decode_ref, walk)
            assert torch.equal(x["k_pages"], kp0) and torch.equal(x["v_pages"], vp0)
        else:
            got = _check_split_kernel(tpa.paged_decode_fused,
                                      tpa.paged_decode_fused_ref, x)
        assert not got[4].any()
    elif kind.startswith("spans"):
        x = _split_span_case(dev, seed + 3, **widths)
        if int8:
            s0, n = int(x["q_starts"][2]), int(x["q_lens"][2])
            x = _int8ify(x, slice(s0, s0 + n), 2, seed=seed + 4)
        _check_split_kernel(tpa.ragged_spans, tpa.ragged_spans_ref, x)
    else:
        x = _split_multi_case(dev, seed + 5, **widths)
        if int8:
            x = _int8ify(x, 0, 0, seed=seed + 6)
        _check_split_kernel(tpa.paged_decode_multi, tpa.paged_decode_multi_ref,
                            x, rows=MULTI_REAL, pages=slice(1, None))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernels_at_hd32(cuda_device, kind):
    """Each kernel's hd-32 build against its plain version at the split
    boundaries (pools exact, a repeat launch bit-identical)."""
    _check_build(cuda_device, kind, HD32, 27)


# ------------------------------------------------ hd 256 (the Gemma presets)

HD256 = {"gemma-7b": dict(h=16, kh=16, hd=256),  # multi-head, n_rep 1
         "gemma-2b": dict(h=8, kh=1, hd=256)}    # multi-query, n_rep 8


@pytest.mark.cuda
@pytest.mark.parametrize("heads", sorted(HD256))
@pytest.mark.parametrize("kind", KINDS)
def test_kernels_at_hd256(cuda_device, kind, heads):
    """Each kernel's hd-256 build at both Gemma head groupings against its
    plain version: flash two rows (packed and not), the paged kernels at
    their split boundaries; pools exact, a repeat launch bit-identical."""
    _check_build(cuda_device, kind, HD256[heads], 40)


@pytest.mark.cuda
def test_flash_kernel_refuses_unbuilt_head_dim(cuda_device, monkeypatch):
    """With the wrapper's shape check bypassed, a head dim no build has
    (96) is refused by the kernel's own dispatch, not run as another
    build: the launch reports cudaErrorInvalidValue and the wrapper
    raises."""
    from lmrs_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "check_shapes", lambda *a, **k: None)
    q = torch.zeros(1, 64, 4, 96, dtype=torch.bfloat16, device=cuda_device)
    kv = torch.zeros(1, 64, 2, 96, dtype=torch.bfloat16, device=cuda_device)
    n0 = tfa.flash_attention.launches
    with pytest.raises(RuntimeError, match="error 1"):
        tfa.flash_attention(q, kv, kv)
    assert tfa.flash_attention.launches == n0


# ------------------------------- the ancestor-mask build (tree speculation)


def _tree_masks(hl, width=2, k=4):
    """The ancestor masks of a tree span [heal (hl), cur, width chains of
    k] (int32 words; the scheduler's template)."""
    from types import SimpleNamespace

    from lmrs_tpu_torch.engine.scheduler import ContinuousScheduler

    ns = SimpleNamespace(_spec_tmpl={}, _spec_width=width, spec_k=k)
    return ContinuousScheduler._tree_span_template(ns, hl)[1]


def _anc_case(dev, seed, h=32, kh=8, hd=128):
    """One tree-speculation dispatch (bench-8b widths unless given, ps=128,
    W=16): tree spans at heal 0-4 whose bases lie on a split boundary
    (512), a 32-column tile boundary (544), a 64-column one (576), nowhere
    (1000) and one column before a split boundary (1535), a 32-token tree
    whose last token has bit 31 set, a tree at a stale base past W·ps,
    mask-0 spans (a 40-token slice, a 300-token slice walked unsplit, a
    decode row) and an inactive row."""
    r = np.random.default_rng(seed)
    ps, w = 128, 16
    rows = [(512, _tree_masks(0)), (544, _tree_masks(1)), (576, _tree_masks(2)),
            (1000, _tree_masks(3)), (1535, _tree_masks(4)),
            (300, _tree_masks(3, 2, 14)), (w * ps + 50, _tree_masks(0)),
            (700, np.zeros(40, np.int32)), (100, np.zeros(300, np.int32)),
            (129, np.zeros(1, np.int32)), (0, np.zeros(0, np.int32))]
    q_lens = [len(m) for _, m in rows]
    q_starts, tp = tpa.pack_spans(q_lens)
    anc = np.zeros(tp, np.int32)
    for s, (_, m) in zip(q_starts, rows):
        anc[s: s + len(m)] = m
    b = len(rows)
    n_pages = b * w + 1
    q, k_new, v_new, k_pages, v_pages = _bf16(
        dev, *(r.standard_normal(s).astype(np.float32) for s in
               ((tp, h, hd), (tp, kh, hd), (tp, kh, hd), (n_pages, kh, ps, hd),
                (n_pages, kh, ps, hd))))
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)  # noqa: E731
    return dict(q=q, k_new=k_new, v_new=v_new, k_pages=k_pages,
                v_pages=v_pages,
                page_tables=i32(r.permutation(n_pages - 1)[: b * w].reshape(b, w) + 1),
                kv_lens=i32([base for base, _ in rows]), q_starts=i32(q_starts),
                q_lens=i32(q_lens), anc_masks=i32(anc))


ANC_WIDTHS = {"hd32": HD32, "hd64": dict(h=16, kh=8, hd=64),
              "hd128": dict(h=32, kh=8, hd=128), **HD256}


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("widths", sorted(ANC_WIDTHS))
def test_anc_kernels_match_plain(cuda_device, widths, int8):
    """The ancestor-mask build (bf16 and int8, every head dim and both
    Gemma groupings) against ``ragged_spans_ref(anc_masks=)`` at the split
    and tile boundaries: within TOL, pools exact, a repeat launch
    bit-identical, and each launch counted as an ancestor-mask launch."""
    x = _anc_case(cuda_device, 31, **ANC_WIDTHS[widths])
    if int8:
        s0, n = int(x["q_starts"][3]), int(x["q_lens"][3])
        x = _int8ify(x, slice(s0, s0 + n), 3, seed=32)
    counter = "launches_anc_int8" if int8 else "launches_anc"
    n0, plain0 = getattr(tpa.ragged_spans, counter), tpa.ragged_spans.launches
    got = _check_split_kernel(tpa.ragged_spans, tpa.ragged_spans_ref, x)
    assert getattr(tpa.ragged_spans, counter) == n0 + 2
    assert tpa.ragged_spans.launches == plain0
    in_span = torch.zeros(got.shape[0], dtype=torch.bool)
    for s, n in zip(x["q_starts"].tolist(), x["q_lens"].tolist()):
        in_span[s: s + n] = True
    assert not got[~in_span.to(got.device)].any()  # alignment padding


@pytest.mark.cuda
def test_anc_kernel_refuses_bad_masks(cuda_device):
    """Masks of the wrong length, type or device are refused by name."""
    x = _anc_case(cuda_device, 33, h=8, kh=4, hd=32)
    for bad in (x["anc_masks"][:-1], x["anc_masks"].long(),
                x["anc_masks"].cpu()):
        with pytest.raises(ValueError, match="ragged_spans_anc"):
            tpa.ragged_spans(**dict(x, anc_masks=bad))


# ------------------------------------------------- mixture of experts, loader

@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [1.25, 0.05])
def test_moe_mlp_on_card_matches_cpu(cuda_device, capacity):
    """``moe_mlp`` on the card against the CPU at the same f32 inputs
    (tiny-moe widths; a skewed router so capacity drops assignments): the
    same routing, outputs atol 1e-4 (f32 products in another order)."""
    import dataclasses

    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.models.transformer import init_params
    from lmrs_tpu_torch.ops import moe

    cfg = dataclasses.replace(model_preset("tiny-moe"), n_layers=1,
                              dtype="float32", expert_capacity_factor=capacity)
    lp = init_params(cfg, seed=3)["layers"][0]
    lp["router"][:, 0] = lp["router"][:, 0].abs() * 4.0
    x = torch.from_numpy(np.abs(np.random.default_rng(4).standard_normal(
        (2, 37, cfg.dim))).astype(np.float32))
    want, want_aux = moe.moe_mlp(lp, cfg, x)
    got, aux = moe.moe_mlp({k: v.to(cuda_device) for k, v in lp.items()}, cfg,
                           x.to(cuda_device))
    e_cpu = moe.route(lp["router"], cfg, x.reshape(-1, cfg.dim))[2]
    e_gpu = moe.route(lp["router"].to(cuda_device), cfg,
                      x.to(cuda_device).reshape(-1, cfg.dim))[2]
    assert torch.equal(e_cpu, e_gpu.cpu())
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_load_checkpoint_onto_card(cuda_device, tmp_path, quantize):
    """A native checkpoint written on the CPU loads onto the card leaf for
    leaf (int8: each layer quantized as it lands, equal to
    ``quantize_params`` of the plain load on the card; the card's scale
    division by 127 is a reciprocal multiply, so its scales may differ
    from the CPU's in the last bit)."""
    import dataclasses

    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.models.loader import load_checkpoint, save_checkpoint
    from lmrs_tpu_torch.models.transformer import init_params
    from lmrs_tpu_torch.ops.quant import is_quantized, quantize_params

    cfg = dataclasses.replace(model_preset("tiny-moe"), n_layers=2,
                              tie_embeddings=False)
    params = init_params(cfg, seed=5)
    save_checkpoint(str(tmp_path), params)
    got = load_checkpoint(str(tmp_path), cfg, cuda_device, quantize=quantize)
    want = params
    if quantize:
        want = quantize_params(load_checkpoint(str(tmp_path), cfg, cuda_device))

    def leaves(p):
        out = {}
        for k, v in p.items():
            for i, lp in enumerate(v if k == "layers" else [{k: v}]):
                for n, t in lp.items():
                    key = f"layers.{i}.{n}" if k == "layers" else n
                    for part, leaf in (t.items() if is_quantized(t) else [("", t)]):
                        out[key + part] = leaf
        return out

    got, want = leaves(got), leaves(want)
    assert set(got) == set(want)
    for n, y in want.items():
        x = got[n]
        assert x.device.type == "cuda" and x.dtype == y.dtype, n
        assert torch.equal(x.cpu(), y.cpu()), n


# ----------------------------------------------------------------- serving

@pytest.mark.cuda
def test_server_streams_the_card_engine(cuda_device):
    """The HTTP server over a CUDA ``TorchEngine`` (the ``tiny`` preset,
    bf16, hd 32, 2 layers, random-init): a streamed chat completion's
    deltas join to the non-streamed greedy text of the same request (the
    prefix cache is off, so both runs prefill the same shapes), and a wave
    of three requests over two slots (the third prefills beside decoding
    rows) launches flash prefill, the write-fused decode kernel and the
    span kernel."""
    import dataclasses
    import http.client
    import json
    import threading

    from lmrs_tpu_torch.config import EngineConfig, model_preset
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.serving.server import EngineHTTPServer

    cfg = dataclasses.replace(model_preset("tiny"), n_layers=2)
    eng = TorchEngine(EngineConfig(max_batch_slots=2, max_tokens=48,
                                   prefix_cache=False), cfg, device=cuda_device)
    kernels = [(tfa.flash_attention, "launches"),
               (tpa.paged_decode_fused, "launches"),
               (tpa.ragged_spans, "launches")]
    for fn, attr in kernels:
        setattr(fn, attr, 0)
    srv = EngineHTTPServer(eng, port=0, batch_window_s=0.5)
    srv.start_background()

    def post(body, out=None):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        text = conn.getresponse().read().decode()
        conn.close()
        if out is not None:
            out.append(text)
        return text

    try:
        outs = []
        # the short request frees its slot while the second decodes, so
        # the third prefills in mixed steps through the span kernel
        threads = [threading.Thread(target=post, args=({
            "messages": [{"role": "user", "content": "word " * n}],
            "max_tokens": m, "temperature": 0}, outs))
            for n, m in ((40, 4), (90, 48), (300, 48))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert len(outs) == 3 and srv.batcher.batches_run == 1
        body = {"messages": [{"role": "system", "content": "Summarize."},
                             {"role": "user", "content": "the budget " * 30}],
                "max_tokens": 48, "temperature": 0}
        plain = json.loads(post(body))["choices"][0]["message"]["content"]
        frames = post({**body, "stream": True}).split("\n\n")
        deltas = [json.loads(f[6:])["choices"][0]["delta"].get("content", "")
                  for f in frames if f.startswith("data: {")]
    finally:
        srv.shutdown()
    assert "".join(deltas) == plain
    assert eng.audit() == []
    assert all(getattr(fn, attr) > 0 for fn, attr in kernels), [
        getattr(fn, attr) for fn, attr in kernels]


# ------------------------------------------------------- KV page-set moves

def _kv_cache(dev, int8: bool):
    """A 2-layer pool at hd 128, 2 kv heads, page 32, filled with random
    values (bf16, or int8 for the int8 pool)."""
    from lmrs_tpu_torch.config import ModelConfig
    from lmrs_tpu_torch.engine.kv_cache import PagedKVCache

    cfg = ModelConfig(n_layers=2, n_heads=8, n_kv_heads=2, dim=1024)
    cache = PagedKVCache(cfg, 16, 32, 8, device=dev,
                         dtype=torch.int8 if int8 else torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(7)
    for pool in (cache.k, cache.v):
        if int8:
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=g,
                                     device=dev, dtype=torch.int8))
        else:
            pool.copy_(torch.randn(pool.shape, generator=g, device=dev))
    return cache


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_pinned_page_set_round_trip(cuda_device, int8):
    """Export through pinned buffers and import back, bit-exact, bf16 and
    int8; the sequence form through the wire codec too."""
    from lmrs_tpu_torch.engine.kv_cache import SequencePages
    from lmrs_tpu_torch.serving.handoff import decode_payload, encode_payload

    cache = _kv_cache(cuda_device, int8)
    src = [3, 7, 11]
    phys = torch.from_numpy(cache._phys_ids(src)).to(cuda_device)
    want_k, want_v = cache.k[phys].clone(), cache.v[phys].clone()
    pay = cache.export_pages(src)
    assert pay["dtype"] == ("int8" if int8 else "bfloat16")
    dst = [4, 5, 6]
    cache.import_pages(dst, pay, sync=True)
    dphys = torch.from_numpy(cache._phys_ids(dst)).to(cuda_device)
    assert torch.equal(cache.k[dphys], want_k)
    assert torch.equal(cache.v[dphys], want_v)
    seq = SequencePages(pages=src)
    wire = decode_payload(encode_payload(cache.export_sequence(seq, 70)))
    cache.allocator.alloc(12)  # leave 3 free pages for the import
    got = cache.import_sequence(wire)
    gphys = torch.from_numpy(cache._phys_ids(got.pages)).to(cuda_device)
    assert got.length == 70 and len(got.pages) == 3
    assert torch.equal(cache.k[gphys], want_k)
    assert torch.equal(cache.v[gphys], want_v)


@pytest.mark.cuda
def test_async_import_then_decode_reads_the_pages(cuda_device):
    """``import_pages(sync=False)`` followed at once by a decode launch over
    the imported pages: the same output and pool as when the pages were
    written before the launch."""
    cache = _kv_cache(cuda_device, False)
    pay = cache.export_pages([1, 2])
    ref = _kv_cache(cuda_device, False)
    dst = [9, 10]
    ref.import_pages(dst, pay, sync=True)
    r = np.random.default_rng(5)
    q, k_new, v_new = _bf16(cuda_device, *(r.standard_normal(s).astype(np.float32)
                                          for s in ((1, 8, 128), (1, 2, 128),
                                                    (1, 2, 128))))
    table = torch.tensor([dst], dtype=torch.int32, device=cuda_device)
    lens = torch.tensor([50], dtype=torch.int32, device=cuda_device)
    # layer 1's copy of the logical pages: physical page P + p
    table1 = table + cache.num_pages
    want = tpa.paged_decode_fused(q, k_new, v_new, ref.k, ref.v, table1, lens)
    cache.import_pages(dst, pay, sync=False)
    got = tpa.paged_decode_fused(q, k_new, v_new, cache.k, cache.v, table1, lens)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(cache.k, ref.k) and torch.equal(cache.v, ref.v)


@pytest.mark.cuda
def test_handoff_between_two_engines(cuda_device):
    """A prefill engine pins a handoff, its payload crosses the codec, a
    second engine imports it and decodes: the text equals the colocated
    run on that engine (greedy, the same dispatch shapes); no pins
    left, clean audits."""
    import dataclasses

    from lmrs_tpu_torch.config import EngineConfig, model_preset
    from lmrs_tpu_torch.engine.api import GenerationRequest
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.serving.handoff import decode_payload, encode_payload

    mcfg = dataclasses.replace(model_preset("tiny"), n_layers=2)
    ecfg = EngineConfig(page_size=32, num_pages=64, max_tokens=24)
    pe = TorchEngine(ecfg, mcfg, device="cuda")
    de = TorchEngine(ecfg, mcfg, device="cuda")
    req = GenerationRequest(prompt="The budget review opened the meeting. " * 6,
                            max_new_tokens=24, temperature=0.0)
    r = pe.generate_batch([dataclasses.replace(req, request_id=1,
                                               handoff_export=True)])[0]
    assert r.finish_reason == "handoff"
    payload = decode_payload(encode_payload(pe.export_handoff(1)))
    assert pe.release_handoff(1) > 0 and not pe.pinned_handoffs()
    got = de.generate_batch([dataclasses.replace(req, request_id=2,
                                                 handoff_state=payload)])[0]
    colo = de.generate_batch([dataclasses.replace(req, request_id=3)])[0]
    assert got.text == colo.text and got.completion_tokens == colo.completion_tokens
    assert not pe.audit() and not de.audit()


# ------------------------------------------------ jobs and live sessions

def _demo_transcript(n: int = 40) -> dict:
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    return load_demo_transcript(max_segments=n)


@pytest.mark.cuda
def test_job_recovers_on_card_after_torn_journal(cuda_device, tmp_path):
    """A job on a CUDA ``TorchEngine`` (``tiny``, 2 layers, bf16): after a
    simulated crash (the journal cut inside its third chunk record, no
    terminal record) a new manager over a new engine (a restarted server)
    recovers it, replay reports the torn tail, the two whole chunk records
    are reused verbatim, only the other chunks are mapped, and the job
    ends ``done`` through flash prefill and the decode kernel."""
    import dataclasses
    import json

    from lmrs_tpu_torch.config import (ChunkConfig, EngineConfig,
                                       PipelineConfig, model_preset)
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.jobs import journal as jl
    from lmrs_tpu_torch.jobs.manager import JobManager

    cfg = PipelineConfig(
        engine=EngineConfig(max_tokens=16, temperature=0.0, seed=0),
        chunk=ChunkConfig(tokenizer="byte", max_tokens_per_chunk=900,
                          overlap_tokens=0, context_tokens=100))
    mcfg = dataclasses.replace(model_preset("tiny"), n_layers=2)
    eng = TorchEngine(cfg.engine, mcfg, device=cuda_device)
    transcript = _demo_transcript()
    jm = JobManager(eng, tmp_path / "a", config=cfg, start_worker=False)
    job = jm.submit(transcript)
    jm.run_job(job)
    jm.shutdown()
    assert job.status == "done" and job.n_chunks >= 4
    lines = job.wal_path.read_bytes().split(b"\n")[:-1]
    chunks = [ln for ln in lines if json.loads(ln[9:])["type"] == "chunk_done"]
    header = [ln for ln in lines if json.loads(ln[9:])["type"] == "job_header"]
    d = tmp_path / "b"
    d.mkdir()
    (d / job.req_path.name).write_bytes(job.req_path.read_bytes())
    wal = d / job.wal_path.name
    wal.write_bytes(b"\n".join(header + chunks[:2]) + b"\n"
                    + chunks[2][: len(chunks[2]) // 2])
    assert jl.replay(wal)[1]["torn"]
    kernels = [(tfa.flash_attention, "launches"),
               (tpa.paged_decode_fused, "launches")]
    for fn, attr in kernels:
        setattr(fn, attr, 0)
    eng2 = TorchEngine(cfg.engine, mcfg, device=cuda_device)
    jm2 = JobManager(eng2, d, config=cfg, start_worker=False)
    assert jm2.recover() == 1
    resumed = jm2.get(job.job_id)
    jm2.run_job(resumed)
    jm2.shutdown()
    torch.cuda.synchronize()
    assert resumed.status == "done" and resumed.resumed_chunks == 2
    assert resumed.result["summary"]
    state = jl.rebuild_state(jl.replay(wal)[0])
    for ln in chunks[:2]:
        rec = json.loads(ln[9:])
        key = jl.chunk_key(rec["chunk_index"], rec["start_time"],
                           rec["end_time"])
        assert state["chunks"][key]["summary"] == rec["summary"]
    n_reduce = job.result["total_requests"] - job.n_chunks
    assert resumed.result["total_requests"] >= job.n_chunks - 2
    assert resumed.result["total_requests"] <= job.n_chunks - 2 + n_reduce
    assert all(getattr(fn, attr) > 0 for fn, attr in kernels), [
        getattr(fn, attr) for fn, attr in kernels]
    assert eng.audit() == [] and eng2.audit() == []


@pytest.mark.cuda
def test_session_refresh_drafts_from_hint_on_card(cuda_device, tmp_path):
    """A live session on a CUDA ``TorchEngine`` (``tiny``, 2 layers, tree
    speculation at ``speculate_k=4``): refresh 1 carries no hint, refresh
    2 carries refresh 1's summary, and its tree steps run the span
    kernel's ancestor-mask build on rows whose history sits behind a
    non-zero hint offset."""
    import dataclasses

    from lmrs_tpu_torch.config import (ChunkConfig, EngineConfig, LiveConfig,
                                       PipelineConfig, model_preset)
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.live import SessionManager

    cfg = PipelineConfig(
        engine=EngineConfig(max_tokens=24, temperature=0.0, seed=0,
                            speculate_k=4),
        chunk=ChunkConfig(tokenizer="byte", max_tokens_per_chunk=900,
                          overlap_tokens=0, context_tokens=100),
        live=LiveConfig(class_default="bulk"))
    eng = TorchEngine(cfg.engine, dataclasses.replace(
        model_preset("tiny"), n_layers=2), device=cuda_device)
    sched = eng._scheduler
    seen = {"hints": [], "hoff": []}
    dispatch, generate = sched._dispatch_spec_spans, eng.generate_batch

    def spy_dispatch(slots, rows, *a, **kw):
        seen["hoff"].append(max((slots[b].spec_hoff for b in rows), default=0))
        return dispatch(slots, rows, *a, **kw)

    def spy_generate(requests, **kw):
        seen["hints"].extend(r.draft_hint for r in requests)
        return generate(requests, **kw)

    sched._dispatch_spec_spans = spy_dispatch
    eng.generate_batch = spy_generate
    segs = _demo_transcript(60)["segments"]
    m = SessionManager(eng, tmp_path, config=cfg)
    m.create(session_id="s")
    r1 = m.append("s", segs[:30], refresh=True)["refresh"]
    assert seen["hints"] and set(seen["hints"]) == {None}
    seen["hints"], seen["hoff"] = [], []
    tpa.ragged_spans.launches_anc = 0
    r2 = m.append("s", segs[30:], refresh=True)["refresh"]
    torch.cuda.synchronize()
    m.shutdown()
    assert set(seen["hints"]) == {r1["summary"]}
    assert max(seen["hoff"]) > 0
    assert tpa.ragged_spans.launches_anc > 0
    assert r2["chunk_summaries_reused"] > 0
    assert eng.engine_metrics()["spec_tree"]["dispatches"] > 0
    assert eng.audit() == []


def _tiny_train_model(seed: int = 0):
    from lmrs_tpu_torch.config import ModelConfig

    return ModelConfig(name="t", vocab_size=96, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, hidden_dim=96, max_seq_len=64,
                       dtype="float32")


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_card_matches_cpu(cuda_device, remat):
    """One f32 training step of a tiny model on the card against the CPU
    from the same weights and batch: loss rtol 1e-4, every gradient within
    1e-4 * max(1, max |g|) (f32 products on both devices; reduction orders
    differ); no attention kernel launched."""
    from lmrs_tpu_torch.models.transformer import init_params
    from lmrs_tpu_torch.training.train import (adamw, grads_of,
                                               make_train_step, map_params,
                                               param_leaves, trainable)

    cfg = _tiny_train_model()
    base = init_params(cfg, 3)
    r = np.random.default_rng(4)
    tokens = torch.from_numpy(r.integers(0, 96, (2, 48)))
    mask = torch.from_numpy((r.random((2, 48)) < 0.8).astype(np.int32))
    out = {}
    n_flash = tfa.flash_attention.launches
    for dev in ("cpu", cuda_device):
        params = trainable(map_params(lambda t: t.clone().to(dev), base))
        step = make_train_step(cfg, adamw(params, 1e-3), remat=remat)
        loss = step(params, tokens.to(dev), mask.to(dev))
        out[str(dev)] = (float(loss), [g.cpu() for g in
                                       param_leaves(grads_of(params))])
    assert tfa.flash_attention.launches == n_flash
    (l0, g0), (l1, g1) = out["cpu"], out[str(cuda_device)]
    assert l1 == pytest.approx(l0, rel=1e-4)
    for a, b in zip(g1, g0):
        tol = 1e-4 * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol


@pytest.mark.cuda
def test_synthetic_quality_gate_trained_on_card(cuda_device):
    """The reference's synthetic quality gate (``tests/test_quality.py``)
    with a model trained on the card: bench-smoke widths in f32, 200 AdamW
    steps at 4e-3 on 16 x 320 batches (final loss < 0.5), served in bf16
    by the continuous engine through the kernels; mean ROUGE-L of the 8
    held-out prompts >= 0.30 and > 3x the lead-1 baseline, >= 0.28 with
    int8 KV pages."""
    import dataclasses
    import json
    import tempfile
    from pathlib import Path

    from lmrs_tpu_torch.config import EngineConfig, model_preset
    from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
    from lmrs_tpu_torch.engine.api import GenerationRequest
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.eval.rouge import rouge_l
    from lmrs_tpu_torch.eval.synthetic import extractive_baseline, make_dataset
    from lmrs_tpu_torch.models.transformer import init_params
    from lmrs_tpu_torch.training.cli import batches, load_examples
    from lmrs_tpu_torch.training.train import (adamw, make_train_step,
                                               map_params, trainable)

    serve_cfg = model_preset("bench-smoke")
    cfg = dataclasses.replace(serve_cfg, dtype="float32")
    tok = ByteTokenizer()
    train = make_dataset(192, seed=0)
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "train.jsonl"
        path.write_text("\n".join(json.dumps(
            {"prompt": ex["prompt"], "summary": ex["summary"]})
            for ex in train))
        seqs, masks = load_examples(str(path), tok)
    params = trainable(init_params(cfg, 0, cuda_device))
    step = make_train_step(cfg, adamw(params, 4e-3), masked=True)
    it = batches(seqs, masks, 16, 320, 0)
    for _ in range(200):
        t, m = next(it)
        loss = step(params, torch.from_numpy(t).to(cuda_device),
                    torch.from_numpy(m).to(cuda_device))
    assert float(loss) < 0.5
    served = map_params(lambda t: t.detach().to(torch.bfloat16), params)
    train_prompts = {ex["prompt"] for ex in train}
    held = [ex for ex in make_dataset(32, seed=999)
            if ex["prompt"] not in train_prompts][:8]
    reqs = [GenerationRequest(prompt=ex["prompt"], request_id=i,
                              temperature=0.0, max_new_tokens=48)
            for i, ex in enumerate(held)]
    extract = np.mean([rouge_l(extractive_baseline(ex["prompt"]),
                               ex["summary"])["f"] for ex in held])
    for kw, gate in (({}, 0.30), (dict(kv_quantize="int8", page_size=32), 0.28)):
        engine = TorchEngine(EngineConfig(max_tokens=48, max_batch_slots=4,
                                          seed=0, decode_block=8, **kw),
                             serve_cfg, device=cuda_device, params=served,
                             tokenizer=tok)
        outs = engine.generate_batch(reqs)
        score = np.mean([rouge_l(o.text, ex["summary"])["f"]
                         for ex, o in zip(held, outs)])
        assert score >= gate, (kw, score)
        if not kw:
            assert score > 3 * extract, (score, extract)


def _wedge_engine(dev):
    """A 2-layer bf16 engine on the card whose byte tokenizer never samples
    an end-of-sequence id (every request runs its whole budget)."""
    from lmrs_tpu_torch.config import EngineConfig, ModelConfig
    from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine

    class NoEos(ByteTokenizer):
        eos_id = 511

    cfg = ModelConfig(name="wd-cuda", vocab_size=512, dim=256, n_layers=2,
                      n_heads=8, n_kv_heads=2, hidden_dim=512,
                      max_seq_len=512, dtype="bfloat16")
    return TorchEngine(EngineConfig(max_tokens=64, max_batch_slots=4,
                                    page_size=32, num_pages=64, seed=0,
                                    decode_block=4, prefix_cache=False),
                       cfg, device=dev, tokenizer=NoEos())


def _wedge_reqs(n=3):
    from lmrs_tpu_torch.engine.api import GenerationRequest

    return [GenerationRequest(prompt=f"device stall probe {i}", request_id=i,
                              temperature=0.0, max_new_tokens=48)
            for i in range(n)]


@pytest.mark.cuda
def test_device_stall_is_declared_a_wedge(cuda_device, monkeypatch):
    """A sleep kernel queued on the engine's stream for several thresholds
    while a batch decodes: the dispatch thread blocks in a CUDA call (the
    fetch, or a full launch queue) with the GIL released, the caller
    declares the wedge within the threshold plus a margin, and once the
    sleep drains the engine re-arms with the undisturbed run's texts."""
    import threading
    import time

    eng = _wedge_engine(cuda_device)
    try:
        want = [r.text for r in eng.generate_batch(_wedge_reqs())]
        monkeypatch.setenv("LMRS_WATCHDOG_S", "1.0")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(int(1e8))
        end.record()
        end.synchronize()
        cycles_per_s = 1e8 / (start.elapsed_time(end) / 1e3)
        sched = eng._scheduler
        queued = {}

        def sleeper():
            deadline = time.time() + 60
            while time.time() < deadline:
                live = sched.live_tokens()
                if live and min(live.values()) >= 2:
                    break
                time.sleep(0.001)
            torch.cuda._sleep(int(4.0 * cycles_per_s))
            queued["t"] = time.monotonic()

        th = threading.Thread(target=sleeper, daemon=True)
        th.start()
        out = eng.generate_batch(_wedge_reqs())
        t_ret = time.monotonic()
        th.join(timeout=10)
        assert "t" in queued, "the sleep kernel was never queued"
        assert [r.finish_reason for r in out] == ["wedged"] * 3
        assert t_ret - queued["t"] < 1.0 + 1.0
        assert eng.wedged()
        assert eng._runner.wait_idle(60.0) and not eng.wedged()
        assert [r.text for r in eng.generate_batch(_wedge_reqs())] == want
        assert eng.audit() == []
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_host_stall_wedge_and_rearm_on_card(cuda_device, monkeypatch):
    """A ``scheduler.heartbeat`` stall on the card: ``wedged`` results, the
    engine fail-fast until the stall ends, then the same texts; the
    dispatch thread runs on the engine's device without grad mode."""
    import time

    from lmrs_tpu_torch.engine import scheduler as sched_mod
    from lmrs_tpu_torch.testing import faults
    from lmrs_tpu_torch.testing.faults import FaultPlan

    eng = _wedge_engine(cuda_device)
    seen = []
    real = sched_mod.forward_paged

    def forward(*a, **kw):
        seen.append((torch.cuda.current_device(), torch.is_grad_enabled()))
        return real(*a, **kw)

    monkeypatch.setattr(sched_mod, "forward_paged", forward)
    try:
        want = [r.text for r in eng.generate_batch(_wedge_reqs())]
        assert set(seen) == {(eng.device.index or 0, False)}
        monkeypatch.setenv("LMRS_WATCHDOG_S", "0.5")
        with faults.injected(FaultPlan(faults=[
                {"site": "scheduler.heartbeat", "at": [2],
                 "action": "stall", "stall_s": 2.0}])):
            t0 = time.monotonic()
            out = eng.generate_batch(_wedge_reqs())
            assert time.monotonic() - t0 < 1.5
        assert [r.finish_reason for r in out] == ["wedged"] * 3
        assert eng._runner.wait_idle(30.0)
        assert [r.text for r in eng.generate_batch(_wedge_reqs())] == want
        assert eng.audit() == []
    finally:
        eng.shutdown()

