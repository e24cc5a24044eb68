"""Paged attention over the page pool: CUDA kernels and their plain
PyTorch versions.

* ``paged_decode_fused`` (``csrc/paged_decode.cu``) replaces the
  reference's Pallas ``paged_decode_pallas_fused``
  (``lmrs_tpu/ops/paged_attention.py:1246``): single-token decode that
  writes the current token's K/V into its page and attends the row's live
  pages.
* ``paged_decode`` (the same source, compiled without the write) replaces
  the walk-only Pallas ``paged_decode_pallas`` (``:1566``).
* ``paged_decode_multi`` (``csrc/paged_decode_multi.cu``) replaces the
  Pallas ``paged_decode_pallas_multi`` (``:649``): the speculative verify
  step, T consecutive tokens per row written and attended with per-token
  causality.
* ``ragged_spans`` (``csrc/ragged_spans.cu``) replaces the Pallas
  ``ragged_spans_pallas`` (``:962``): one dispatch of (row, query-span)
  pairs — decode rows, a mixed step's prefill slice, continuation chunks.
  With ``anc_masks`` it runs the same source's ancestor-mask build, the
  attention of tree speculation, which the reference runs through XLA
  (``ragged_spans_xla(anc_masks=)``, ``:1154``).

Int8 pools: each writing wrapper also takes ``kscale``/``vscale`` [B, K,
hd] f32, the dispatch rows' per-(kv head, channel) scales (the reference's
``kscale``/``vscale`` operands).  The pools are then int8: new K/V rows are
quantized in the write (``ops/quant.kv_quant_tokens``; the span kernel
quantizes each flat token with its own row's scales) and every read
dequantizes — the kernels fold K's scale into q before the walk and V's
into the output after it.  Int8 pools without scales, or scales with bf16
pools, raise (the reference asserts the same).  The int8 variants count
their launches apart, in ``<wrapper>.launches_int8``.

Routing rule: a CUDA tensor goes to the kernel, a CPU tensor to the plain
version; any failure raises.  The writing ones update the pools IN PLACE
(the pools are the engine's persistent cache; the reference aliases them
through its pallas_call instead) and return the attention output.

Pool layout [P_total, K, ps, hd] (page-major, layer axis flattened into the
page axis; callers pass GLOBAL page ids).  Decode contract per row b:

* ``kv_lens[b]`` counts the current token; its K/V lands at position
  ``kv_lens[b] - 1``, i.e. ``pool[tables[b, pos // ps], :, pos % ps]``;
* the walk covers ``min(kv_lens[b], W * ps)`` tokens — a stale length past
  the table is clamped, and its write (a position past the table span) is
  skipped;
* ``kv_lens[b] == 0`` writes nothing and outputs zeros.

The multi-token and span contracts are in ``paged_decode_multi``' and
``ragged_spans``' docstrings.

Split-sequence kernels: the decode kernels walk each row in splits of
``decode_split(B, K)`` tokens (``DECODE_SPLIT``, halved for a launch of
few (row, kv head) groups), the span kernel's attention pass each query
tile's columns in splits of ``SPAN_SPLIT`` (spans of at most
``SPAN_SPLIT_TILES`` query tiles) and the verify kernel each row's columns
in splits of ``MULTI_SPLIT``, one block per split; the number of splits
comes from shapes alone (``W * ps``, ``max_pos``), never from reading
``kv_lens`` on the host.  Each wrapper hands its kernel an f32 scratch
(``torch.empty``) for the splits' partial softmax states and a cached int32
counter buffer that the kernels leave zero; the last block of a split
group merges the partials in split order, so repeated launches are
bit-identical.  Launches that share the counters must be ordered: the port
runs them on one stream.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lmrs_tpu_torch.ops import kernels
from lmrs_tpu_torch.ops.quant import kv_dequant, kv_quant, kv_quant_tokens

NEG_INF = -1e30
# Alignment of the span starts in the flat token buffer (the reference's
# query-tile height); kept so both packages pack spans identically.
SPAN_QT = 8
# tokens per decode split and columns per span and verify split (multiples
# of the kernels' 32-token and 64-column tiles; csrc/paged_decode.cu,
# csrc/ragged_spans.cu, csrc/paged_decode_multi.cu)
DECODE_SPLIT = 256
SPAN_SPLIT = 512
# a decode launch with fewer (row, kv head) groups than this walks splits of
# DECODE_SPLIT // 2 tokens: at one kv head (gemma-2b's 8 rows x 1,501
# tokens) 256-token splits give 48 live blocks for 132 SMs, and 128-token
# ones took 28% less time on the card (PERF.md)
DECODE_FILL_GROUPS = 16
MULTI_SPLIT = 256
# query rows of a span attention block (span tokens x the n_rep heads)
SPAN_QROWS = 64
# spans of at most this many query tiles split their walks (decode rows,
# short spans); longer ones walk whole, their tiles being parallel already,
# which keeps the span scratch independent of the dispatch's token count
SPAN_SPLIT_TILES = 4

_counters: dict[torch.device, torch.Tensor] = {}


def _split_counters(dev: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 split counters on ``dev``: zero when made, and
    every launch leaves them zero (the last block of a group resets its
    own).  One buffer per device, grown when a launch needs more."""
    buf = _counters.get(dev)
    if buf is None or buf.numel() < n:
        buf = _counters[dev] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=dev)
    return buf


def decode_split(rows: int, kh: int) -> int:
    """Tokens per split of a decode launch over ``rows`` rows and ``kh`` kv
    heads, from shapes alone (a multiple of the kernel's 32-token tile)."""
    return DECODE_SPLIT if rows * kh >= DECODE_FILL_GROUPS else DECODE_SPLIT // 2


def paged_decode_ref(
    q: torch.Tensor,            # [B, H, hd]
    k_pages: torch.Tensor,      # [P, K, ps, hd]
    v_pages: torch.Tensor,      # [P, K, ps, hd]
    page_tables: torch.Tensor,  # [B, W] page ids
    kv_lens: torch.Tensor,      # [B] tokens in cache (incl. current)
    kscale: torch.Tensor | None = None,  # [B, K, hd] f32 (int8 pools)
    vscale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gather-softmax over each row's page window (the port of the
    reference's ``paged_decode_xla``; int8 pools dequantized with the rows'
    scales), with the length clamped to the table and zero output for empty
    rows.  Scores, softmax and the P·V product in f32, as in the kernels."""
    b, h, hd = q.shape
    _, kh, ps, _ = k_pages.shape
    w = page_tables.shape[1]
    tables = page_tables.long()
    k = k_pages[tables].permute(0, 1, 3, 2, 4).reshape(b, w * ps, kh, hd)
    v = v_pages[tables].permute(0, 1, 3, 2, 4).reshape(b, w * ps, kh, hd)
    if kscale is not None:  # in f32: the twin's cast to q's dtype would
        # round K and V to bf16 on the card, where the kernels do not
        k = kv_dequant(k, kscale, torch.float32)
        v = kv_dequant(v, vscale, torch.float32)
    n_rep = h // kh
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
        v = torch.repeat_interleave(v, n_rep, dim=2)
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * hd ** -0.5
    lens = torch.clamp(kv_lens.long(), max=w * ps)
    mask = torch.arange(w * ps, device=q.device)[None, None, :] < lens[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs, v.float()).to(q.dtype)
    return torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))


def _write_new_tokens(k_new, v_new, k_pages, v_pages, page_tables, kv_lens,
                      kscale=None, vscale=None):
    """Scatter each row's current-token K/V into its page, in place (int8
    pools: quantized with the rows' scales); rows whose position lies
    outside [0, W * ps) are not written."""
    if kscale is not None:
        k_new = kv_quant_tokens(k_new, kscale)
        v_new = kv_quant_tokens(v_new, vscale)
    ps = k_pages.shape[2]
    w = page_tables.shape[1]
    pos = kv_lens.long() - 1
    ok = (pos >= 0) & (pos < w * ps)
    rows = torch.nonzero(ok).flatten()
    if rows.numel():
        p = pos[rows]
        page = page_tables.long()[rows, p // ps]
        k_pages[page, :, p % ps] = k_new[rows]
        v_pages[page, :, p % ps] = v_new[rows]


def paged_decode_fused_ref(
    q: torch.Tensor,            # [B, H, hd]
    k_new: torch.Tensor,        # [B, K, hd] current token K (post-rope)
    v_new: torch.Tensor,        # [B, K, hd]
    k_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    v_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    page_tables: torch.Tensor,  # [B, W] GLOBAL page ids
    kv_lens: torch.Tensor,      # [B] incl. current token
    kscale: torch.Tensor | None = None,  # [B, K, hd] f32 (int8 pools)
    vscale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: scatter (quantized for int8 pools), then
    gather-softmax."""
    _write_new_tokens(k_new, v_new, k_pages, v_pages, page_tables, kv_lens,
                      kscale, vscale)
    return paged_decode_ref(q, k_pages, v_pages, page_tables, kv_lens,
                            kscale, vscale)


def _check(op: str, dev: torch.device, dtype: torch.dtype,
           **tensors) -> None:
    for name, t in tensors.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous {dtype} on {dev}")


def _check_quant(op: str, k_pages, v_pages, kscale, vscale) -> bool:
    """True for int8 pools; raises unless int8 pools come with both scale
    tensors and scales come only with int8 pools."""
    quantized = kscale is not None
    if (vscale is not None) != quantized:
        raise ValueError(f"{op}: kscale and vscale come together")
    if quantized != (k_pages.dtype == torch.int8) or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"{op}: int8 pools need kscale/vscale and scales "
                         f"need int8 pools (pools {k_pages.dtype}, scales "
                         f"{'given' if quantized else 'absent'})")
    return quantized


def _scale_args(op: str, dev, kscale, vscale, rows: int, kh: int,
                hd: int) -> list[int]:
    """The scales' device pointers for an int8 kernel ([] for bf16)."""
    if kscale is None:
        return []
    for name, t in (("kscale", kscale), ("vscale", vscale)):
        if t.shape != (rows, kh, hd):
            raise ValueError(f"{op}: {name} must be [{rows}, {kh}, {hd}] "
                             f"(got {tuple(t.shape)})")
    _check(op, dev, torch.float32, kscale=kscale, vscale=vscale)
    return [kscale.data_ptr(), vscale.data_ptr()]


def _decode_cuda(q, k_new, v_new, k_pages, v_pages, page_tables, kv_lens,
                 kscale=None, vscale=None):
    """The decode kernels of ``csrc/paged_decode.cu``: write-fused (bf16 or
    int8 pools), or walk-only when ``k_new`` is None."""
    quant = kscale is not None
    op = ("paged_decode" if k_new is None else
          "paged_decode_fused_int8" if quant else "paged_decode_fused")
    b, h, hd = q.shape
    _, kh, ps, _ = k_pages.shape
    w = page_tables.shape[1]
    new = {} if k_new is None else {"k_new": k_new, "v_new": v_new}
    if (any(t.shape != (b, kh, hd) for t in new.values())
            or v_pages.shape != k_pages.shape or k_pages.shape[3] != hd):
        raise ValueError(f"{op}: shape mismatch among q {tuple(q.shape)}, "
                         f"k_new {None if k_new is None else tuple(k_new.shape)}, "
                         f"pools {tuple(k_pages.shape)}")
    kernels.check_shapes(op, hd, h, kh, page_size=ps)
    _check(op, q.device, torch.bfloat16, q=q, **new)
    _check(op, q.device, torch.int8 if quant else torch.bfloat16,
           k_pages=k_pages, v_pages=v_pages)
    scales = _scale_args(op, q.device, kscale, vscale, b, kh, hd)
    if page_tables.shape[0] != b or kv_lens.shape != (b,):
        raise ValueError(f"{op}: tables/kv_lens rows != batch")
    tables = page_tables.to(device=q.device, dtype=torch.int32).contiguous()
    lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    split = decode_split(b, kh)
    n_split = -(-(w * ps) // split)  # from shapes: no host read
    part = torch.empty(b * kh * n_split * (h // kh) * (hd + 2),
                       dtype=torch.float32, device=q.device)
    counters = _split_counters(q.device, b * kh)
    lib = kernels.load("paged_decode")
    tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    args = (tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), b, h, kh, hd, ps, w,
            split, hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if k_new is None:
        name = "lmrs_paged_decode_bf16"
        ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    else:
        name = ("lmrs_paged_decode_fused_int8" if quant
                else "lmrs_paged_decode_fused_bf16")
        ptrs = [q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                k_pages.data_ptr(), v_pages.data_ptr(), *scales]
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * (len(ptrs) + 5) + tail
    fn.restype = ctypes.c_int
    kernels.check_launch(name, fn(*ptrs, *args))
    if k_new is None:
        paged_decode.launches += 1
    elif quant:
        paged_decode_fused.launches_int8 += 1
    else:
        paged_decode_fused.launches += 1
    return out


def paged_decode(
    q: torch.Tensor,            # [B, H, hd]
    k_pages: torch.Tensor,      # [P_total, K, ps, hd]
    v_pages: torch.Tensor,      # [P_total, K, ps, hd]
    page_tables: torch.Tensor,  # [B, W] GLOBAL page ids
    kv_lens: torch.Tensor,      # [B] tokens in cache
) -> torch.Tensor:
    """Walk-only paged decode: attend each row's live pages, no write (the
    contract of ``paged_decode_ref``: length clamped to W·ps, zero output
    for an empty row).  Returns [B, H, hd]; ``paged_decode.launches`` counts
    kernel launches.  bf16 pools only: the reference's walk-only kernel
    has no scale operand."""
    if q.is_cuda:
        return _decode_cuda(q, None, None, k_pages, v_pages, page_tables,
                            kv_lens)
    return paged_decode_ref(q, k_pages, v_pages, page_tables, kv_lens)


paged_decode.launches = 0


def paged_decode_fused(
    q: torch.Tensor,            # [B, H, hd]
    k_new: torch.Tensor,        # [B, K, hd]
    v_new: torch.Tensor,        # [B, K, hd]
    k_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    v_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    page_tables: torch.Tensor,  # [B, W] GLOBAL page ids
    kv_lens: torch.Tensor,      # [B] incl. current token
    kscale: torch.Tensor | None = None,  # [B, K, hd] f32 (int8 pools)
    vscale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Write-fused paged decode (see module doc).  Returns [B, H, hd].
    ``paged_decode_fused.launches`` counts the bf16 kernel's launches,
    ``.launches_int8`` the int8 one's."""
    _check_quant("paged_decode_fused", k_pages, v_pages, kscale, vscale)
    if q.is_cuda:
        return _decode_cuda(q, k_new, v_new, k_pages, v_pages, page_tables,
                            kv_lens, kscale, vscale)
    return paged_decode_fused_ref(q, k_new, v_new, k_pages, v_pages,
                                  page_tables, kv_lens, kscale, vscale)


paged_decode_fused.launches = 0
paged_decode_fused.launches_int8 = 0


# ---------------------------------------------- multi-token verify kernel


def paged_decode_multi_ref(
    q: torch.Tensor,            # [B, T, H, hd]
    k_new: torch.Tensor,        # [B, T, K, hd] the T tokens' K (post-rope)
    v_new: torch.Tensor,        # [B, T, K, hd]
    k_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    v_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    page_tables: torch.Tensor,  # [B, W] GLOBAL page ids
    kv_lens: torch.Tensor,      # [B] incl. the T tokens (unclamped)
    max_pos: int | None = None,
    kscale: torch.Tensor | None = None,  # [B, K, hd] f32 (int8 pools)
    vscale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version (the port of the reference's
    ``paged_decode_multi_xla``): scatter the in-span tokens (int8 pools:
    quantized with the rows' scales), then gather-softmax each row's window
    (int8: dequantized in f32) with per-token causal limits.  Scores and
    softmax in f32.  An out-of-span token is skipped, where the XLA twin parks it on
    the null page."""
    if kscale is not None:
        k_new, v_new = kv_quant(k_new, kscale), kv_quant(v_new, vscale)
    b, t, h, hd = q.shape
    _, kh, ps, _ = k_pages.shape
    w = page_tables.shape[1]
    cap = w * ps if max_pos is None else min(w * ps, max_pos)
    tables = page_tables.long()
    base = torch.clamp(kv_lens.long() - t, min=0)
    pos = base[:, None] + torch.arange(t, device=q.device)[None]  # [B, T]
    rows, toks = torch.nonzero(pos < cap, as_tuple=True)
    p = pos[rows, toks]
    page = tables[rows, p // ps]
    k_pages[page, :, p % ps] = k_new[rows, toks]
    v_pages[page, :, p % ps] = v_new[rows, toks]
    n_rep = h // kh
    # [B, W, K, ps, hd] -> [B, W*ps, K, hd] (int8: dequantized in f32)
    kw = k_pages[tables].permute(0, 1, 3, 2, 4).reshape(b, w * ps, kh, hd)
    vw = v_pages[tables].permute(0, 1, 3, 2, 4).reshape(b, w * ps, kh, hd)
    if kscale is not None:
        kw = kv_dequant(kw, kscale, torch.float32)
        vw = kv_dequant(vw, vscale, torch.float32)
    kw, vw = kw.transpose(1, 2), vw.transpose(1, 2)  # [B, K, W*ps, hd]
    qg = q.reshape(b, t, kh, n_rep, hd).permute(0, 2, 3, 1, 4)  # [B,K,n,T,hd]
    logits = torch.matmul(qg.float(), kw.float().transpose(-1, -2)[:, :, None])
    col = torch.arange(w * ps, device=q.device)
    mask = (col[None, None] <= pos[:, :, None]) & (col < cap)  # [B, T, C]
    logits = torch.where(mask[:, None, None], logits * hd ** -0.5,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    o = torch.matmul(probs, vw.float()[:, :, None])  # [B, K, n_rep, T, hd]
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(q.dtype)


def _multi_cuda(q, k_new, v_new, k_pages, v_pages, page_tables, kv_lens,
                max_pos, kscale=None, vscale=None):
    quant = kscale is not None
    op = "paged_decode_multi_int8" if quant else "paged_decode_multi"
    b, t, h, hd = q.shape
    _, kh, ps, _ = k_pages.shape
    w = page_tables.shape[1]
    if (k_new.shape != (b, t, kh, hd) or v_new.shape != k_new.shape
            or v_pages.shape != k_pages.shape or k_pages.shape[3] != hd):
        raise ValueError(f"{op}: shape mismatch among q "
                         f"{tuple(q.shape)}, k_new {tuple(k_new.shape)}, "
                         f"pools {tuple(k_pages.shape)}")
    kernels.check_shapes(op, hd, h, kh, verify_tokens=t)
    _check(op, q.device, torch.bfloat16, q=q, k_new=k_new, v_new=v_new)
    _check(op, q.device, torch.int8 if quant else torch.bfloat16,
           k_pages=k_pages, v_pages=v_pages)
    scales = _scale_args(op, q.device, kscale, vscale, b, kh, hd)
    if page_tables.shape[0] != b or kv_lens.shape != (b,):
        raise ValueError(f"{op}: tables/kv_lens rows != batch")
    tables = page_tables.to(device=q.device, dtype=torch.int32).contiguous()
    lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    # the splits' partial states, from shapes alone: T x H/K query rows per
    # (row, kv head, split of the columns below min(W·ps, max_pos))
    pos_cap = w * ps if max_pos is None else max_pos
    n_split = max(-(-min(w * ps, pos_cap) // MULTI_SPLIT), 1)
    part = torch.empty(b * kh * n_split * t * (h // kh) * (hd + 2),
                       dtype=torch.float32, device=q.device)
    counters = _split_counters(q.device, b * kh)
    name = ("lmrs_paged_decode_multi_int8" if quant
            else "lmrs_paged_decode_multi_bf16")
    fn = getattr(kernels.load("paged_decode_multi"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (10 + len(scales)) + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), *scales, tables.data_ptr(),
            lens.data_ptr(), out.data_ptr(), part.data_ptr(),
            counters.data_ptr(), b, t, h, kh, hd, ps, w, pos_cap, MULTI_SPLIT,
            hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(name, rc)
    if quant:
        paged_decode_multi.launches_int8 += 1
    else:
        paged_decode_multi.launches += 1
    return out


def paged_decode_multi(
    q: torch.Tensor,            # [B, T, H, hd]
    k_new: torch.Tensor,        # [B, T, K, hd]
    v_new: torch.Tensor,        # [B, T, K, hd]
    k_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    v_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    page_tables: torch.Tensor,  # [B, W] GLOBAL page ids
    kv_lens: torch.Tensor,      # [B] incl. the T tokens (unclamped)
    max_pos: int | None = None,
    kscale: torch.Tensor | None = None,  # [B, K, hd] f32 (int8 pools)
    vscale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-token verify (speculative decoding): returns [B, T, H, hd];
    ``paged_decode_multi.launches`` counts the bf16 kernel's launches,
    ``.launches_int8`` the int8 one's.  Contract:

    * ``base = max(kv_lens[b] - T, 0)`` and token j sits at ``base + j``
      (callers pass the UNclamped length, so base is the true position
      even when the tokens overhang ``max_pos``);
    * a token is written only when its position is ``< W * ps`` and
      ``< max_pos`` (skipped otherwise; the pool elsewhere is untouched);
    * query token j attends columns ``<= base + j`` and ``< max_pos``.

    Rows whose table is the null page (the scheduler's empty slots) write
    page 0 concurrently on the card; their outputs are not used."""
    _check_quant("paged_decode_multi", k_pages, v_pages, kscale, vscale)
    if q.is_cuda:
        return _multi_cuda(q, k_new, v_new, k_pages, v_pages, page_tables,
                           kv_lens, max_pos, kscale, vscale)
    return paged_decode_multi_ref(q, k_new, v_new, k_pages, v_pages,
                                  page_tables, kv_lens, max_pos, kscale,
                                  vscale)


paged_decode_multi.launches = 0
paged_decode_multi.launches_int8 = 0


# ------------------------------------------------------- ragged span kernel


def pack_spans(q_lens: np.ndarray | list[int],
               floor: int = 16) -> tuple[np.ndarray, int]:
    """Host-side span packer: per-row query lengths (0 = inactive row) ->
    ``(q_starts, total)``; span i occupies flat tokens [q_starts[i],
    q_starts[i] + q_lens[i]) of a buffer whose spans start SPAN_QT-aligned,
    and ``total`` is the aligned token count (at least ``floor``)."""
    q_lens = np.asarray(q_lens, np.int64)
    aligned = -(-q_lens // SPAN_QT) * SPAN_QT
    q_starts = np.concatenate([[0], np.cumsum(aligned)[:-1]])
    return q_starts.astype(np.int32), int(max(floor, aligned.sum()))


def ragged_spans_ref(
    q: torch.Tensor,            # [Tp, H, hd] flat query tokens (all spans)
    k_new: torch.Tensor,        # [Tp, K, hd] the tokens' K (post-rope)
    v_new: torch.Tensor,        # [Tp, K, hd]
    k_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    v_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    page_tables: torch.Tensor,  # [B, W] GLOBAL page ids
    kv_lens: torch.Tensor,      # [B] context BEFORE this dispatch
    q_starts: torch.Tensor,     # [B] flat span offsets
    q_lens: torch.Tensor,       # [B] span lengths (0 = inactive row)
    max_pos: int | None = None,
    kscale: torch.Tensor | None = None,  # [B, K, hd] f32 (int8 pools)
    vscale: torch.Tensor | None = None,
    anc_masks: torch.Tensor | None = None,  # [Tp] int32 ancestor bitmasks
) -> torch.Tensor:
    """Plain PyTorch version (the port of the reference's
    ``ragged_spans_xla``): every row's in-span writes first (int8 pools:
    each token quantized with its own row's scales), then each row's span
    attends its page window (int8: dequantized in f32 with the row's
    scales) with per-token causal limits — or, for a token whose
    ``anc_masks`` word is nonzero, the row's columns below ``kv_lens[b]``
    plus exactly the span offsets in [0, 32) whose bit is set (the
    reference's rule, ``ragged_spans_xla`` ``:1229-1234``; the word is read
    as uint32, so bit 31 counts).  Scores and softmax in f32."""
    tp, h, hd = q.shape
    _, kh, ps, _ = k_pages.shape
    b, w = page_tables.shape
    n_rep = h // kh
    cap = w * ps if max_pos is None else min(w * ps, max_pos)
    tables = page_tables.long()
    # the plain version walks its rows on the host: one fetch a call
    starts, lens, bases = (x.tolist() for x in (q_starts, q_lens, kv_lens))  # lint: ignore[tracing.host-sync-in-step]
    rows = [r for r in range(b) if lens[r] > 0]
    out = torch.zeros_like(q)
    for r in rows:  # 1. writes: in-span tokens at positions < cap only
        pos = bases[r] + torch.arange(lens[r], device=q.device)
        keep = torch.nonzero(pos < cap).flatten()
        p = pos[keep]
        page = tables[r, p // ps]
        kr, vr = k_new[starts[r] + keep], v_new[starts[r] + keep]
        if kscale is not None:
            kr = kv_quant_tokens(kr, kscale[r])
            vr = kv_quant_tokens(vr, vscale[r])
        k_pages[page, :, p % ps] = kr
        v_pages[page, :, p % ps] = vr
    col = torch.arange(w * ps, device=q.device)
    for r in rows:  # 2. attention over the row's window
        s, n = starts[r], lens[r]
        # [W, K, ps, hd] -> [1, W*ps, K, hd] (int8: dequantized in f32)
        kw = k_pages[tables[r]].permute(0, 2, 1, 3).reshape(1, w * ps, kh, hd)
        vw = v_pages[tables[r]].permute(0, 2, 1, 3).reshape(1, w * ps, kh, hd)
        if kscale is not None:
            kw = kv_dequant(kw, kscale[r:r + 1], torch.float32)
            vw = kv_dequant(vw, vscale[r:r + 1], torch.float32)
        kw, vw = kw[0].transpose(0, 1), vw[0].transpose(0, 1)  # [K, W*ps, hd]
        qr = q[s:s + n].reshape(n, kh, n_rep, hd).permute(1, 2, 0, 3)
        logits = torch.matmul(qr.float(), kw.float().transpose(1, 2)[:, None])
        pos = bases[r] + torch.arange(n, device=q.device)
        mask = col[None, :] <= pos[:, None]
        if anc_masks is not None:
            a = anc_masks[s:s + n].long() & 0xFFFFFFFF  # the uint32 word
            off = col[None, :] - bases[r]
            bit = (a[:, None] >> torch.clamp(off, 0, 31)) & 1
            tree = (off < 0) | ((off < 32) & (bit == 1))
            mask = torch.where(a[:, None] == 0, mask, tree)
        mask = mask & (col[None, :] < cap)
        logits = torch.where(mask, logits * hd ** -0.5,
                             torch.full_like(logits, NEG_INF))
        probs = torch.softmax(logits, dim=-1) * mask.any(-1, keepdim=True)
        o = torch.matmul(probs, vw.float()[:, None])  # [kh, n_rep, n, hd]
        out[s:s + n] = o.permute(2, 0, 1, 3).reshape(n, h, hd).to(q.dtype)
    return out


def _spans_cuda(q, k_new, v_new, k_pages, v_pages, page_tables, kv_lens,
                q_starts, q_lens, max_pos, kscale=None, vscale=None,
                anc_masks=None):
    quant, anc = kscale is not None, anc_masks is not None
    op = "ragged_spans" + ("_anc" if anc else "") + ("_int8" if quant else "")
    tp, h, hd = q.shape
    _, kh, ps, _ = k_pages.shape
    b, w = page_tables.shape
    if (k_new.shape != (tp, kh, hd) or v_new.shape != k_new.shape
            or v_pages.shape != k_pages.shape or k_pages.shape[3] != hd):
        raise ValueError(f"{op}: shape mismatch among q "
                         f"{tuple(q.shape)}, k_new {tuple(k_new.shape)}, "
                         f"pools {tuple(k_pages.shape)}")
    kernels.check_shapes(op, hd, h, kh)
    _check(op, q.device, torch.bfloat16, q=q, k_new=k_new, v_new=v_new)
    _check(op, q.device, torch.int8 if quant else torch.bfloat16,
           k_pages=k_pages, v_pages=v_pages)
    scales = _scale_args(op, q.device, kscale, vscale, b, kh, hd)
    idx = [x.to(device=q.device, dtype=torch.int32).contiguous()
           for x in (page_tables, kv_lens, q_starts, q_lens)]
    if any(x.shape != (b,) for x in idx[1:]):
        raise ValueError(f"{op}: kv_lens/q_starts/q_lens must be [{b}]")
    if anc:
        if anc_masks.shape != (tp,):
            raise ValueError(f"{op}: anc_masks must be [{tp}] (got "
                             f"{tuple(anc_masks.shape)})")
        _check(op, q.device, torch.int32, anc_masks=anc_masks)
        idx.append(anc_masks)
    out = torch.empty_like(q)
    # the attention pass's split scratch, from shapes alone: the split
    # rows' query tiles (B x SPAN_SPLIT_TILES) x splits of the columns
    pos_cap = w * ps if max_pos is None else max_pos
    cap = min(w * ps, pos_cap)
    n_split = -(-cap // SPAN_SPLIT) if cap > 0 else 1
    groups = kh * b * SPAN_SPLIT_TILES
    part = torch.empty(groups * n_split * SPAN_QROWS * (hd + 2),
                       dtype=torch.float32, device=q.device)
    counters = _split_counters(q.device, groups)
    lib = "ragged_spans_anc" if anc else "ragged_spans"
    name = f"lmrs_{lib}_{'int8' if quant else 'bf16'}"
    fn = getattr(kernels.load(lib), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (12 + len(scales) + anc) + [
        ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), *scales,
            *(x.data_ptr() for x in idx), out.data_ptr(), part.data_ptr(),
            counters.data_ptr(), tp, b, h, kh, hd, ps, w, pos_cap,
            SPAN_SPLIT, SPAN_SPLIT_TILES, hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(name, rc)
    counter = "launches" + ("_anc" if anc else "") + ("_int8" if quant else "")
    setattr(ragged_spans, counter, getattr(ragged_spans, counter) + 1)
    return out


def ragged_spans(
    q: torch.Tensor,            # [Tp, H, hd]
    k_new: torch.Tensor,        # [Tp, K, hd]
    v_new: torch.Tensor,        # [Tp, K, hd]
    k_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    v_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    page_tables: torch.Tensor,  # [B, W] GLOBAL page ids
    kv_lens: torch.Tensor,      # [B] context BEFORE this dispatch
    q_starts: torch.Tensor,     # [B] flat span offsets
    q_lens: torch.Tensor,       # [B] span lengths (0 = inactive row)
    max_pos: int | None = None,
    kscale: torch.Tensor | None = None,  # [B, K, hd] f32 (int8 pools)
    vscale: torch.Tensor | None = None,
    anc_masks: torch.Tensor | None = None,  # [Tp] int32 ancestor bitmasks
) -> torch.Tensor:
    """One ragged dispatch of (row, query-span) pairs.  Returns [Tp, H, hd];
    ``ragged_spans.launches`` counts the bf16 kernel's launches,
    ``.launches_int8`` the int8 one's, ``.launches_anc`` and
    ``.launches_anc_int8`` those of the ancestor-mask build.  Contract:

    * token j of row b is flat token ``q_starts[b] + j`` and sits at
      absolute position ``kv_lens[b] + j``;
    * only in-span tokens are written, and only at positions ``< W * ps``
      and ``< max_pos`` (the pool elsewhere is untouched);
    * an in-span token attends columns ``col <= its position`` and
      ``col < min(W * ps, max_pos)`` of its row's table;
    * a flat token of no span gets a zero output row; a ``q_len == 0`` row
      is skipped;
    * ``anc_masks`` (tree speculation): a token whose word is nonzero
      attends its row's columns ``< kv_lens[b]`` and exactly the span
      offsets ``col - kv_lens[b]`` in [0, 32) whose bit is set (bit 31
      included); a token with word 0 keeps the causal rule.  A tree's
      words set only ancestors, at or below the token's own offset: the
      kernel walks a query tile's columns up to the tile's last token, so
      bits past that column are not read there.

    The reference's Pallas kernel differs in two places the consumer never
    reads: it writes tile-padding K/V at future positions and leaves
    out-of-span output rows untouched."""
    _check_quant("ragged_spans", k_pages, v_pages, kscale, vscale)
    if q.is_cuda:
        return _spans_cuda(q, k_new, v_new, k_pages, v_pages, page_tables,
                           kv_lens, q_starts, q_lens, max_pos, kscale, vscale,
                           anc_masks)
    return ragged_spans_ref(q, k_new, v_new, k_pages, v_pages, page_tables,
                            kv_lens, q_starts, q_lens, max_pos, kscale, vscale,
                            anc_masks)


ragged_spans.launches = 0
ragged_spans.launches_int8 = 0
ragged_spans.launches_anc = 0
ragged_spans.launches_anc_int8 = 0
