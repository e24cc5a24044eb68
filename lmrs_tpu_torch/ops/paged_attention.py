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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

NEG_INF = -1e30
# Alignment of the span starts in the flat token buffer (the reference's
# query-tile height); kept so both packages pack spans identically.
SPAN_QT = 8


def paged_decode_ref(
    q: torch.Tensor,            # [B, H, hd]
    k_pages: torch.Tensor,      # [P, K, ps, hd]
    v_pages: torch.Tensor,      # [P, K, ps, hd]
    page_tables: torch.Tensor,  # [B, W] page ids
    kv_lens: torch.Tensor,      # [B] tokens in cache (incl. current)
) -> torch.Tensor:
    """Gather-softmax over each row's page window (the port of the
    reference's ``paged_decode_xla``), with the length clamped to the table
    and zero output for empty rows."""
    b, h, hd = q.shape
    _, kh, ps, _ = k_pages.shape
    w = page_tables.shape[1]
    tables = page_tables.long()
    k = k_pages[tables].permute(0, 1, 3, 2, 4).reshape(b, w * ps, kh, hd)
    v = v_pages[tables].permute(0, 1, 3, 2, 4).reshape(b, w * ps, kh, hd)
    n_rep = h // kh
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
        v = torch.repeat_interleave(v, n_rep, dim=2)
    logits = torch.einsum("bhd,bkhd->bhk", q, k).float() * hd ** -0.5
    lens = torch.clamp(kv_lens.long(), max=w * ps)
    mask = torch.arange(w * ps, device=q.device)[None, None, :] < lens[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs.to(v.dtype), v)
    return torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))


def _write_new_tokens(k_new, v_new, k_pages, v_pages, page_tables, kv_lens):
    """Scatter each row's current-token K/V into its page, in place; rows
    whose position lies outside [0, W * ps) are not written."""
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
) -> torch.Tensor:
    """Plain PyTorch version: scatter, then gather-softmax."""
    _write_new_tokens(k_new, v_new, k_pages, v_pages, page_tables, kv_lens)
    return paged_decode_ref(q, k_pages, v_pages, page_tables, kv_lens)


def _check_bf16(op: str, dev, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous bfloat16 on {dev}")


def _decode_cuda(q, k_new, v_new, k_pages, v_pages, page_tables, kv_lens):
    """Both decode kernels of ``csrc/paged_decode.cu``: write-fused, or
    walk-only when ``k_new`` is None."""
    from lmrs_tpu_torch.ops import kernels

    op = "paged_decode" if k_new is None else "paged_decode_fused"
    b, h, hd = q.shape
    _, kh, ps, _ = k_pages.shape
    w = page_tables.shape[1]
    new = {} if k_new is None else {"k_new": k_new, "v_new": v_new}
    if (any(t.shape != (b, kh, hd) for t in new.values())
            or v_pages.shape != k_pages.shape or k_pages.shape[3] != hd):
        raise ValueError(f"{op}: shape mismatch among q {tuple(q.shape)}, "
                         f"k_new {None if k_new is None else tuple(k_new.shape)}, "
                         f"pools {tuple(k_pages.shape)}")
    if hd not in (64, 128) or h % kh or (h // kh) not in (1, 2, 4, 8) or ps % 32:
        raise ValueError(f"{op} kernel takes hd in (64, 128), "
                         f"H/K in (1, 2, 4, 8), page_size % 32 == 0 (got "
                         f"hd={hd}, H={h}, K={kh}, ps={ps})")
    _check_bf16(op, q.device, q=q, k_pages=k_pages, v_pages=v_pages, **new)
    if page_tables.shape[0] != b or kv_lens.shape != (b,):
        raise ValueError(f"{op}: tables/kv_lens rows != batch")
    tables = page_tables.to(device=q.device, dtype=torch.int32).contiguous()
    lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = kernels.load("paged_decode")
    tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    args = (tables.data_ptr(), lens.data_ptr(), out.data_ptr(), b, h, kh, hd,
            ps, w, hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if k_new is None:
        fn = lib.lmrs_paged_decode_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + tail
        fn.restype = ctypes.c_int
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *args)
        kernels.check_launch("lmrs_paged_decode_bf16", rc)
        paged_decode.launches += 1
    else:
        fn = lib.lmrs_paged_decode_fused_bf16
        fn.argtypes = [ctypes.c_void_p] * 8 + tail
        fn.restype = ctypes.c_int
        rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                k_pages.data_ptr(), v_pages.data_ptr(), *args)
        kernels.check_launch("lmrs_paged_decode_fused_bf16", rc)
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
    kernel launches."""
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
) -> torch.Tensor:
    """Write-fused paged decode (see module doc).  Returns [B, H, hd].
    ``paged_decode_fused.launches`` counts kernel launches."""
    if q.is_cuda:
        return _decode_cuda(q, k_new, v_new, k_pages, v_pages, page_tables,
                            kv_lens)
    return paged_decode_fused_ref(q, k_new, v_new, k_pages, v_pages,
                                  page_tables, kv_lens)


paged_decode_fused.launches = 0


# ---------------------------------------------- multi-token verify kernel

# query rows (T tokens x H/K heads) the multi kernel holds per kv head
MULTI_QROWS = 64


def paged_decode_multi_ref(
    q: torch.Tensor,            # [B, T, H, hd]
    k_new: torch.Tensor,        # [B, T, K, hd] the T tokens' K (post-rope)
    v_new: torch.Tensor,        # [B, T, K, hd]
    k_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    v_pages: torch.Tensor,      # [P_total, K, ps, hd] (updated in place)
    page_tables: torch.Tensor,  # [B, W] GLOBAL page ids
    kv_lens: torch.Tensor,      # [B] incl. the T tokens (unclamped)
    max_pos: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version (the port of the reference's
    ``paged_decode_multi_xla`` without int8): scatter the in-span tokens,
    then gather-softmax each row's window with per-token causal limits.
    Softmax in f32.  An out-of-span token is skipped, where the XLA twin
    parks it on the null page."""
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
    # [B, W, K, ps, hd] -> [B, K, W*ps, hd]
    kw = k_pages[tables].permute(0, 2, 1, 3, 4).reshape(b, kh, w * ps, hd)
    vw = v_pages[tables].permute(0, 2, 1, 3, 4).reshape(b, kh, w * ps, hd)
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
                max_pos):
    from lmrs_tpu_torch.ops import kernels

    b, t, h, hd = q.shape
    _, kh, ps, _ = k_pages.shape
    w = page_tables.shape[1]
    if (k_new.shape != (b, t, kh, hd) or v_new.shape != k_new.shape
            or v_pages.shape != k_pages.shape or k_pages.shape[3] != hd):
        raise ValueError("paged_decode_multi: shape mismatch among q "
                         f"{tuple(q.shape)}, k_new {tuple(k_new.shape)}, "
                         f"pools {tuple(k_pages.shape)}")
    if hd not in (64, 128) or h % kh or (h // kh) not in (1, 2, 4, 8):
        raise ValueError(f"paged_decode_multi kernel takes hd in (64, 128) "
                         f"and H/K in (1, 2, 4, 8) (got hd={hd}, H={h}, K={kh})")
    if not 1 <= t * (h // kh) <= MULTI_QROWS:
        raise ValueError(f"paged_decode_multi kernel takes T x H/K <= "
                         f"{MULTI_QROWS} query rows per kv head (got T={t}, "
                         f"H/K={h // kh})")
    _check_bf16("paged_decode_multi", q.device, q=q, k_new=k_new, v_new=v_new,
                k_pages=k_pages, v_pages=v_pages)
    if page_tables.shape[0] != b or kv_lens.shape != (b,):
        raise ValueError("paged_decode_multi: tables/kv_lens rows != batch")
    tables = page_tables.to(device=q.device, dtype=torch.int32).contiguous()
    lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = kernels.load("paged_decode_multi").lmrs_paged_decode_multi_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
            lens.data_ptr(), out.data_ptr(), b, t, h, kh, hd, ps, w,
            w * ps if max_pos is None else max_pos, hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch("lmrs_paged_decode_multi_bf16", rc)
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
) -> torch.Tensor:
    """Multi-token verify (speculative decoding): returns [B, T, H, hd];
    ``paged_decode_multi.launches`` counts kernel launches.  Contract:

    * ``base = max(kv_lens[b] - T, 0)`` and token j sits at ``base + j``
      (callers pass the UNclamped length, so base is the true position
      even when the tokens overhang ``max_pos``);
    * a token is written only when its position is ``< W * ps`` and
      ``< max_pos`` (skipped otherwise; the pool elsewhere is untouched);
    * query token j attends columns ``<= base + j`` and ``< max_pos``.

    Rows whose table is the null page (the scheduler's empty slots) write
    page 0 concurrently on the card; their outputs are not used."""
    if q.is_cuda:
        return _multi_cuda(q, k_new, v_new, k_pages, v_pages, page_tables,
                           kv_lens, max_pos)
    return paged_decode_multi_ref(q, k_new, v_new, k_pages, v_pages,
                                  page_tables, kv_lens, max_pos)


paged_decode_multi.launches = 0


# ------------------------------------------------------- ragged span kernel


def pack_spans(q_lens, floor: int = 16) -> tuple[np.ndarray, int]:
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
) -> torch.Tensor:
    """Plain PyTorch version (the port of the reference's
    ``ragged_spans_xla`` without ancestor masks and int8): every row's
    in-span writes first, then each row's span attends its page window
    with per-token causal limits.  Softmax in f32."""
    tp, h, hd = q.shape
    _, kh, ps, _ = k_pages.shape
    b, w = page_tables.shape
    n_rep = h // kh
    cap = w * ps if max_pos is None else min(w * ps, max_pos)
    tables = page_tables.long()
    starts, lens, bases = (x.tolist() for x in (q_starts, q_lens, kv_lens))
    rows = [r for r in range(b) if lens[r] > 0]
    out = torch.zeros_like(q)
    for r in rows:  # 1. writes: in-span tokens at positions < cap only
        pos = bases[r] + torch.arange(lens[r], device=q.device)
        keep = torch.nonzero(pos < cap).flatten()
        p = pos[keep]
        page = tables[r, p // ps]
        k_pages[page, :, p % ps] = k_new[starts[r] + keep]
        v_pages[page, :, p % ps] = v_new[starts[r] + keep]
    col = torch.arange(w * ps, device=q.device)
    for r in rows:  # 2. attention over the row's window
        s, n = starts[r], lens[r]
        kw = k_pages[tables[r]].permute(1, 0, 2, 3).reshape(kh, w * ps, hd)
        vw = v_pages[tables[r]].permute(1, 0, 2, 3).reshape(kh, w * ps, hd)
        qr = q[s:s + n].reshape(n, kh, n_rep, hd).permute(1, 2, 0, 3)
        logits = torch.matmul(qr.float(), kw.float().transpose(1, 2)[:, None])
        pos = bases[r] + torch.arange(n, device=q.device)
        mask = (col[None, :] <= pos[:, None]) & (col[None, :] < cap)
        logits = torch.where(mask, logits * hd ** -0.5,
                             torch.full_like(logits, NEG_INF))
        probs = torch.softmax(logits, dim=-1) * mask.any(-1, keepdim=True)
        o = torch.matmul(probs, vw.float()[:, None])  # [kh, n_rep, n, hd]
        out[s:s + n] = o.permute(2, 0, 1, 3).reshape(n, h, hd).to(q.dtype)
    return out


def _spans_cuda(q, k_new, v_new, k_pages, v_pages, page_tables, kv_lens,
                q_starts, q_lens, max_pos):
    from lmrs_tpu_torch.ops import kernels

    tp, h, hd = q.shape
    _, kh, ps, _ = k_pages.shape
    b, w = page_tables.shape
    if (k_new.shape != (tp, kh, hd) or v_new.shape != k_new.shape
            or v_pages.shape != k_pages.shape or k_pages.shape[3] != hd):
        raise ValueError("ragged_spans: shape mismatch among q "
                         f"{tuple(q.shape)}, k_new {tuple(k_new.shape)}, "
                         f"pools {tuple(k_pages.shape)}")
    if hd not in (64, 128) or h % kh or (h // kh) not in (1, 2, 4, 8):
        raise ValueError(f"ragged_spans kernel takes hd in (64, 128) and "
                         f"H/K in (1, 2, 4, 8) (got hd={hd}, H={h}, K={kh})")
    _check_bf16("ragged_spans", q.device, q=q, k_new=k_new, v_new=v_new,
                k_pages=k_pages, v_pages=v_pages)
    idx = [x.to(device=q.device, dtype=torch.int32).contiguous()
           for x in (page_tables, kv_lens, q_starts, q_lens)]
    if any(x.shape != (b,) for x in idx[1:]):
        raise ValueError(f"ragged_spans: kv_lens/q_starts/q_lens must be [{b}]")
    out = torch.empty_like(q)
    fn = kernels.load("ragged_spans").lmrs_ragged_spans_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), *(x.data_ptr() for x in idx),
            out.data_ptr(), tp, b, h, kh, hd, ps, w,
            w * ps if max_pos is None else max_pos, hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch("lmrs_ragged_spans_bf16", rc)
    ragged_spans.launches += 1
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
) -> torch.Tensor:
    """One ragged dispatch of (row, query-span) pairs.  Returns [Tp, H, hd];
    ``ragged_spans.launches`` counts kernel launches.  Contract:

    * token j of row b is flat token ``q_starts[b] + j`` and sits at
      absolute position ``kv_lens[b] + j``;
    * only in-span tokens are written, and only at positions ``< W * ps``
      and ``< max_pos`` (the pool elsewhere is untouched);
    * an in-span token attends columns ``col <= its position`` and
      ``col < min(W * ps, max_pos)`` of its row's table;
    * a flat token of no span gets a zero output row; a ``q_len == 0`` row
      is skipped.

    The reference's Pallas kernel differs in two places the consumer never
    reads: it writes tile-padding K/V at future positions and leaves
    out-of-span output rows untouched."""
    if q.is_cuda:
        return _spans_cuda(q, k_new, v_new, k_pages, v_pages, page_tables,
                           kv_lens, q_starts, q_lens, max_pos)
    return ragged_spans_ref(q, k_new, v_new, k_pages, v_pages, page_tables,
                            kv_lens, q_starts, q_lens, max_pos)


ragged_spans.launches = 0
