"""Int8 weight-only projections and int8 KV pages (the port of the
reference's ``ops/quant.py``, copied: the port imports nothing of the JAX
package).

Weights: symmetric int8 with one scale per OUTPUT channel, ``s = max|w| /
127`` over the consuming matmul's contracting axis, floored at 1e-8; a
quantized leaf is the dict ``{"q": int8, "s": f32}``.  In the port's fused
layout (``models/transformer.py``: ``wqkv [D, (H+2K)·hd]``, ``w_gate_up
[D, 2F]``, ``wo [H·hd, D]``, ``w_down [F, D]``, ``lm_head [D, V]``) every
projection contracts axis 0, so ``s`` has shape ``[1, out]`` and the fused
matrices' scales are the concatenation of the reference's per-weight
scales in the same order.  A mixture-of-experts layer's expert matrices
(``w_gate_up [E, D, 2F]``, ``w_down [E, F, D]``) contract axis 1: one
scale per (expert, output channel), ``s [E, 1, out]``.  ``qmatmul``
contracts the raw int8 values (exact in bf16) and multiplies the OUTPUT by
``s``.  The embedding and the router are not quantized (routing decisions
are precision-sensitive).

KV: one scale per (slot, kv head, channel), fixed from a prompt's first
tokens and reused (clamped) by every later token of the slot;
``kv_quant_tokens`` is THE quantization rule, ``clip(round(x / s), -127,
127)`` with round half to even (``torch.round``), which the CUDA kernels
reproduce bit for bit (``rintf(__fdiv_rn(x, s))``).
"""

from __future__ import annotations

from typing import Any

import torch

# projections the reference quantizes (its wq/wk/wv are fused here)
QUANT_NAMES = frozenset({"wqkv", "wo", "w_gate_up", "w_down"})


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def quantize_weight(w: torch.Tensor) -> dict:
    """Symmetric int8 over the contracting axis (the second to last: axis
    0 of a matrix [in, out], axis 1 of an expert stack [E, in, out]); the
    scales keep it as a size-1 axis.  An expert stack is quantized one
    expert at a time, so one expert's f32 copy is alive at a time."""
    if w.dim() == 3:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty((w.shape[0], 1, w.shape[2]), dtype=torch.float32,
                        device=w.device)
        for i in range(w.shape[0]):
            qi = quantize_weight(w[i])
            q[i], s[i] = qi["q"], qi["s"]
        return {"q": q, "s": s}
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=0, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_layer(lp: dict) -> dict:
    """One layer's dict with its projections quantized (a new dict)."""
    return {n: quantize_weight(t) if n in QUANT_NAMES and not is_quantized(t)
            else t for n, t in lp.items()}


def quantize_params(params: dict) -> dict:
    """Quantize every projection of a port param dict (``lm_head`` too
    when untied; the embedding, norms and routers stay as they are).
    Layer by layer, so one f32 copy of one matrix is alive at a time;
    returns a new dict and leaves the input's tensors untouched."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [quantize_layer(lp) for lp in params["layers"]]
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def qmatmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` where ``w`` may be a quantized leaf: ``(x @ q) * s`` in
    f32, cast back to ``x``'s dtype (the reference's ``qeinsum``).  An
    expert stack multiplies batched: x [E, C, in] by w [E, in, out]."""
    if is_quantized(w):
        return (torch.matmul(x, w["q"].to(x.dtype)) * w["s"]).to(x.dtype)
    return torch.matmul(x, w)


# ------------------------------------------------------------------ KV


def kv_scale_from(kv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-(row, kv head, channel) scale from a prefill's K or V: kv
    [B, S, K, hd], valid [B, S] bool (padding must not inflate the scale)
    -> [B, K, hd] f32, floored at 1e-8."""
    a = torch.where(valid[:, :, None, None], kv.float().abs(),
                    torch.zeros((), device=kv.device))
    return torch.clamp(a.amax(dim=1) / 127.0, min=1e-8)


def segment_scales(kv: torch.Tensor, seg: torch.Tensor,
                   n_seg: int) -> torch.Tensor:
    """One scale row per segment: kv [S, K, hd], seg [S] segment index in
    [0, n_seg] (n_seg = dropped: pads, out-of-span tokens) -> [n_seg, K,
    hd] f32 from each segment's own tokens (an empty segment gets the 1e-8
    floor), the reference's ``segment_max`` rule."""
    a = kv.float().abs()
    m = torch.zeros((n_seg + 1,) + a.shape[1:], device=kv.device)
    m.scatter_reduce_(0, seg.long()[:, None, None].expand_as(a), a, "amax")
    return torch.clamp(m[:n_seg] / 127.0, min=1e-8)


def kv_quant_tokens(kv: torch.Tensor, token_scales: torch.Tensor) -> torch.Tensor:
    """Quantize K or V rows with per-token scales (broadcastable to
    ``kv``): ``clip(round(x / s), -127, 127)`` as int8."""
    q = torch.round(kv.float() / token_scales)
    return torch.clamp(q, -127, 127).to(torch.int8)


def kv_quant(kv: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """kv [B, S, K, hd] with its rows' scales [B, K, hd] -> int8."""
    return kv_quant_tokens(kv, scale[:, None])


def kv_dequant(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Gathered int8 KV q [B, T, K, hd] with scale [B, K, hd] -> dtype
    (the plain kernel versions ask for f32)."""
    return (q.float() * scale[:, None]).to(dtype)
