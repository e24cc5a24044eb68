"""Attention in plain PyTorch: GQA, causal and valid-length masking.

The always-correct baseline the CUDA kernels are held against (the port of
the reference's ``ops/attention.py``).  Softmax statistics in f32; the
products run in the input dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, K, hd] -> [B, S, K*n_rep, hd] (each kv head repeated in place)."""
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


def _softmax_out(logits: torch.Tensor, mask: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, K, hd]
    v: torch.Tensor,  # [B, Skv, K, hd]
    q_positions: torch.Tensor,  # [B, Sq] absolute position of each query
    kv_length: torch.Tensor | None = None,  # [B] valid KV prefix length
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Causal attention over a (possibly padded) KV buffer: the query at
    absolute position p attends KV slots [0, p] that are < kv_length."""
    h, hd = q.shape[2], q.shape[3]
    n_rep = h // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    kv_pos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    mask = kv_pos <= q_positions[:, None, :, None]
    if kv_length is not None:
        mask = mask & (kv_pos < kv_length[:, None, None, None])
    return _softmax_out(logits, mask, v)


def packed_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,  # [B, S, K, hd]
    segment_ids: torch.Tensor,  # [B, S] per-token segment (pad: any id < 0)
    length: torch.Tensor | None = None,  # [B] total valid (packed) tokens
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Packed-prompt self-attention: same-segment pairs with causality on
    the row index (segments are contiguous, so this is per-segment causal
    attention)."""
    s, h, hd = q.shape[1], q.shape[2], q.shape[3]
    n_rep = h // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    idx = torch.arange(s, device=q.device)
    causal = idx[None, :] <= idx[:, None]
    same_seg = segment_ids[:, :, None] == segment_ids[:, None, :]
    mask = causal[None] & same_seg
    if length is not None:
        mask = mask & (idx[None, None, :] < length[:, None, None])
    return _softmax_out(logits, mask[:, None], v)
