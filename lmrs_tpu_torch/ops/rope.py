"""Rotary position embeddings ("split halves" convention, as in Llama)."""

from __future__ import annotations

import torch


def rope_table(max_seq_len: int, head_dim: int, theta: float = 10000.0,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sin, cos) f32 tables of shape [max_seq_len, head_dim // 2]."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=device) / half))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor,          # [..., S, n_heads, head_dim]
               positions: torch.Tensor,  # [..., S] absolute positions
               sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate (x[..i], x[..i+half]) pairs by the position angle, in f32."""
    half = x.shape[-1] // 2
    s = sin[positions].unsqueeze(-2)  # [..., S, 1, half]
    c = cos[positions].unsqueeze(-2)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
