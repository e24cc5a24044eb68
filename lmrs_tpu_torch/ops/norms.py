"""RMSNorm with f32 statistics regardless of the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: x * rsqrt(mean(x^2) + eps) * (1 + scale), computed in f32.

    The (1 + scale) parameterization makes a zero-initialized scale the
    identity transform (the reference's convention)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * (1.0 + scale.float())).to(x.dtype)
