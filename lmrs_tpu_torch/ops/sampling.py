"""Token sampling: greedy / temperature / top-k / top-p.

Sampler parameters are host arrays (numpy) — the scheduler holds them per
slot — so the branch between the cheap and the expensive paths is taken on
the host without a device sync: the full-vocab sort behind top-k/top-p runs
only when some row has them active, and the categorical draw only when some
row samples (the reference gates the same two stages with ``lax.cond``,
``ops/sampling.py:81-109``).  The draw is a Gumbel-max over uniforms from a
``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch


def filter_logits(
    logits: torch.Tensor,       # [B, V] f32
    temperature: torch.Tensor,  # [B] 0.0 => greedy
    top_k: torch.Tensor,        # [B] int, 0 => disabled
    top_p: torch.Tensor,        # [B] f32, 1.0 => disabled
) -> torch.Tensor:
    """Temperature-scaled, top-k/top-p-masked logits [B, V] (-inf outside
    the nucleus)."""
    v = logits.shape[-1]
    logits = logits.float()
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))[:, None]
    scaled = logits / safe_t
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = torch.clamp(top_k.long() - 1, 0, v - 1)
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    k_mask = torch.where((top_k > 0)[:, None], scaled >= kth,
                         torch.ones_like(scaled, dtype=torch.bool))
    probs_desc = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_desc, dim=-1)
    cutoff_count = torch.sum(cum - probs_desc < top_p[:, None], dim=-1)
    p_idx = torch.clamp(cutoff_count - 1, 0, v - 1)
    pth = torch.gather(sorted_desc, 1, p_idx[:, None])
    p_mask = torch.where((top_p < 1.0)[:, None], scaled >= pth,
                         torch.ones_like(scaled, dtype=torch.bool))
    return torch.where(k_mask & p_mask, scaled,
                       torch.full_like(scaled, float("-inf")))


def filtered_probs(
    logits: torch.Tensor,        # [B, V] f32
    temperature: np.ndarray,     # [B] 0.0 => greedy
    top_k: np.ndarray,           # [B] int, 0 => disabled
    top_p: np.ndarray,           # [B] f32, 1.0 => disabled
) -> torch.Tensor:
    """The per-row sampling distribution [B, V] (f32): the softmax of the
    filtered logits for temperature > 0, a one-hot argmax for greedy rows —
    the acceptance target of speculative decoding (``ops/speculative.py``).
    The same host-side gates as ``sample_logits``: no sort unless a sampled
    row has top-k/top-p, no softmax when every row is greedy."""
    logits = logits.float()
    greedy = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), logits.shape[-1]).float()
    temperature = np.asarray(temperature, np.float32)
    sampled_rows = temperature > 0
    if not sampled_rows.any():
        return greedy
    dev = logits.device
    t = torch.as_tensor(temperature, device=dev)
    top_k = np.asarray(top_k)
    top_p = np.asarray(top_p, np.float32)
    if (sampled_rows & ((top_k > 0) | (top_p < 1.0))).any():
        masked = filter_logits(logits, t, torch.as_tensor(top_k, device=dev),
                               torch.as_tensor(top_p, device=dev))
    else:
        masked = logits / torch.where(t > 0, t, torch.ones_like(t))[:, None]
    return torch.where((t > 0)[:, None], torch.softmax(masked, dim=-1), greedy)


def sample_logits(
    logits: torch.Tensor,        # [B, V] f32
    temperature: np.ndarray,     # [B] 0.0 => greedy
    top_k: np.ndarray,           # [B] int, 0 => disabled
    top_p: np.ndarray,           # [B] f32, 1.0 => disabled
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Sampled token ids [B] (int64, on the logits' device).  Greedy rows
    (temperature 0) take the argmax, so batches mix greedy and sampled
    requests."""
    logits = logits.float()
    greedy_ids = torch.argmax(logits, dim=-1)
    temperature = np.asarray(temperature, np.float32)
    sampled_rows = temperature > 0
    if not sampled_rows.any():
        return greedy_ids
    dev = logits.device
    t = torch.as_tensor(temperature, device=dev)
    top_k = np.asarray(top_k)
    top_p = np.asarray(top_p, np.float32)
    if (sampled_rows & ((top_k > 0) | (top_p < 1.0))).any():
        masked = filter_logits(logits, t, torch.as_tensor(top_k, device=dev),
                               torch.as_tensor(top_p, device=dev))
    else:
        masked = logits / torch.where(t > 0, t, torch.ones_like(t))[:, None]
    u = torch.rand(masked.shape, generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    sampled = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(t > 0, sampled, greedy_ids)
