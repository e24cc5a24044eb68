"""Causal-LM training step (the port of the reference's
``training/train.py``).

The loss runs ``models.transformer.forward`` without a cache: plain
PyTorch ops under autograd.  The reference's training reaches no Pallas
kernel either (its attention is XLA's, and the JAX package has no
backward kernel), so nothing here routes through the card's hand-written
kernels, which have no backward.  The dense products stay
``torch.matmul``.

The optimizer is ``torch.optim.AdamW`` over the param leaves
(``param_leaves``), set to ``optax.adamw``'s defaults by ``adamw``: b1
0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every leaf, states in the
params' dtype.  ``warmup_cosine_decay`` reproduces
``optax.warmup_cosine_decay_schedule`` step for step; ``set_lr`` applies
it before an update.  Meshes (``mesh``, ``seq_sharded``: tensor, data and
sequence parallel training with ring attention) are refused by name: they
arrive with the multi-GPU slice.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator

import torch
import torch.nn.functional as F

from lmrs_tpu_torch.config import ModelConfig
from lmrs_tpu_torch.models.transformer import Params, forward

MULTI_GPU = "it arrives with the multi-GPU (A8) slice"


def param_leaves(params: Params) -> Iterator[torch.Tensor]:
    """Every tensor of ``params`` in a fixed order: the top-level leaves
    (sorted by name), then each layer's (sorted by name)."""
    for name in sorted(k for k in params if k != "layers"):
        yield params[name]
    for lp in params["layers"]:
        for name in sorted(lp):
            yield lp[name]


def map_params(fn: Callable[[torch.Tensor], torch.Tensor],
               params: Params) -> Params:
    """``params`` with ``fn`` applied to every leaf (same structure)."""
    out = {k: fn(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: fn(v) for k, v in lp.items()}
                     for lp in params["layers"]]
    return out


def trainable(params: Params) -> Params:
    """Mark every leaf as a trainable leaf tensor (in place); returns
    ``params``."""
    for t in param_leaves(params):
        t.requires_grad_(True)
    return params


def grads_of(params: Params) -> Params:
    """The gradients of ``params`` after ``backward``, in its structure."""
    return map_params(lambda t: t.grad, params)


def adamw(params: Params, lr: float,
          weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` over every leaf of ``params`` in one group, at
    ``optax.adamw``'s defaults (PyTorch's own weight decay is 1e-2)."""
    return torch.optim.AdamW(list(param_leaves(params)), lr=lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine to
    ``end_value`` at ``decay_steps`` (held after).  Step 0 is the first
    update."""
    alpha = end_value / peak_value if peak_value else 0.0
    span = decay_steps - warmup_steps

    def lr(step: int) -> float:
        if step < warmup_steps:
            return init_value + (peak_value - init_value) * step / warmup_steps
        t = min(step - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return lr


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def causal_lm_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   loss_mask: torch.Tensor | None = None, attn_fn=None,
                   remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy in f32 (a scalar tensor).  tokens [B, S];
    predicts tokens[:, 1:], averaged over ``loss_mask[:, 1:]`` when given;
    plus ``router_aux_coef`` times the layer-mean load-balance loss for a
    mixture-of-experts model."""
    b, s = tokens.shape
    tokens = tokens.long()
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    logits, _, aux = forward(params, cfg, tokens, positions, attn_fn=attn_fn,
                             return_aux=True, remat=remat)
    nll = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                          tokens[:, 1:].reshape(-1),
                          reduction="none").view(b, s - 1)
    if loss_mask is not None:
        m = loss_mask[:, 1:].float()
        loss = (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    else:
        loss = nll.mean()
    if cfg.n_experts and cfg.router_aux_coef:
        loss = loss + cfg.router_aux_coef * aux
    return loss


def make_train_step(cfg: ModelConfig, optimizer: torch.optim.Optimizer,
                    mesh=None, seq_sharded: bool = False, remat: bool = False,
                    masked: bool = False):
    """Build ``step(params, tokens, loss_mask=None) -> loss``: one
    ``zero_grad`` / ``backward`` / ``optimizer.step`` over ``params``
    (trainable leaves, updated in place; ``optimizer`` is built over them,
    e.g. by ``adamw``).  The loss comes back detached and on the device:
    reading it syncs the host, so a loop reads it only when it logs.
    ``remat`` recomputes each decoder layer in backward.  ``masked`` is
    the reference's flag for a sharded loss mask: it changes nothing
    without a mesh and is kept so that the reference's callers and
    signature carry over unchanged."""
    del masked  # only shapes the mesh layout in the reference
    if mesh is not None:
        raise ValueError(f"a training mesh is not in the port yet; {MULTI_GPU}")
    if seq_sharded:
        raise ValueError("sequence-sharded training (ring attention) is not "
                         f"in the port yet; {MULTI_GPU}")

    def step(params: Params, tokens: torch.Tensor,
             loss_mask: torch.Tensor | None = None) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = causal_lm_loss(params, cfg, tokens, loss_mask, remat=remat)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
