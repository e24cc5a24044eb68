"""Mixture-of-experts FFN: top-k routing with capacity-bounded dispatch (the
port of the reference's ``ops/moe.py``).

The same function as the reference's ``moe_mlp``, written as index
gathers and scatters into static ``[E, C]`` slot buffers instead of its
``[N, E, C]`` one-hot einsums (which multiply N·E·C·D zeros):

* routing in f32: softmax over the router logits, top-k with ties to the
  lower expert index (``jax.lax.top_k``'s order), gates renormalised with
  ``+ 1e-9``;
* capacity ``C = ceil(capacity_factor · N · k / E)`` over every token of
  the call (padding included), claimed slot-major: every token's first
  choice before any second choice, in token order; an assignment past C is
  dropped (its token keeps the residual stream only) and lands in a trash
  slot that no expert reads;
* the expert products over ``[E, C, ·]`` (``qmatmul``: plain or int8 leaves
  ``w_gate_up [E, D, 2F]``, ``w_down [E, F, D]``), ``gate_act`` in f32;
* the combine with the gates rounded to the model dtype, summed in f32;
* the Switch load-balance loss ``E · Σ_e f_e · P_e`` from the top-1 choices.

Nothing here syncs the host (no ``nonzero``, boolean-mask indexing or
``.item()``): every shape follows from N, E, k and C.
"""

from __future__ import annotations

import math

import torch

from lmrs_tpu_torch.config import ModelConfig
from lmrs_tpu_torch.ops.quant import qmatmul


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Static per-expert token capacity for a call with ``n_tokens`` tokens."""
    k = min(cfg.n_experts_per_token, cfg.n_experts)
    c = math.ceil(cfg.expert_capacity_factor * n_tokens * k / cfg.n_experts)
    return max(1, min(n_tokens, c))


def route(router: torch.Tensor, cfg: ModelConfig, xt: torch.Tensor):
    """Routing of tokens ``xt [N, D]``: (probs [N, E] f32, gates [N, k] f32
    renormalised, experts [N, k] int64, best first, equal probabilities in
    expert order)."""
    k = min(cfg.n_experts_per_token, cfg.n_experts)
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :k]
    return probs, gates / (gates.sum(-1, keepdim=True) + 1e-9), idx[:, :k]


def assign_slots(experts: torch.Tensor, n_experts: int, capacity: int):
    """Slot-major capacity assignment of ``experts [N, k]``: (slot [k·N]
    flat index ``e · C + position`` into the [E, C] buffers, or ``E · C``
    (the trash slot) for a dropped assignment; keep [k·N] bool).  Entry
    ``j · N + n`` is token n's j-th choice."""
    flat = experts.t().reshape(-1)  # slot-major
    onehot = (flat[:, None] == torch.arange(n_experts, device=flat.device)
              ).to(torch.int32)
    pos = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    keep = pos < capacity
    trash = torch.full_like(flat, n_experts * capacity)
    return torch.where(keep, flat * capacity + pos, trash), keep


def moe_mlp(mp: dict, cfg: ModelConfig, x: torch.Tensor):
    """MoE SwiGLU FFN.  x [B, S, D] -> (out [B, S, D], aux loss f32 scalar).
    ``mp`` is one layer's params: ``router [D, E]``, ``w_gate_up
    [E, D, 2F]`` (gate then up), ``w_down [E, F, D]``."""
    from lmrs_tpu_torch.models.transformer import gate_act

    dt = x.dtype
    b, s, d = x.shape
    e = cfg.n_experts
    n = b * s
    xt = x.reshape(n, d)
    probs, gates, experts = route(mp["router"], cfg, xt)
    k = experts.shape[1]
    c = expert_capacity(n, cfg)
    slot, keep = assign_slots(experts, e, c)
    tokens = torch.arange(n, device=x.device).repeat(k)

    # dispatch: each kept assignment copies its token into its slot; the
    # dropped ones all land in the trash row, which is cut off
    xin = x.new_zeros(e * c + 1, d).index_copy_(0, slot, xt[tokens])
    gate_up = qmatmul(xin[:-1].view(e, c, d), mp["w_gate_up"])
    gate, up = gate_up.chunk(2, dim=-1)
    y = qmatmul(gate_act(cfg, gate).to(dt) * up, mp["w_down"])  # [E, C, D]

    # combine: gather each assignment's expert row (the trash row is 0),
    # weight it by its gate rounded to the model dtype, sum the k in f32
    y = torch.cat([y.reshape(e * c, d), y.new_zeros(1, d)])
    w = (gates.t().reshape(-1) * keep).to(dt).float()
    out = (y[slot].float() * w[:, None]).view(k, n, d).sum(0).to(dt)

    top1 = torch.zeros(e, device=x.device).index_add_(
        0, experts[:, 0], torch.ones(n, device=x.device)) / n
    aux = e * torch.sum(top1 * probs.mean(0))
    return out.view(b, s, d), aux
