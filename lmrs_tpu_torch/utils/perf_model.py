"""Analytic FLOP count of a prefill and the span family's pow2 bucketing
(trimmed copy of the reference's ``utils/perf_model.py``): the scheduler's
admission-shedding estimate falls back to the count before any TTFT has
been observed; the bucket sizes page windows and the mock's emulated span
shapes."""

from __future__ import annotations

from lmrs_tpu_torch.config import ModelConfig


def pow2_bucket(n: int, lo: int) -> int:
    """Smallest power of two >= max(n, lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _matmul_params(cfg: ModelConfig) -> int:
    """Parameters in per-token matmuls (embedding lookup excluded; the LM
    head included, tied or not; of a mixture-of-experts FFN only the
    experts a token activates)."""
    d, hd = cfg.dim, cfg.hd
    per_layer = (d * cfg.n_heads * hd          # wq
                 + 2 * d * cfg.n_kv_heads * hd  # wk, wv
                 + cfg.n_heads * hd * d)        # wo
    ffn = 3 * d * cfg.hidden_dim               # gate, up, down
    per_layer += ffn * cfg.n_experts_per_token if cfg.n_experts else ffn
    return cfg.n_layers * per_layer + d * cfg.vocab_size


def prefill_flops(cfg: ModelConfig, n_tokens: int,
                  head_tokens: int | None = None,
                  kv_start: int = 0) -> float:
    """Forward FLOPs for a causal prefill of ``n_tokens``: 2 a parameter a
    token for the dense products, 2 * S^2 * hd * H a layer for causal
    attention.  ``head_tokens`` restricts the LM head to the sampled rows;
    ``kv_start`` adds the earlier cached tokens a continuation chunk
    attends."""
    d = cfg.dim
    body = _matmul_params(cfg) - d * cfg.vocab_size
    fl = 2.0 * body * n_tokens
    fl += 2.0 * (head_tokens if head_tokens is not None else n_tokens) \
        * d * cfg.vocab_size
    fl += 2.0 * cfg.n_layers * (float(n_tokens) ** 2
                                + 2.0 * kv_start * n_tokens) \
        * cfg.hd * cfg.n_heads
    return fl
