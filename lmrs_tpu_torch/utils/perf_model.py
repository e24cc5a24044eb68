"""Roofline accounting: FLOP and byte counts, the card's peaks, and the
span family's pow2 bucketing (a copy of the reference's
``utils/perf_model.py`` with the NVIDIA cards' peaks in place of the TPU
generations').  The live attribution (``obs/perf.py``), the cost ledger's
phase split, the scheduler's admission-shedding estimate and
``chip_smoke.py``'s bounds read the peaks from ``chip_spec()``; the
bucket sizes page windows and the mock's emulated span shapes."""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from lmrs_tpu_torch.config import ModelConfig

# Data-sheet peaks per card, dense (no sparsity), at the card's full power
# limit: (name substring, bf16 FLOP/s, HBM bytes/s).  Matched in order
# against ``torch.cuda.get_device_name()``, so the PCIe and NVL parts are
# tried before the SXM part's generic "H100" names.
_CARD_PEAKS: tuple[tuple[str, float, float], ...] = (
    ("h100 nvl", 835e12, 3.9e12),     # NVL: 1,671 TFLOP/s sparse, HBM3 3.9 TB/s
    ("h100 pcie", 756e12, 2.0e12),    # PCIe: 1,513 TFLOP/s sparse, HBM2e 2 TB/s
    ("h100 sxm", 989e12, 3.35e12),    # SXM5: 1,979 TFLOP/s sparse, HBM3 3.35 TB/s
    ("h100 80gb hbm3", 989e12, 3.35e12),  # the SXM5 part's device name
)
# an unrecognised card is priced as the H100 SXM and flagged known=False
_FALLBACK = (989e12, 3.35e12)

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def pow2_bucket(n: int, lo: int) -> int:
    """Smallest power of two >= max(n, lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class ChipSpec:
    kind: str
    peak_flops: float   # dense bf16 FLOP/s
    peak_hbm_bw: float  # bytes/s
    known: bool


@lru_cache(maxsize=8)
def _spec_for(kind: str) -> ChipSpec:
    low = kind.lower()
    for key, fl, bw in _CARD_PEAKS:
        if key in low:
            return ChipSpec(kind, fl, bw, True)
    return ChipSpec(kind, *_FALLBACK, False)


def chip_spec(name: str | None = None) -> ChipSpec:
    """Peaks of the card named ``name`` (default: CUDA device 0, as
    ``torch.cuda.get_device_name`` reports it; ``"cpu"`` without a card,
    which is unknown)."""
    if name is None:
        import torch

        try:
            name = (torch.cuda.get_device_name(0)
                    if torch.cuda.is_available() else "cpu")
        except Exception:  # noqa: BLE001 - a CUDA error prices as unknown
            name = "unknown"
    return _spec_for(name)


def matmul_params(cfg: ModelConfig) -> int:
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
    body = matmul_params(cfg) - d * cfg.vocab_size
    fl = 2.0 * body * n_tokens
    fl += 2.0 * (head_tokens if head_tokens is not None else n_tokens) \
        * d * cfg.vocab_size
    fl += 2.0 * cfg.n_layers * (float(n_tokens) ** 2
                                + 2.0 * kv_start * n_tokens) \
        * cfg.hd * cfg.n_heads
    return fl


def _itemsize(cfg: ModelConfig) -> int:
    return _DTYPE_BYTES[str(cfg.dtype)]


def weight_bytes(cfg: ModelConfig, quantized: bool = False) -> float:
    """Bytes of matmul weights a decode step streams from HBM (all of
    them, once: one read serves the whole batch); the embedding gather is
    excluded."""
    return matmul_params(cfg) * (1 if quantized else _itemsize(cfg))


def kv_bytes_per_token(cfg: ModelConfig) -> float:
    """KV-cache bytes per cached token (K + V, all layers, all kv heads)."""
    return 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * _itemsize(cfg)


def decode_step_bytes(cfg: ModelConfig, total_live_tokens: int,
                      quantized: bool = False,
                      kv_quantized: bool = False) -> float:
    """HBM bytes one batched decode step moves: every weight once plus
    every live KV token's K and V (halved when the pages are int8)."""
    kv = kv_bytes_per_token(cfg) * total_live_tokens
    if kv_quantized:
        kv /= 2
    return weight_bytes(cfg, quantized) + kv
