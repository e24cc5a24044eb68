"""Engine protocol of the port: requests, results and the engine factory
(trimmed copy of the reference's ``engine/api.py``).  The factory knows the
``"torch"`` backend only."""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Protocol, runtime_checkable

if TYPE_CHECKING:
    from lmrs_tpu_torch.config import EngineConfig, ModelConfig


@dataclass
class GenerationRequest:
    """One unit of generation work."""

    prompt: str
    request_id: int = 0
    system_prompt: str | None = None
    max_new_tokens: int = 1000
    temperature: float = 0.3
    top_p: float = 1.0
    top_k: int = 0
    stop: tuple[str, ...] = ()
    seed: int | None = None
    # Prefix-cache hint (engine/prefix_cache.py): how many LEADING CHARACTERS
    # of ``prompt`` are expected to be shared with other requests (the map /
    # reduce preamble before per-chunk content).  None = no hint, cache the
    # whole full-page prompt prefix; 0 = the prompt body shares nothing (a
    # shared system prompt, encoded ahead of the prompt, is still cached);
    # negative = never cache this request's prefix.  Approximate by design:
    # the cap is rounded up to a KV page at token level.
    cache_prefix: int | None = None


def preamble_text(system_prompt: str | None, prompt: str,
                  cache_prefix: int | None) -> str:
    """A request's SHARED-PREAMBLE text region: the system prompt plus the
    ``cache_prefix``-hinted head of the prompt — exactly the region the
    scheduler donates to the prefix cache.  Empty when the hint is
    negative (the request declares nothing shared)."""
    if cache_prefix is not None and cache_prefix < 0:
        return ""
    head = prompt[:cache_prefix] if cache_prefix is not None else ""
    return ((system_prompt + "\n\n") if system_prompt else "") + head


def preamble_key(system_prompt: str | None, prompt: str,
                 cache_prefix: int | None) -> str | None:
    """Stable hash of ``preamble_text``; None when the request declares
    nothing shared (negative hint, or the preamble text is empty)."""
    text = preamble_text(system_prompt, prompt, cache_prefix)
    if not text:
        return None
    import hashlib

    return hashlib.sha256(text.encode("utf-8", "replace")).hexdigest()[:16]


@dataclass
class GenerationResult:
    """Completion + accounting.  ``finish_reason``: stop | length | error."""

    request_id: int
    text: str = ""
    prompt_tokens: int = 0
    completion_tokens: int = 0
    finish_reason: str = "stop"
    stop_sequence: str | None = None
    device_seconds: float = 0.0
    error: str | None = None

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens


def apply_stop_sequences(text: str, stops: tuple[str, ...]) -> tuple[str, str | None]:
    """Truncate ``text`` at the earliest-in-text stop string (ties broken by
    list order).  Returns (truncated_text, stop_hit_or_None).  Empty stop
    strings are skipped."""
    best_pos, best_stop = len(text) + 1, None
    for stop in stops:
        if not stop:
            continue
        pos = text.find(stop)
        if pos != -1 and pos < best_pos:
            best_pos, best_stop = pos, stop
    if best_stop is None:
        return text, None
    return text[:best_pos], best_stop


@runtime_checkable
class Engine(Protocol):
    """Batch generation backend (see ``TorchEngine``)."""

    def generate_batch(self, requests: list[GenerationRequest],
                       on_result=None) -> list[GenerationResult]: ...

    def shutdown(self) -> None: ...

    def engine_metrics(self) -> dict: ...


def make_engine(engine_cfg: "EngineConfig",
                model_cfg: "ModelConfig | None" = None,
                device=None, tokenizer=None) -> Engine:
    """Engine factory keyed on ``EngineConfig.backend`` (``"torch"``)."""
    if engine_cfg.backend != "torch":
        raise ValueError(f"unknown engine backend {engine_cfg.backend!r}")
    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine

    if model_cfg is None:
        model_cfg = model_preset(engine_cfg.model)
    return TorchEngine(engine_cfg, model_cfg, device=device,
                       tokenizer=tokenizer)
