"""PyTorch/CUDA generation engine (the port of the reference's
``engine/jax_engine.py``, continuous scheduler only).

Exposes the surface ``MapExecutor``, ``ResultAggregator`` and the HTTP
server use: ``generate_batch`` (with ``on_tokens`` streaming), ``cancel``,
``schedules_internally``, ``engine_metrics``, ``prefix_summary``,
``shutdown`` and ``tokenizer``, and the handoff and page-set hooks
(``supports_handoff``, ``export_handoff``, ``release_handoff``,
``sweep_handoffs``, ``kv_export``, ``kv_import``), and the observability
hooks (``metrics_registry``, ``usage_report``, ``slo_report``,
``anatomy_report``, ``debug_profile``).  Runs on ``cuda`` unless
``device="cpu"`` is asked for.  A CUDA engine checks, when it is built, that its kernels take
the model and engine configuration (``check_cuda_config``), so no request
reaches a kernel only to be refused there.  The weights come from, in turn:
the caller's ``params``; ``engine_cfg.checkpoint_path``, a native
checkpoint read one layer at a time onto the device
(``models/loader.load_checkpoint``); or a random init drawn one layer at a
time on the device.  ``quantize="int8"`` quantizes the projections where
the params live — each layer as it is loaded or drawn, so the
full-precision tree never exists on the card (the caller's params are
quantized whole).  The tokenizer is the caller's, else
``engine_cfg.tokenizer``'s (``data.tokenizer.get_tokenizer``), else byte
for a vocabulary under 100,000 and approx otherwise.
"""

from __future__ import annotations

import logging
import time

import torch

from lmrs_tpu_torch.config import EngineConfig, ModelConfig
from lmrs_tpu_torch.data.tokenizer import ByteTokenizer, get_tokenizer
from lmrs_tpu_torch.engine.api import GenerationRequest, GenerationResult
from lmrs_tpu_torch.engine.scheduler import (ContinuousScheduler,
                                             spec_tree_width)
from lmrs_tpu_torch.models.loader import load_checkpoint
from lmrs_tpu_torch.models.transformer import init_params, model_dtype, param_count
from lmrs_tpu_torch.ops.kernels import check_shapes
from lmrs_tpu_torch.ops.quant import quantize_params
from lmrs_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("lmrs_torch.engine")


def check_cuda_config(engine_cfg: EngineConfig, model_cfg: ModelConfig) -> None:
    """Raise ``ValueError`` naming the model if the CUDA kernels would refuse
    it or the engine configuration: a model that is not bfloat16, or a head
    dim, head grouping, page size or verify width outside the kernels'
    builds (``ops/kernels.shape_problems``).  The verify width counts only
    where the verify kernel is reached: linear speculation (tree
    speculation verifies in the span kernel, which takes any span)."""
    if model_dtype(model_cfg) != torch.bfloat16:
        raise ValueError(
            f"model {model_cfg.name} is {model_cfg.dtype}; the CUDA kernels "
            "take bfloat16 — use a bfloat16 model on the card (or device='cpu')")
    k = engine_cfg.speculate_k
    linear = k > 0 and not spec_tree_width(engine_cfg)
    check_shapes(f"model {model_cfg.name} on cuda", model_cfg.hd,
                 model_cfg.n_heads, model_cfg.n_kv_heads,
                 page_size=engine_cfg.page_size,
                 verify_tokens=k + 1 if linear else None)


class TorchEngine:
    """Single-device engine over the paged KV cache."""

    def __init__(self, engine_cfg: EngineConfig, model_cfg: ModelConfig,
                 device=None, params=None, tokenizer=None):
        self.cfg = engine_cfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            check_cuda_config(engine_cfg, model_cfg)
        if tokenizer is None and engine_cfg.tokenizer:
            tokenizer = get_tokenizer(engine_cfg.tokenizer)
        if tokenizer is None:
            tokenizer = (ByteTokenizer() if model_cfg.vocab_size < 100000
                         else get_tokenizer("approx"))
        if (tokenizer.vocab_size > model_cfg.vocab_size
                or tokenizer.eos_id >= model_cfg.vocab_size):
            raise ValueError(
                f"tokenizer vocab ({tokenizer.vocab_size}, eos "
                f"{tokenizer.eos_id}) does not fit model vocab "
                f"({model_cfg.vocab_size})")
        self.tokenizer = tokenizer
        t0 = time.time()
        if params is not None:
            if engine_cfg.checkpoint_path:
                raise ValueError("pass params or checkpoint_path, not both")
            if engine_cfg.quantize == "int8":
                params = quantize_params(params)
        elif engine_cfg.checkpoint_path:
            params = load_checkpoint(engine_cfg.checkpoint_path, model_cfg,
                                     self.device, quantize=engine_cfg.quantize)
        else:
            logger.warning("no checkpoint for %s: using random-init weights "
                           "(throughput-correct, content-free)", model_cfg.name)
            params = init_params(model_cfg, engine_cfg.seed, self.device,
                                 quantize=engine_cfg.quantize)
        self.params = params
        logger.info("model %s: %.1fM params on %s in %.1fs", model_cfg.name,
                    param_count(params) / 1e6, self.device, time.time() - t0)
        self._scheduler = ContinuousScheduler(engine_cfg, model_cfg, params,
                                              tokenizer, self.device)
        # slot + page admission replaces the executor's wave cap
        self.schedules_internally = True

    def generate_batch(self, requests: list[GenerationRequest],
                       on_result=None, on_tokens=None) -> list[GenerationResult]:
        """Run the requests through the scheduler; ``on_tokens(rid,
        delta)`` streams each request's text at every host fetch."""
        if not requests:
            return []
        return self._scheduler.run(requests, on_result=on_result,
                                   on_tokens=on_tokens)

    def cancel(self, request_id: int) -> None:
        """Abort ``request_id`` at the scheduler's next block boundary
        (``finish_reason="cancelled"``, tokens so far kept); callable from
        any thread."""
        self._scheduler.cancel(request_id)

    def engine_metrics(self) -> dict:
        """The scheduler's cumulative metrics (``metrics_report``), with
        ``spec_accepted_tokens`` when speculation is on."""
        return self._scheduler.metrics_report()

    def prefix_summary(self, top_k: int = 16) -> list[dict]:
        """The published radix summary (``ContinuousScheduler.
        prefix_summary``): served by ``/healthz``, routed on by the router;
        callable from any thread."""
        return self._scheduler.prefix_summary(top_k)

    def audit(self) -> list[str]:
        return self._scheduler.audit()

    # ---------------------------------------- disaggregated handoff hooks
    # (optional Engine surface, looked up by the server with getattr)

    supports_handoff = True

    def export_handoff(self, request_id: int) -> dict:
        """The pinned payload of a ``"handoff"`` result (``KeyError`` once
        released)."""
        return self._scheduler.export_handoff(request_id)

    def release_handoff(self, request_id: int, orphaned: bool = False) -> int:
        """Free a pinned export's pages (the decode side's ack, or the
        orphan sweep); idempotent, callable from any thread."""
        return self._scheduler.release_handoff(request_id, orphaned=orphaned)

    def sweep_handoffs(self, now: float | None = None) -> int:
        """Reclaim pins past their TTL; returns pages released."""
        return self._scheduler.sweep_handoffs(now)

    def pinned_handoffs(self) -> dict[int, int]:
        return self._scheduler.pinned_handoffs()

    # ------------------------------------------------ page-set migration

    def kv_export(self, preamble: str) -> dict | None:
        """One published preamble's warm page set as a wire payload, or
        None (cold, unknown, or a run in flight)."""
        return self._scheduler.kv_export(preamble)

    def kv_import(self, payload: dict) -> int:
        """Install a migrated page set into the prefix cache; returns the
        tokens now warm."""
        return self._scheduler.kv_import(payload)

    # --------------------------------------------------- observability hooks
    # (optional Engine surface, looked up by the server with getattr)

    def metrics_registry(self):
        """The scheduler's typed registry behind ``engine_metrics()``; the
        server merges its Prometheus text into ``/metrics``."""
        return self._scheduler.registry

    def usage_report(self) -> dict:
        """Per-tenant cost-ledger rollups (the ``GET /v1/usage`` page)."""
        return self._scheduler.usage_report()

    def slo_report(self) -> dict:
        """The burn-rate SLO evaluation (the ``/healthz`` ``slo`` block)."""
        return self._scheduler.slo_report()

    def anatomy_report(self) -> dict:
        """The step anatomy (the ``GET /v1/anatomy`` page)."""
        return self._scheduler.anatomy_report()

    def debug_profile(self, duration_s: float,
                      out_dir: str) -> tuple[bool, str]:
        """``POST /v1/debug/profile``: a bounded ``torch.profiler`` capture
        of this process (CPU and CUDA activities; one at a time, stopped
        by its own timer), exported as a Chrome trace into ``out_dir``.
        Returns ``(ok, dir_or_reason)``."""
        from lmrs_tpu_torch.obs.perf import start_profile_capture

        return start_profile_capture(out_dir, duration_s)

    def shutdown(self) -> None:
        """Nothing to stop: the engine runs on the caller's thread."""
