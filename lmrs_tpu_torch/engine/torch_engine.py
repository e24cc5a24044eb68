"""PyTorch/CUDA generation engine (the port of the reference's
``engine/jax_engine.py``).

Exposes the surface ``MapExecutor``, ``ResultAggregator`` and the HTTP
server use: ``generate_batch`` (with ``on_tokens`` streaming), ``cancel``,
``schedules_internally``, ``engine_metrics``, ``prefix_summary``,
``shutdown``, ``wedged`` and ``tokenizer``, and the handoff and page-set hooks
(``supports_handoff``, ``export_handoff``, ``release_handoff``,
``sweep_handoffs``, ``kv_export``, ``kv_import``), and the observability
hooks (``metrics_registry``, ``usage_report``, ``slo_report``,
``anatomy_report``, ``debug_profile``).  A continuous engine runs its
scheduler on the dispatch watchdog's thread (``engine/watchdog.py``,
``LMRS_WATCHDOG``, on by default).  Runs on ``cuda`` unless
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

``EngineConfig(scheduler="static")`` is the reference's static path
(``_generate_static``): lockstep waves of ``max_batch_slots`` requests
sorted by prompt length, each a full-prompt prefill into a dense KV cache
(``models/transformer.forward``, prompt length bucketed to a power of
two) and a decode loop sampling with ``ops/sampling``.  It reaches no
kernel, as the reference's reaches no Pallas call: its attention is the
plain ``ops/attention.attention``.  A static engine has no mid-wave hook
(``on_result`` and ``on_tokens`` are delivered per wave), no prefix
cache, ledger, anatomy, handoff or page-set import: those hooks answer
with the reference's empty shapes.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from lmrs_tpu_torch.config import EngineConfig, ModelConfig
from lmrs_tpu_torch.data.tokenizer import ByteTokenizer, get_tokenizer
from lmrs_tpu_torch.engine.api import (GenerationRequest, GenerationResult,
                                       apply_stop_sequences,
                                       drain_with_callback)
from lmrs_tpu_torch.engine.scheduler import (ContinuousScheduler,
                                             spec_tree_width)
from lmrs_tpu_torch.models.loader import load_checkpoint
from lmrs_tpu_torch.models.transformer import (forward, init_kv_cache,
                                               init_params, model_dtype,
                                               param_count)
from lmrs_tpu_torch.ops.kernels import check_shapes
from lmrs_tpu_torch.ops.quant import quantize_params
from lmrs_tpu_torch.ops.sampling import sample_logits
from lmrs_tpu_torch.testing import faults
from lmrs_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("lmrs_torch.engine")


def _bucket(n: int, lo: int = 64) -> int:
    """The static path's prompt bucket: the least power-of-two multiple of
    ``lo`` that holds ``n``."""
    b = lo
    while b < n:
        b *= 2
    return b


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
    """Single-device engine: the continuous scheduler over the paged KV
    cache, or the static path over a dense one."""

    def __init__(self, engine_cfg: EngineConfig, model_cfg: ModelConfig,
                 device=None, params=None, tokenizer=None):
        self.cfg = engine_cfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        static = engine_cfg.scheduler == "static"
        if self.device.type == "cuda" and not static:
            # the static path reaches no kernel
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
        self._scheduler: ContinuousScheduler | None = None
        self._runner = None
        if static:
            self.generator = torch.Generator(device=self.device).manual_seed(
                engine_cfg.seed)
        else:
            self._scheduler = ContinuousScheduler(
                engine_cfg, model_cfg, params, tokenizer, self.device)
            # the dispatch watchdog (engine/watchdog.py, LMRS_WATCHDOG, on
            # by default): the scheduler runs on a daemon dispatch thread
            # and the caller thread watches its heartbeat, so a wedged card
            # becomes bounded wedged/deadline results and a fail-fast
            # degraded engine instead of a silent freeze.  LMRS_WATCHDOG=0
            # leaves _runner None: run() executes inline on the caller
            if self._scheduler.watchdog is not None:
                from lmrs_tpu_torch.engine.watchdog import WatchdogRunner

                self._runner = WatchdogRunner(self._scheduler)
        # slot + page admission replaces the executor's wave cap; the
        # static path takes the executor's waves
        self.schedules_internally = not static

    def generate_batch(self, requests: list[GenerationRequest],
                       on_result=None, on_tokens=None) -> list[GenerationResult]:
        """Run the requests through the scheduler (on the watchdog's
        dispatch thread when it is armed); ``on_tokens(rid, delta)``
        streams each request's text at every host fetch (the static path:
        once, when its wave finishes)."""
        if not requests:
            return []
        # injection site: an engine-level batch fault (the executor and the
        # server's batcher degrade it to per-request error results)
        faults.fire("engine.batch")
        if self._runner is not None:
            return self._runner.run(requests, on_result=on_result,
                                    on_tokens=on_tokens)
        if self._scheduler is not None:
            return self._scheduler.run(requests, on_result=on_result,
                                       on_tokens=on_tokens)
        if on_tokens is not None:
            # whole completions per wave: one delta per finished request
            inner = on_result

            def on_result(res, submit, _inner=inner):  # noqa: F811
                if res.text:
                    on_tokens(res.request_id, res.text)
                if _inner is not None:
                    _inner(res, submit)
        if on_result is not None:
            # no mid-run hook: run wave by wave, deliver after each, and
            # loop on whatever the callbacks submit
            return drain_with_callback(self._generate_static, requests,
                                       on_result)
        return self._generate_static(requests)

    def cancel(self, request_id: int) -> None:
        """Abort ``request_id`` at the scheduler's next block boundary
        (``finish_reason="cancelled"``, tokens so far kept); callable from
        any thread.  The static path has no abort point: a no-op."""
        if self._scheduler is not None:
            self._scheduler.cancel(request_id)

    def engine_metrics(self) -> dict:
        """The scheduler's cumulative metrics (``metrics_report``), with
        ``spec_accepted_tokens`` when speculation is on; {} static."""
        return self._scheduler.metrics_report() if self._scheduler else {}

    def prefix_summary(self, top_k: int = 16) -> list[dict]:
        """The published radix summary (``ContinuousScheduler.
        prefix_summary``): served by ``/healthz``, routed on by the router;
        callable from any thread.  [] static."""
        if self._scheduler is None:
            return []
        return self._scheduler.prefix_summary(top_k)

    def audit(self) -> list[str]:
        return self._scheduler.audit() if self._scheduler else []

    # ---------------------------------------- disaggregated handoff hooks
    # (optional Engine surface, looked up by the server with getattr; the
    # static path has no paged pool to export)

    @property
    def supports_handoff(self) -> bool:
        return self._scheduler is not None

    def export_handoff(self, request_id: int) -> dict:
        """The pinned payload of a ``"handoff"`` result (``KeyError`` once
        released)."""
        if self._scheduler is None:
            raise KeyError(request_id)
        return self._scheduler.export_handoff(request_id)

    def release_handoff(self, request_id: int, orphaned: bool = False) -> int:
        """Free a pinned export's pages (the decode side's ack, or the
        orphan sweep); idempotent, callable from any thread."""
        if self._scheduler is None:
            return 0
        return self._scheduler.release_handoff(request_id, orphaned=orphaned)

    def sweep_handoffs(self, now: float | None = None) -> int:
        """Reclaim pins past their TTL; returns pages released."""
        if self._scheduler is None:
            return 0
        return self._scheduler.sweep_handoffs(now)

    def pinned_handoffs(self) -> dict[int, int]:
        return self._scheduler.pinned_handoffs() if self._scheduler else {}

    # ------------------------------------------------ page-set migration

    def kv_export(self, preamble: str) -> dict | None:
        """One published preamble's warm page set as a wire payload, or
        None (cold, unknown, a run in flight, or the static path)."""
        if self._scheduler is None:
            return None
        return self._scheduler.kv_export(preamble)

    def kv_import(self, payload: dict) -> int:
        """Install a migrated page set into the prefix cache; returns the
        tokens now warm."""
        if self._scheduler is None:
            raise RuntimeError("static scheduler has no prefix cache")
        return self._scheduler.kv_import(payload)

    # --------------------------------------------------- observability hooks
    # (optional Engine surface, looked up by the server with getattr; the
    # static path answers with the disabled shapes)

    def metrics_registry(self):
        """The scheduler's typed registry behind ``engine_metrics()``; the
        server merges its Prometheus text into ``/metrics``."""
        return self._scheduler.registry if self._scheduler else None

    def usage_report(self) -> dict:
        """Per-tenant cost-ledger rollups (the ``GET /v1/usage`` page)."""
        if self._scheduler is None:
            return {"object": "usage", "enabled": False, "tenants": {},
                    "totals": {}}
        return self._scheduler.usage_report()

    def slo_report(self) -> dict:
        """The burn-rate SLO evaluation (the ``/healthz`` ``slo`` block)."""
        if self._scheduler is None:
            return {"enabled": False, "state": "ok", "specs": {}}
        return self._scheduler.slo_report()

    def qos_report(self) -> dict:
        """The fair-share window state (fleet/qos.py; the ``GET /v1/usage``
        ``qos`` block)."""
        if self._scheduler is None:
            return {"object": "qos", "enabled": False}
        return self._scheduler.qos_report()

    def anatomy_report(self) -> dict:
        """The step anatomy (the ``GET /v1/anatomy`` page)."""
        if self._scheduler is None:
            return {"object": "anatomy", "enabled": False}
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
        """Stop the dispatch thread (a wedged run is abandoned: the thread
        is a daemon)."""
        if self._runner is not None:
            self._runner.shutdown()

    def wedged(self) -> bool:
        """True while a wedged run still holds the dispatch thread (the
        engine is degraded fail-fast); ``/healthz`` answers 503 with it so
        the supervisor can bounce the process."""
        return self._runner is not None and self._runner.wedged

    # --------------------------------------------------------- static path

    def _generate_static(self, requests: list[GenerationRequest]
                         ) -> list[GenerationResult]:
        t0 = time.time()
        results: dict[int, GenerationResult] = {}
        # an expired deadline sheds at admission; in flight a wave runs to
        # its end (the continuous scheduler is the deadline-complete path)
        live = []
        for req in requests:
            if req.deadline_s is not None and req.deadline_s <= time.time():
                results[id(req)] = GenerationResult(
                    request_id=req.request_id, finish_reason="shed")
            else:
                live.append(req)
        encoded = []
        for req in live:
            text = (req.system_prompt + "\n\n" if req.system_prompt
                    else "") + req.prompt
            ids = [self.tokenizer.bos_id] + self.tokenizer.encode(text)
            limit = self.model_cfg.max_seq_len - self._max_new(req)
            if len(ids) > limit:
                # middle truncation: instructions usually bracket the content
                head, tail = limit // 2, limit - limit // 2
                ids = ids[:head] + ids[-tail:]
            encoded.append((req, ids))
        # sorted by length: less padding per bucket
        encoded.sort(key=lambda e: len(e[1]))
        B = max(1, self.cfg.max_batch_slots)
        for i in range(0, len(encoded), B):
            for req, res in self._run_group(encoded[i: i + B]):
                results[id(req)] = res
        logger.info("generated %d requests in %.2fs", len(requests),
                    time.time() - t0)
        return [results[id(r)] for r in requests]

    def _max_new(self, req: GenerationRequest) -> int:
        # the smallest of request, config and context: a budget at or past
        # max_seq_len would make the truncation limit non-positive
        return min(req.max_new_tokens, self.cfg.max_tokens,
                   self.model_cfg.max_seq_len - 1)

    @torch.no_grad()
    def _run_group(self, group) -> list[tuple[GenerationRequest,
                                              GenerationResult]]:
        """One lockstep wave: pad to ``max_batch_slots`` rows (a dummy row
        has length 1), prefill the bucketed prompts into a dense cache,
        then decode every row until each has drawn EOS or the wave's
        budget is spent."""
        cfg, dev = self.model_cfg, self.device
        B = max(1, self.cfg.max_batch_slots)
        n = len(group)
        s_bucket = min(_bucket(max(len(ids) for _, ids in group)),
                       cfg.max_seq_len)
        max_new = max(self._max_new(req) for req, _ in group)
        eos = self.tokenizer.eos_id

        tokens = np.full((B, s_bucket), self.tokenizer.pad_id, np.int64)
        lengths = np.ones((B,), np.int64)
        temps = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int64)
        top_p = np.ones((B,), np.float32)
        for j, (req, ids) in enumerate(group):
            tokens[j, : len(ids)] = ids
            lengths[j] = len(ids)
            temps[j] = req.temperature
            top_k[j] = req.top_k
            top_p[j] = min(max(req.top_p, 0.0), 1.0)

        t0 = time.time()
        lens = torch.from_numpy(lengths).to(dev)
        cache = init_kv_cache(cfg, B, s_bucket + max_new, dev,
                              self.params["embed"].dtype)
        positions = torch.arange(s_bucket, device=dev).expand(B, s_bucket)
        logits, cache = forward(self.params, cfg, torch.from_numpy(tokens).to(dev),
                                positions, cache, lens, last_pos=lens - 1)
        # as the continuous scheduler does: ids past the tokenizer's
        # vocabulary (a byte tokenizer on a wider embedding) are never
        # sampled, so every generated id decodes
        limit = (self.tokenizer.vocab_size
                 if self.tokenizer.vocab_size < cfg.vocab_size else None)
        last = logits[:, 0]
        out_buf = torch.zeros((B, max_new), dtype=torch.long, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        n_gen = torch.zeros((B,), dtype=torch.long, device=dev)
        for step in range(max_new):
            if limit is not None:
                last[:, limit:] = float("-inf")
            tok = sample_logits(last, temps, top_k, top_p,
                                generator=self.generator)
            tok = torch.where(done, torch.full_like(tok, eos), tok)
            out_buf[:, step] = tok
            n_gen = torch.where(done, n_gen, torch.full_like(n_gen, step + 1))
            done = done | (tok == eos)
            if step + 1 == max_new or bool(done.all()):
                break
            logits, cache = forward(self.params, cfg, tok[:, None],
                                    (lens + step)[:, None], cache,
                                    lens + step + 1)
            last = logits[:, 0]
        out_tokens = out_buf.cpu().numpy()
        n_generated = n_gen.cpu().numpy()
        dt = time.time() - t0

        results = []
        for j, (req, ids) in enumerate(group):
            gen = out_tokens[j, : int(n_generated[j])].tolist()
            finish = "stop"
            if eos in gen:
                gen = gen[: gen.index(eos)]
            elif len(gen) >= max_new:
                finish = "length"
            text, stop_hit = apply_stop_sequences(self.tokenizer.decode(gen),
                                                  req.stop)
            if stop_hit is not None:
                finish = "stop"
            results.append((req, GenerationResult(
                request_id=req.request_id, text=text,
                prompt_tokens=len(ids), completion_tokens=len(gen),
                finish_reason=finish, stop_sequence=stop_hit,
                device_seconds=dt / max(n, 1))))
        return results
