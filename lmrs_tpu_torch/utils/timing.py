"""Per-stage wall-clock spans (a copy of the reference's
``utils/timing.py``): each stage is mirrored onto the lifecycle tracer's
pipeline track, and with ``profile=True`` wrapped in a
``torch.profiler.record_function`` range and an NVTX range (on a card), the
port's counterpart of the reference's ``jax.profiler.TraceAnnotation``."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


def format_duration(seconds: float) -> str:
    """Human duration: ``1h 2m 3s`` / ``2m 3s`` / ``3s``."""
    seconds = int(seconds)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    if h:
        return f"{h}h {m}m {s}s"
    if m:
        return f"{m}m {s}s"
    return f"{s}s"


@contextlib.contextmanager
def _profiler_range(name: str):
    """A named range in a ``torch.profiler`` capture and, on a card, in
    NVTX (what an external CUDA profiler shows)."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@dataclass
class StageTimer:
    """Collects named stage spans (seconds, summed per name); mirrors each
    onto the tracer's pipeline track, and with ``profile`` into profiler
    ranges."""

    profile: bool = False
    spans: dict[str, float] = field(default_factory=dict)
    _t0: float = field(default_factory=time.time)

    @contextlib.contextmanager
    def stage(self, name: str):
        ctx = (_profiler_range(name) if self.profile
               else contextlib.nullcontext())
        start = time.time()
        try:
            with ctx:
                yield
        finally:
            end = time.time()
            self.spans[name] = self.spans.get(name, 0.0) + (end - start)
            # the engine-level spans nest under these in Perfetto
            from lmrs_tpu_torch.obs import PID_PIPELINE, get_tracer

            tr = get_tracer()
            if tr:
                tr.complete(name, start, end, pid=PID_PIPELINE)

    @property
    def total(self) -> float:
        return time.time() - self._t0

    def report(self) -> dict[str, float]:
        out = {k: round(v, 4) for k, v in self.spans.items()}
        out["total"] = round(self.total, 4)
        return out
