"""Per-stage wall-clock spans (the reference's stage report, without the
profiler hooks: tracing is not ported yet)."""

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


@dataclass
class StageTimer:
    """Collects named stage spans (seconds, summed per name)."""

    spans: dict[str, float] = field(default_factory=dict)
    _t0: float = field(default_factory=time.time)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.time()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + (time.time() - start)

    @property
    def total(self) -> float:
        return time.time() - self._t0

    def report(self) -> dict[str, float]:
        out = {k: round(v, 4) for k, v in self.spans.items()}
        out["total"] = round(self.total, 4)
        return out
