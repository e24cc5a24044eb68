"""Typed metric primitives and a registry with Prometheus exposition (a
copy of the reference's ``obs/metrics.py``).

Counter/Gauge/Histogram objects live in one ``MetricsRegistry`` per
engine (and one per server, router and job or session manager); the
scheduler's ``metrics_report()`` is a derived view over them, and
``render_prometheus()`` emits the standard text exposition for scraping.

Histograms carry BOTH fixed log-spaced bucket counts (the Prometheus and
aggregation representation: mergeable across hosts, constant memory) and
a bounded reservoir of raw samples (the percentile representation: exact
p50/p90/p99 over the retained samples).  Standard library and numpy only.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left

import numpy as np

# one-two-five per decade, 1 ms .. 100 s: the span from a single decode
# step to a wedged-link dispatch, ~3 buckets per decade
DEFAULT_LATENCY_BUCKETS_S: tuple[float, ...] = tuple(
    round(m * 10.0 ** e, 6) for e in range(-3, 2) for m in (1.0, 2.5, 5.0)
) + (100.0,)

# pow2 token-count buckets: prefill dispatches range from one decode-block
# tail chunk to a full packed max_len row
POW2_TOKEN_BUCKETS: tuple[float, ...] = tuple(float(2 ** i) for i in range(4, 17))

# occupancy/utilization ratios are bounded [0, 1]: linear tenths, not log
RATIO_BUCKETS: tuple[float, ...] = tuple(round(i / 10.0, 1) for i in range(1, 11))

# millisecond-valued histograms (lmrs_step_gap_ms): 0.1 ms (a warm host
# turnaround) .. 50 s (a wedged dispatch), one-two-five per decade.  The
# values are OBSERVED in ms, so the Prometheus _sum stays in the unit the
# metric name promises.
MS_LATENCY_BUCKETS: tuple[float, ...] = tuple(
    round(m * 10.0 ** e, 6) for e in range(-1, 4) for m in (1.0, 2.5, 5.0)
) + (50000.0,)

_SAMPLE_CAP = 200_000  # same bound (drop oldest half) as the old raw lists


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds covering [lo, hi]."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi (got {lo}, {hi})")
    n = max(2, int(round(per_decade * math.log10(hi / lo))) + 1)
    ratio = (hi / lo) ** (1.0 / (n - 1))
    return tuple(round(lo * ratio ** i, 9) for i in range(n))


class Counter:
    """Monotonic cumulative value (float; token counts stay integral)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name = name
        self.help = help
        self.unit = unit
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += amount


class Gauge:
    """Point-in-time value; ``track_max`` keeps a running peak."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name = name
        self.help = help
        self.unit = unit
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value

    def track_max(self, value: float) -> None:
        if value > self.value:
            self.value = value


class Histogram:
    """Fixed-bucket histogram + bounded raw-sample reservoir.

    Buckets are upper bounds (le), strictly increasing; +Inf is implicit.
    ``percentile_report()`` reproduces the old scheduler ``_latency_pct``
    exactly (np.percentile over the retained samples, ms, 0.1 precision,
    None when empty) so ``metrics_report()`` consumers see identical
    values; the bucket counts serve Prometheus exposition and cross-host
    aggregation, where raw samples cannot travel.
    """

    kind = "histogram"

    def __init__(self, name: str, buckets: tuple[float, ...],
                 help: str = "", unit: str = ""):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"histogram {name}: buckets must be strictly "
                             f"increasing and non-empty (got {buckets})")
        self.name = name
        self.help = help
        self.unit = unit
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.samples: list[float] = []

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        self.samples.append(v)
        if len(self.samples) > _SAMPLE_CAP:  # drop the oldest half;
            del self.samples[: _SAMPLE_CAP // 2]  # percentiles stay recent

    def reset(self) -> None:
        """Drop everything (bench warmup isolation — compile-time gaps are
        orders of magnitude over steady state and must not pollute either
        the percentiles or the scrape)."""
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self.samples.clear()

    def cumulative_counts(self) -> list[int]:
        """Prometheus-style cumulative per-le counts, +Inf last."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def percentile_report(self, scale: float = 1e3,
                          ndigits: int = 1) -> dict | None:
        """p50/p90/p99 over retained samples (default: seconds -> ms), or
        None when nothing was measured — metrics consumers then omit the
        block instead of reporting zeros (old ``_latency_pct`` contract)."""
        if not self.samples:
            return None
        p50, p90, p99 = np.percentile(np.asarray(self.samples), [50, 90, 99])
        return {"p50": round(float(p50) * scale, ndigits),
                "p90": round(float(p90) * scale, ndigits),
                "p99": round(float(p99) * scale, ndigits),
                "n": len(self.samples)}


class MetricsRegistry:
    """Name-keyed metric store; get-or-create so wiring sites stay terse."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._register(name, lambda: Counter(name, help, unit), Counter)

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        return self._register(name, lambda: Gauge(name, help, unit), Gauge)

    def histogram(self, name: str,
                  buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_S,
                  help: str = "", unit: str = "") -> Histogram:
        return self._register(
            name, lambda: Histogram(name, buckets, help, unit), Histogram)

    def _register(self, name: str, make, want_type):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = make()
            elif not isinstance(m, want_type):
                raise ValueError(f"metric {name} already registered as "
                                 f"{m.kind}")
            return m

    def get(self, name: str):
        return self._metrics.get(name)

    def metrics(self) -> list:
        return list(self._metrics.values())

    # ------------------------------------------------------------ exposition

    def render_prometheus(self, labels: dict[str, str] | None = None) -> str:
        """Prometheus text exposition (format 0.0.4) of every metric."""
        lines: list[str] = []
        for m in self._metrics.values():
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                cum = m.cumulative_counts()
                for le, c in zip(m.buckets, cum[:-1]):
                    lines.append(_sample(f"{m.name}_bucket",
                                         {**(labels or {}), "le": _fmt(le)}, c))
                lines.append(_sample(f"{m.name}_bucket",
                                     {**(labels or {}), "le": "+Inf"}, cum[-1]))
                lines.append(_sample(f"{m.name}_sum", labels, m.sum))
                lines.append(_sample(f"{m.name}_count", labels, m.count))
            else:
                lines.append(_sample(m.name, labels, m.value))
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Canonical number formatting: integral values render without the
    trailing .0 (token counts and bucket counts read as ints)."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _sample(name: str, labels: dict[str, str] | None, value) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label(str(v))}"'
                        for k, v in labels.items())
        return f"{name}{{{body}}} {_fmt(float(value))}"
    return f"{name} {_fmt(float(value))}"


# ---------------------------------------------------- cross-host aggregation

_COMMENT = ("# HELP", "# TYPE")


def add_label_to_exposition(text: str, label: str, value: str) -> str:
    """Inject ``label="value"`` into every sample line of a Prometheus text
    page (the router's per-host relabeling: backend registries know nothing
    of the fleet, the router adds ``host=...`` so aggregated series never
    collide).  Comment and blank lines pass through untouched."""
    out: list[str] = []
    esc = _escape_label(value)
    for line in text.splitlines():
        s = line.strip()
        if not s or s.startswith("#"):
            out.append(line)
            continue
        if "{" in s:  # labeled sample: name{...} value — splice in front
            name, _, tail = s.partition("{")
            out.append(f'{name}{{{label}="{esc}",{tail}')
        else:  # bare sample: name value
            name_part, _, rest = s.partition(" ")
            out.append(f'{name_part}{{{label}="{esc}"}} {rest}')
    return "\n".join(out) + "\n"


def merge_expositions(pages: list[str]) -> str:
    """Merge relabeled per-host pages into one valid exposition: the text
    format requires all lines of a metric to form ONE contiguous group
    with a single # HELP/# TYPE header, so samples are regrouped by metric
    family (histogram ``_bucket``/``_sum``/``_count`` children fold into
    their parent) in first-appearance order."""
    helps: dict[str, str] = {}
    types: dict[str, str] = {}
    samples: dict[str, list[str]] = {}

    def family(sample_name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if sample_name.endswith(suffix):
                base = sample_name[: -len(suffix)]
                if base in types:
                    return base
        return sample_name

    for page in pages:
        for line in page.splitlines():
            s = line.strip()
            if not s:
                continue
            if s.startswith(_COMMENT):
                parts = s.split()
                kind, name = parts[1], parts[2]
                (helps if kind == "HELP" else types).setdefault(name, s)
                samples.setdefault(name, [])
            elif not s.startswith("#"):
                name = s.split("{", 1)[0].split(" ", 1)[0]
                samples.setdefault(family(name), []).append(line)
    out: list[str] = []
    for name, lines in samples.items():
        if name in helps:
            out.append(helps[name])
        if name in types:
            out.append(types[name])
        out.extend(lines)
    return "\n".join(out) + "\n"
