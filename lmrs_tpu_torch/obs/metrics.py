"""Counters, gauges, fixed-bucket histograms, a registry with Prometheus
text exposition, and the cross-host relabel and merge the router's fleet
page needs (a trimmed copy of the reference's ``obs/metrics.py``: what the
server, the router and the job and session managers use; the histograms'
sample reservoir and the scheduler's typed registry come with the
observability slice).  Standard library only."""

from __future__ import annotations

import threading
from bisect import bisect_left

# one-two-five per decade, 1 ms .. 100 s
DEFAULT_LATENCY_BUCKETS_S: tuple[float, ...] = tuple(
    round(m * 10.0 ** e, 6) for e in range(-3, 2) for m in (1.0, 2.5, 5.0)
) + (100.0,)

# ratios in [0, 1]: linear tenths
RATIO_BUCKETS: tuple[float, ...] = tuple(round(i / 10.0, 1) for i in range(1, 11))


class Counter:
    """Monotonic cumulative value."""

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
    """Point-in-time value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name = name
        self.help = help
        self.unit = unit
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Fixed-bucket histogram: bucket upper bounds (le), strictly
    increasing, +Inf implicit; a count, a sum and per-bucket counts."""

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

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative_counts(self) -> list[int]:
        """Prometheus-style cumulative per-le counts, +Inf last."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class MetricsRegistry:
    """Name-keyed metric store; get-or-create."""

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
    """Integral values render without the trailing .0."""
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


_COMMENT = ("# HELP", "# TYPE")


def add_label_to_exposition(text: str, label: str, value: str) -> str:
    """Inject ``label="value"`` into every sample line of a Prometheus text
    page (the router's per-host relabel, so fleet series never collide);
    comment and blank lines pass through."""
    out: list[str] = []
    esc = _escape_label(value)
    for line in text.splitlines():
        s = line.strip()
        if not s or s.startswith("#"):
            out.append(line)
            continue
        if "{" in s:  # labeled sample: splice the label in front
            name, _, tail = s.partition("{")
            out.append(f'{name}{{{label}="{esc}",{tail}')
        else:  # bare sample: name value
            name_part, _, rest = s.partition(" ")
            out.append(f'{name_part}{{{label}="{esc}"}} {rest}')
    return "\n".join(out) + "\n"


def merge_expositions(pages: list[str]) -> str:
    """Merge pages into one valid exposition: each family's samples in one
    contiguous group under a single # HELP/# TYPE header (histogram
    ``_bucket``/``_sum``/``_count`` children fold into their parent), in
    first-appearance order."""
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
