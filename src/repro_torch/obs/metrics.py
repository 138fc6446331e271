"""Process-wide metrics registry: counters, gauges, histograms with labels.

A deliberately small Prometheus-shaped surface (no external dependency)
that the serving layer publishes into:

    reg = get_registry()
    reg.counter("render_frames_total",
                "Frames rendered", ("res",)).inc(8, res="128x128")
    reg.gauge("engine_jit_cache_size", "Compiled executables").set(3)
    reg.histogram("render_batch_latency_seconds", "Batch wall",
                  ("res",)).observe(0.012, res="128x128")
    print(reg.expose())        # Prometheus text exposition format

Everything is thread-safe (one lock per registry; metric mutations take
it). Label values are stringified; a metric's label *names* are fixed at
first registration and re-registration with a different type or label set
raises — the same name must mean the same thing process-wide.

`get_registry()` returns the process default; tests that need isolation
construct their own `MetricsRegistry()` and pass it down (e.g.
`Telemetry(registry=...)`).
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   50.0, 100.0, 500.0, float("inf"))


def _label_key(labelnames: tuple, labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(f"labels {sorted(labels)} != declared "
                         f"{sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


def _fmt_labels(labelnames: tuple, key: tuple, extra: str = "") -> str:
    pairs = [f'{n}="{v}"' for n, v in zip(labelnames, key)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._series: dict[tuple, float] = {}

    def _bump(self, labels: dict, amount: float, *, set_to: bool):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            if set_to:
                self._series[key] = amount
            else:
                self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            series = dict(self._series)
        for key in sorted(series):
            lines.append(f"{self.name}"
                         f"{_fmt_labels(self.labelnames, key)} "
                         f"{series[key]}")
        return lines


class Counter(_Metric):
    """Monotonically increasing count."""
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        self._bump(labels, amount, set_to=False)


class Gauge(_Metric):
    """A value that can go either way."""
    kind = "gauge"

    def set(self, value: float, **labels):
        self._bump(labels, float(value), set_to=True)

    def inc(self, amount: float = 1.0, **labels):
        self._bump(labels, amount, set_to=False)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each `le` bucket
    counts observations <= its bound; `+Inf` equals `_count`)."""
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or bs[-1] != float("inf"):
            bs = bs + (float("inf"),)
        self.buckets = bs
        # per label key: [bucket counts..., sum, count]
        self._hist: dict[tuple, list] = {}

    def observe(self, value: float, **labels):
        key = _label_key(self.labelnames, labels)
        value = float(value)
        with self._lock:
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = [0] * len(self.buckets) + [0.0, 0]
            for i, b in enumerate(self.buckets):
                if value <= b:
                    h[i] += 1
            h[-2] += value
            h[-1] += 1

    def value(self, **labels) -> float:
        """Observation count for the label set (sum is `sum_value`)."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            h = self._hist.get(key)
            return float(h[-1]) if h else 0.0

    def sum_value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            h = self._hist.get(key)
            return float(h[-2]) if h else 0.0

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            hist = {k: list(v) for k, v in self._hist.items()}
        for key in sorted(hist):
            h = hist[key]
            for i, b in enumerate(self.buckets):
                le = "+Inf" if b == float("inf") else repr(b)
                labels = _fmt_labels(self.labelnames, key, f'le="{le}"')
                lines.append(f"{self.name}_bucket{labels} {h[i]}")
            lines.append(f"{self.name}_sum"
                         f"{_fmt_labels(self.labelnames, key)} {h[-2]}")
            lines.append(f"{self.name}_count"
                         f"{_fmt_labels(self.labelnames, key)} {h[-1]}")
        return lines


class MetricsRegistry:
    """Get-or-create registry of named metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}{m.labelnames}, requested "
                        f"{cls.__name__}{tuple(labelnames)}")
                return m
            m = cls(name, help, labelnames, threading.Lock(), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def expose(self) -> str:
        """Prometheus text exposition of every registered metric."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self):
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-default registry (what the serving layer publishes into
    unless handed an explicit one)."""
    return _REGISTRY
