"""The process metrics registry (copy of timetabling_ga_tpu/obs/
metrics.py:43-265, 343-373, under the same names; the exemplars'
OpenMetrics rendering is left out with the exposition).

Counters and gauges the engine reports into: the trace modes'
`engine.trace_delta_overflow`, `engine.trace_best_{mean,min,max}`,
`engine.polish_passes`, `engine.polish_best_*`, `engine.lahc_best_*`,
and `engine.checkpoints`; the dispatch pipeline's
`engine.host_gap_ms_per_gen` and `engine.device_busy_frac`; the supervisor's `engine.recoveries`,
`engine.degrade_level`, `engine.recovery_budget_configured`,
`engine.recovery_budget_remaining` and `engine.recovery_seconds` (the
last rehydrate's wall, JAX's `recover` span); `faults.injected` (runtime/
faults.py); the record writer's pull gauge `writer.queue_depth`; the serve scheduler's `serve.*` counters (among them
`serve.jobs_shed` and `serve.job_recoveries`), gauges (some pulled at
snapshot time, `gauge_fn`) and the `serve.job_seconds` histogram. Naming is dotted lowercase. The
exposition (Prometheus text, `/metrics`, `--metrics-every`) is not
ported yet: a snapshot (the metricsEntry payload) is what the port
reads.

Thread-safe behind one registry lock; stdlib only.
"""

from __future__ import annotations

import math
import threading

# histogram bucket bounds (seconds), JAX obs/metrics.py:43
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   600.0)


class Counter:
    """Monotone accumulator; `inc` with a negative delta raises."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-set value, or a pull function sampled at read time."""

    __slots__ = ("name", "_value", "_fn", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value = 0.0
        self._fn = None
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def bind(self, fn) -> None:
        """Re-point a pull gauge at a new source; `bind(None)` freezes
        it at its last `set()` value."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                # a pull source may outlive its object: a snapshot
                # degrades, never raises
                return float("nan")
        return self._value


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max and interpolated
    percentile estimates (Prometheus `le` bounds plus +Inf). `observe`
    may carry an exemplar (e.g. {"job": "j42"}): the last one landing in
    each bucket is kept."""

    __slots__ = ("name", "buckets", "_counts", "count", "sum", "_min",
                 "_max", "_exemplars", "_lock")

    def __init__(self, name: str, lock: threading.Lock, buckets=None):
        self.name = name
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)
        self._exemplars: list = [None] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = lock

    def observe(self, v: float, exemplar: dict = None) -> None:
        v = float(v)
        with self._lock:
            i = 0
            for i, b in enumerate(self.buckets):
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if exemplar:
                self._exemplars[i] = (
                    {str(k): str(w) for k, w in exemplar.items()}, v)

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]); nan when empty."""
        with self._lock:
            if self.count == 0:
                return float("nan")
            target = q * self.count
            seen = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                lo = self.buckets[i - 1] if i > 0 else min(self._min, 0.0)
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self._max)
                if seen + c >= target:
                    est = lo + (target - seen) / c * (hi - lo)
                    return min(max(est, self._min), self._max)
                seen += c
            return self._max

    def summary(self) -> dict:
        with self._lock:
            count, total = self.count, self.sum
        if count == 0:
            return {"count": 0, "sum": 0.0}
        return {"count": count, "sum": round(total, 6),
                "min": round(self._min, 6), "max": round(self._max, 6),
                "mean": round(total / count, 6),
                "p50": round(self.percentile(0.50), 6),
                "p95": round(self.percentile(0.95), 6),
                "p99": round(self.percentile(0.99), 6)}


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors: an
    instrument exists from its first touch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, name: str, kind, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = kind(name, self._lock, **kw)
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def gauge_fn(self, name: str, fn) -> Gauge:
        """Pull gauge: `fn()` is sampled at snapshot time; re-binding a
        name re-points it."""
        g = self._get(name, Gauge)
        g.bind(fn)
        return g

    def freeze(self, name: str, value: float) -> None:
        """Freeze a pull gauge at `value` and drop its source (a closed
        service must not stay reachable through the registry)."""
        g = self.gauge(name)
        g.set(value)
        g.bind(None)

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def snapshot(self) -> dict:
        """The metricsEntry payload: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count, sum, p50, p95, ...}}}."""
        with self._lock:
            items = list(self._metrics.items())
        counters, gauges, hists = {}, {}, {}
        for name, m in sorted(items):
            if isinstance(m, Counter):
                v = m.value
                counters[name] = int(v) if v == int(v) else round(v, 6)
            elif isinstance(m, Gauge):
                v = m.value
                gauges[name] = None if v != v else round(v, 6)
            else:
                hists[name] = m.summary()
        out: dict = {}
        if counters:
            out["counters"] = counters
        if gauges:
            out["gauges"] = gauges
        if hists:
            out["histograms"] = hists
        return out

    def reset(self) -> None:
        """Drop every instrument (tests only)."""
        with self._lock:
            self._metrics.clear()


# the process registry
REGISTRY = MetricsRegistry()
