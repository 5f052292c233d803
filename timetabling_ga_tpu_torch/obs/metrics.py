"""The process metrics registry (copy of timetabling_ga_tpu/obs/
metrics.py, under the same names): counters, gauges (a last-set value or
a pull function sampled at read time) and fixed-bucket histograms with
exemplars, in one namespace that the engine, the serve scheduler, the
record writer and the usage ledger share.

A snapshot is the metricsEntry payload (`--obs --metrics-every N`, the
serve path's `{"stats": true}`); `to_prometheus` is the text exposition
(format 0.0.4) that `{"stats": "prometheus"}` answers with, and
`to_openmetrics` the OpenMetrics rendering with the histogram buckets'
exemplars and the `# EOF` trailer. Names are dotted lowercase
(`engine.gens_per_sec`); the expositions map dots to underscores
(`tt_engine_gens_per_sec`).

Thread-safe behind one registry lock; stdlib only, so the offline
readers (`trace`, `stats`, `quality`, `usage`) import it without torch.
"""

from __future__ import annotations

import math
import re
import threading

# log-spaced latency buckets (seconds): 1 ms .. 10 min, the range one
# dispatch (~100 ms), one quantum (~1 s) and one solve job (~minutes)
# all land in with resolution proportional to magnitude
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   600.0)


class Counter:
    """Monotone accumulator. `inc` with a negative delta raises — a
    decreasing 'counter' is a gauge wearing the wrong type, and the
    Prometheus scrape semantics (rate() over resets) depend on
    monotonicity."""

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

    def __init__(self, name: str, lock: threading.Lock, fn=None):
        self.name = name
        self._value = 0.0
        self._fn = fn
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def bind(self, fn) -> None:
        """Re-point a pull gauge at a new source (each engine.run binds
        `writer.queue_depth` to ITS writer; the old writer is gone).
        `bind(None)` unbinds: the gauge freezes at its last `set()`
        value and stops holding the old source (and everything its
        closure reaches — a finished run's writer and output stream)
        alive through the process-global registry."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                # a pull source may outlive its object (a closed writer's
                # queue); a snapshot must degrade, never raise
                return float("nan")
        return self._value


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max and interpolated
    percentile estimates.

    Buckets are cumulative-less-or-equal boundaries (Prometheus `le`
    semantics) plus an implicit +Inf bucket. `percentile(q)` linearly
    interpolates within the target bucket's bounds — exact enough for
    p50/p95 dashboards at log-spaced resolution, with O(1) memory
    (no reservoir: serve streams are unbounded).

    Exemplars (OpenMetrics): `observe(v, exemplar={"job": "j42"})`
    remembers the LAST exemplar landing in each bucket — one
    (labels, value) pair per bucket, O(buckets) memory. A p99 spike on
    the scrape dashboard then joins back to the concrete job/dispatch
    that caused it (its jobEntry lifecycle is on the record stream
    under the same id); `to_openmetrics` renders them, the 0.0.4 text
    exposition ignores them (no exemplar syntax there)."""

    __slots__ = ("name", "buckets", "_counts", "count", "sum",
                 "_min", "_max", "_exemplars", "_lock")

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

    def observe(self, v: float, exemplar: dict | None = None) -> None:
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
                    frac = (target - seen) / c
                    est = lo + frac * (hi - lo)
                    # clamp into the observed range (interpolation can
                    # undershoot the true min in the first bucket)
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
    """Name -> instrument map. get-or-create accessors: callers never
    pre-register, so an instrument exists from its first touch and a
    snapshot sees every name ever used this process."""

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
        """Pull gauge: `fn()` is sampled at snapshot time. Re-binding an
        existing name re-points it (per-run sources like a writer's
        queue)."""
        g = self._get(name, Gauge)
        g.bind(fn)
        return g

    def freeze(self, name: str, value: float) -> None:
        """Freeze a pull gauge at `value` and unbind its source (see
        Gauge.bind): run/service teardown must not leave the
        process-global registry holding closures over a finished
        writer or queue."""
        g = self.gauge(name)
        g.set(value)
        g.bind(None)

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def snapshot(self) -> dict:
        """The metricsEntry payload: {"counters": {...}, "gauges":
        {...}, "histograms": {name: {count, sum, p50, p95, ...}}}."""
        with self._lock:
            items = list(self._metrics.items())
        counters, gauges, hists = {}, {}, {}
        for name, m in sorted(items):
            if isinstance(m, Counter):
                v = m.value
                counters[name] = int(v) if v == int(v) else round(v, 6)
            elif isinstance(m, Gauge):
                v = m.value
                gauges[name] = (None if v != v          # nan -> null
                                else round(v, 6))
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

    def to_prometheus(self, prefix: str = "tt") -> str:
        """Prometheus text exposition (format 0.0.4): counters as
        `<prefix>_<name>_total`, gauges plain, histograms as the
        standard `_bucket{le=...}` / `_sum` / `_count` triplet.

        Rendered UNDER the registry lock (one lock shared by every
        instrument): the pull front scrapes from its own handler
        threads, and a histogram read racing observe() could otherwise
        emit `x_count` != its `+Inf` bucket — invalid exposition a
        strict parser rejects. Render cost is O(metrics) string ops;
        pull-gauge sources must not touch the registry (none do — they
        read queue sizes)."""
        lines: list[str] = []
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                pn = _prom_name(f"{prefix}.{name}")
                if isinstance(m, Counter):
                    lines.append(f"# TYPE {pn}_total counter")
                    lines.append(f"{pn}_total {_prom_num(m.value)}")
                elif isinstance(m, Gauge):
                    lines.append(f"# TYPE {pn} gauge")
                    lines.append(f"{pn} {_prom_num(m.value)}")
                else:
                    lines.append(f"# TYPE {pn} histogram")
                    cum = 0
                    for i, b in enumerate(m.buckets):
                        cum += m._counts[i]
                        lines.append(
                            f'{pn}_bucket{{le="{_prom_num(b)}"}} {cum}')
                    lines.append(f'{pn}_bucket{{le="+Inf"}} {m.count}')
                    lines.append(f"{pn}_sum {_prom_num(m.sum)}")
                    lines.append(f"{pn}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_openmetrics(self, prefix: str = "tt") -> str:
        """OpenMetrics 1.0 text exposition — what the pull front's
        `/metrics` endpoint serves (obs/http.py). Same sample names as
        `to_prometheus` plus histogram bucket EXEMPLARS
        (`... # {job="j42"} 0.93`) and the mandatory `# EOF` trailer.
        Counters drop the `_total` suffix from the metric NAME line
        (OpenMetrics: the family is `x`, the sample `x_total`).

        Rendered under the registry lock, like `to_prometheus` (and
        more urgently: this IS the scrape endpoint's payload, read
        from handler threads while the dispatch path observes)."""
        lines: list[str] = []
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                pn = _prom_name(f"{prefix}.{name}")
                if isinstance(m, Counter):
                    lines.append(f"# TYPE {pn} counter")
                    lines.append(f"{pn}_total {_prom_num(m.value)}")
                elif isinstance(m, Gauge):
                    lines.append(f"# TYPE {pn} gauge")
                    lines.append(f"{pn} {_prom_num(m.value)}")
                else:
                    lines.append(f"# TYPE {pn} histogram")
                    cum = 0
                    bounds = ([_prom_num(b) for b in m.buckets]
                              + ["+Inf"])
                    for i, le in enumerate(bounds):
                        cum += m._counts[i]
                        line = f'{pn}_bucket{{le="{le}"}} {cum}'
                        ex = m._exemplars[i]
                        if ex is not None:
                            labels, v = ex
                            lbl = ",".join(
                                f'{k}="{_escape_label(w)}"'
                                for k, w in sorted(labels.items()))
                            line += f" # {{{lbl}}} {_prom_num(v)}"
                        lines.append(line)
                    lines.append(f"{pn}_sum {_prom_num(m.sum)}")
                    lines.append(f"{pn}_count {m.count}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every instrument (tests only — production code keeps
        process-lifetime counters, the bench legs diff them)."""
        with self._lock:
            self._metrics.clear()


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _escape_label(v: str) -> str:
    """Label-value escaping per the exposition formats (backslash,
    double quote, newline)."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_num(v: float) -> str:
    if v != v:
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# THE process registry: engine, serve, writer and bench all meet here.
REGISTRY = MetricsRegistry()
