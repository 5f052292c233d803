"""The process metrics registry (copy of timetabling_ga_tpu/obs/
metrics.py:48-106, 195-265, 343-373, under the same names; the pull
gauges and the histogram are left out until a caller needs them).

Counters and gauges the engine reports into: the trace modes'
`engine.trace_delta_overflow`, `engine.trace_best_{mean,min,max}`,
`engine.polish_passes`, `engine.polish_best_*`, `engine.lahc_best_*`,
and `engine.checkpoints`. Naming is dotted lowercase. The exposition
(Prometheus text, `/metrics`, `--metrics-every`) is not ported yet: a
snapshot is what the port reads.

Thread-safe behind one registry lock; stdlib only.
"""

from __future__ import annotations

import threading


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
    """Last-set value."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors: an
    instrument exists from its first touch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, name: str, kind):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = kind(name, self._lock)
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

    def snapshot(self) -> dict:
        """{"counters": {...}, "gauges": {...}} of every instrument."""
        with self._lock:
            items = list(self._metrics.items())
        counters, gauges = {}, {}
        for name, m in sorted(items):
            v = m.value
            if isinstance(m, Counter):
                counters[name] = int(v) if v == int(v) else round(v, 6)
            else:
                gauges[name] = None if v != v else round(v, 6)
        out: dict = {}
        if counters:
            out["counters"] = counters
        if gauges:
            out["gauges"] = gauges
        return out

    def reset(self) -> None:
        """Drop every instrument (tests only)."""
        with self._lock:
            self._metrics.clear()


# the process registry
REGISTRY = MetricsRegistry()
