"""History rings: bounded per-series metrics history (port of
timetabling_ga_tpu/obs/history.py, under the same names).

The registry's gauges and the metricsEntry snapshots are instantaneous;
"sustained backlog" or "what did this gauge do over the last 30
seconds" needs history. `HistoryRing` samples the process
MetricsRegistry every `every_s` seconds FROM ITS OWN DAEMON THREAD
(atexit- and `sys.is_finalizing`-guarded, behind the `history` fault
site: a parked or dead sampler means stale history, never a stalled
dispatch or writer drain), keeping a fixed-capacity ring of `(t, value)`
samples per series. Counters and gauges are sampled as they are; each
histogram contributes its `<name>.count` and `<name>.sum` series.

Window queries (lock-guarded ring reads; none touches the registry):

  rate(name, window)        (last - first) / dt over the window
  mean_over(name, window)   the mean of the window's samples
  sustained(name, op, threshold, for_s)
                            True iff the ring COVERS the last `for_s`
                            seconds (its oldest in-window sample is at
                            least `for_s - every_s` old) and EVERY
                            sample in that window satisfies
                            `value <op> threshold`: a fresh ring that
                            has not watched the signal that long
                            answers False, never a guess
  window(window_s)          {name: [[t, v], ...]}: the payload of
                            `GET /metrics/history?window=S` on the pull
                            front (obs/http.py) and the incident
                            bundle's `history` section (obs/flight.py)

Timestamps are seconds on the ring's own monotonic clock (`now=`
injectable for tests). Capacity is per series (`TT_HISTORY_CAP`, read
at import, default 600 samples: ten minutes at the default 1 s cadence).

Stdlib only.
"""

from __future__ import annotations

import atexit
import collections
import operator
import os
import sys
import threading
import time

from timetabling_ga_tpu_torch.obs import metrics as obs_metrics

# per-series ring capacity: ten minutes of samples at the default 1 s
# cadence — enough for every window the autoscaler primitives take,
# bounded regardless of process lifetime
HISTORY_CAP = int(os.environ.get("TT_HISTORY_CAP", "600"))

_OPS = {">=": operator.ge, "<=": operator.le, ">": operator.gt,
        "<": operator.lt, "==": operator.eq}


def _faults():
    """Lazy import (the MemPoller pattern): the sampler thread exists
    only inside engine and serve processes."""
    from timetabling_ga_tpu_torch.runtime import faults
    return faults


class HistoryRing:
    """Fixed-capacity per-series sample rings over one MetricsRegistry.

    `start()` launches the sampler daemon thread; `sample_once()` is
    the testable unit (and returns False when the thread should exit —
    injected death or interpreter teardown). All query methods read
    under the ring lock and never touch the registry, so the
    `/metrics/history` handler path stays a pure observer."""

    def __init__(self, registry=None, every_s: float = 1.0,
                 capacity: int | None = None, now=time.monotonic):
        self._reg = (obs_metrics.REGISTRY if registry is None
                     else registry)
        self.every_s = max(0.05, float(every_s))
        self._cap = int(capacity if capacity is not None
                        else HISTORY_CAP)
        self._now = now
        self._series: dict[str, collections.deque] = {}
        self._lock = threading.Lock()
        self._samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="tt-history", daemon=True)

    # -- sampling (the off-path daemon thread) --------------------------

    def start(self) -> "HistoryRing":
        self._thread.start()
        # stop the sampler before interpreter teardown even on abrupt
        # exits (the MemPoller discipline — a daemon thread snapshotting
        # a registry mid-teardown is undefined); close() is idempotent,
        # normal owners still call it from their finallys
        atexit.register(self.close)
        return self

    def alive(self) -> bool:
        return self._thread.is_alive()

    def sample_once(self) -> bool:
        """One registry snapshot into the rings; False when the sampler
        thread should exit (injected death / teardown)."""
        if sys.is_finalizing():
            return False
        try:
            _faults().maybe_fail("history")
            snap = self._reg.snapshot()
        except SystemExit:
            return False            # injected death: exit silently
        except Exception:
            return True             # a torn snapshot skips one tick
        t = self._now()
        points: list[tuple[str, float]] = []
        for kind in ("counters", "gauges"):
            for name, v in (snap.get(kind) or {}).items():
                if isinstance(v, (int, float)) and v == v:
                    points.append((name, float(v)))
        for name, h in (snap.get("histograms") or {}).items():
            points.append((f"{name}.count", float(h.get("count", 0))))
            points.append((f"{name}.sum", float(h.get("sum", 0.0))))
        with self._lock:
            self._samples += 1
            for name, v in points:
                ring = self._series.get(name)
                if ring is None:
                    ring = self._series[name] = collections.deque(
                        maxlen=self._cap)
                ring.append((t, v))
        return True

    def _loop(self) -> None:
        while True:
            if not self.sample_once():
                return
            if self._stop.wait(self.every_s):
                return

    def close(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:   # never-started: no join
            self._thread.join(timeout=2.0)   # a hung sampler is
            #                                  abandoned (daemon),
            #                                  never waited out
        atexit.unregister(self.close)

    # -- window queries --------------------------------------------------

    def _window(self, name: str, window_s: float | None
                ) -> list[tuple[float, float]]:
        with self._lock:
            ring = self._series.get(name)
            pts = list(ring) if ring is not None else []
        if window_s is None or not pts:
            return pts
        cut = self._now() - max(0.0, float(window_s))
        return [p for p in pts if p[0] >= cut]

    def series(self, name: str, window_s: float | None = None
               ) -> list[tuple[float, float]]:
        """The raw (t, value) samples of one series, newest last."""
        return self._window(name, window_s)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def rate(self, name: str, window_s: float) -> float | None:
        """(last - first) / dt over the window — the counter-rate
        primitive. None with fewer than two samples (or zero dt)."""
        pts = self._window(name, window_s)
        if len(pts) < 2:
            return None
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        dt = t1 - t0
        return (v1 - v0) / dt if dt > 0 else None

    def mean_over(self, name: str, window_s: float) -> float | None:
        """Mean of the window's samples — the gauge-trend primitive.
        None when the window holds no samples."""
        pts = self._window(name, window_s)
        if not pts:
            return None
        return sum(v for _, v in pts) / len(pts)

    def sustained(self, name: str, op: str, threshold: float,
                  for_s: float) -> bool:
        """True iff the ring COVERS the last `for_s` seconds of `name`
        and EVERY sample in that window satisfies `value <op>
        threshold` (op in >=, <=, >, <, ==) — the documented
        autoscaler trigger primitive (module docstring). Coverage
        means the window's OLDEST sample is at least `for_s` old: a
        ring that has not watched the signal that long answers False,
        never a guess."""
        cmp = _OPS.get(op)
        if cmp is None:
            raise ValueError(f"sustained() op must be one of "
                             f"{sorted(_OPS)}, got {op!r}")
        for_s = max(0.0, float(for_s))
        pts = self._window(name, for_s)
        if not pts:
            return False
        if self._now() - pts[0][0] < for_s - self.every_s:
            # the window is not covered: the oldest in-window sample is
            # too young (one cadence of slack — the sampler ticks at
            # every_s, so exact coverage would never be observable)
            return False
        return all(cmp(v, threshold) for _, v in pts)

    def window(self, window_s: float | None = None) -> dict:
        """Every series' in-window samples — the
        `GET /metrics/history?window=S` payload (and the incident
        bundle's `history` section, obs/flight.py). ONE locked pass
        with ONE cut timestamp: every series is filtered against the
        same 'now', and a scrape over many series costs one lock
        round-trip, not one per series."""
        cut = (None if window_s is None
               else self._now() - max(0.0, float(window_s)))
        with self._lock:
            samples = self._samples
            series = {n: [[round(t, 6), v] for t, v in ring
                          if cut is None or t >= cut]
                      for n, ring in sorted(self._series.items())}
        return {"every_s": self.every_s, "capacity": self._cap,
                "samples": samples, "series": series}
