"""Device memory telemetry (port of the memory side of timetabling_ga_tpu/
obs/cost.py:94 and :464-572, under the same names).

`MemPoller` samples a stats function on its own daemon thread every
`interval_s` seconds and feeds the `device.mem_*` gauges
(`bytes_in_use`, `bytes_limit`, `peak_bytes_in_use`, `frac_used`) and
the `device.mem_polls` counter. The pull front's /readyz turns
`device.mem_frac_used` >= NEAR_HBM_FRAC (`TT_MEM_READY_FRAC`, read at
import, default 0.92) into the `near_hbm_limit` reason (obs/http.py),
and the history ring carries the series into incident bundles
(obs/flight.py). `torch_memory_stats_fn` is the stats source on the
card, the counterpart of JAX's `jax_memory_stats_fn`.

The rest of JAX's obs/cost.py (the compile observatory, CostProgram,
ProfileCapture and the `profile` reader) is not ported yet.

Stdlib only at import: torch is imported inside
`torch_memory_stats_fn`, so the pull front and the readers that import
this module stay torch-free.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading

from timetabling_ga_tpu_torch.obs import metrics as obs_metrics

# /readyz's near_hbm_limit threshold on device.mem_frac_used
NEAR_HBM_FRAC = float(os.environ.get("TT_MEM_READY_FRAC", "0.92"))


def _faults():
    from timetabling_ga_tpu_torch.runtime import faults
    return faults


def torch_memory_stats_fn(device):
    """A stats source for MemPoller reading the caching allocator of
    `device`: `bytes_in_use` is its current allocated bytes,
    `peak_bytes_in_use` their peak, and `bytes_limit` the card's total
    memory from `torch.cuda.mem_get_info`, read once here. On the CPU
    the source returns None, as JAX's does on a backend without
    allocator stats.

    The reads are host-side allocator counters: they never synchronize
    a stream, so the poller thread cannot stall a dispatch."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return lambda: None
    limit = int(torch.cuda.mem_get_info(device)[1])

    def read():
        return {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
                "bytes_limit": limit,
                "peak_bytes_in_use": int(
                    torch.cuda.max_memory_allocated(device))}

    return read


class MemPoller:
    """Off-dispatch-path device memory telemetry: a daemon thread
    samples `stats_fn()` every `interval_s` seconds and feeds the
    `device.mem_*` gauges (`bytes_in_use`, `bytes_limit`,
    `peak_bytes_in_use`, `frac_used`) plus a `device.mem_polls`
    counter. /readyz turns `device.mem_frac_used` >= NEAR_HBM_FRAC into
    the `near_hbm_limit` degraded reason.

    Fault site `mem_poll` fires once per sample on THIS thread: `hang`
    parks the poller (gauges go stale, nothing else notices), `die`
    ends it silently — dispatch, serve, and writer drain never wait on
    it. Writes no records, so the JSONL stream is identical with the
    poller on or off."""

    def __init__(self, stats_fn, interval_s: float = 1.0, registry=None):
        self._stats_fn = stats_fn
        self._interval = max(0.05, float(interval_s))
        self._reg = (obs_metrics.REGISTRY if registry is None
                     else registry)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="tt-mem-poll", daemon=True)

    def start(self) -> "MemPoller":
        self._thread.start()
        # stop the poller before interpreter teardown even on abrupt
        # exits (close() is idempotent; owners still call it from their
        # finallys)
        atexit.register(self.close)
        return self

    def alive(self) -> bool:
        return self._thread.is_alive()

    def poll_once(self) -> bool:
        """One sample; False when the thread should exit (injected
        death)."""
        if sys.is_finalizing():
            return False
        try:
            _faults().maybe_fail("mem_poll")
            stats = self._stats_fn()
        except SystemExit:
            return False            # injected death: exit silently
        except Exception:
            self._reg.counter("device.mem_poll_errors").inc()
            return True
        self._reg.counter("device.mem_polls").inc()
        if not stats:
            return True
        in_use = stats.get("bytes_in_use")
        limit = stats.get("bytes_limit")
        if in_use is not None:
            self._reg.gauge("device.mem_bytes_in_use").set(in_use)
        if limit:
            self._reg.gauge("device.mem_bytes_limit").set(limit)
            if in_use is not None:
                self._reg.gauge("device.mem_frac_used").set(
                    in_use / limit)
        peak = stats.get("peak_bytes_in_use")
        if peak is not None:
            self._reg.gauge("device.mem_peak_bytes_in_use").set(peak)
        return True

    def _loop(self) -> None:
        while True:
            if not self.poll_once():
                return
            if self._stop.wait(self._interval):
                return

    def close(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:   # never-started: no join
            self._thread.join(timeout=2.0)   # a hung poller is
            #                                  abandoned (daemon)
        atexit.unregister(self.close)
