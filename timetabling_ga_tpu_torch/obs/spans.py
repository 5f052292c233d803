"""Nestable host-side timing spans (copy of timetabling_ga_tpu/obs/
spans.py, under the same names).

A span is one bracketed interval of HOST time: a dispatch from its start
on the card to its fence, a control fetch, a checkpoint, a serve
quantum. Spans ride the run's `jsonl.AsyncWriter` as `spanEntry`
records, so emitting one costs a bounded-queue enqueue on the dispatch
path and the serialization happens on the writer thread. The `trace`
subcommand exports them as Chrome trace-event JSON (obs/trace_export.py).

Two emission shapes:

  with tracer.span("checkpoint", cat="engine", gens=n):   # bracketed
      ...
  tracer.record("dispatch", t0, dur, cat="device", ...)   # measured
                                                          # elsewhere

`record` exists because the engine's dispatch bracket is measured by the
pipeline's own clocks (the enqueue and fence times that also feed the
budget predictor); `t0` is a raw `time.monotonic()` value. No span adds
a device synchronization: the clocks are read at the fences the
pipeline already has.

Flow ids: `new_flow()` allocates a process-unique id; spans of one
causal chain carry it as `flow=` (an int, or a list when one span
serves several chains, a packed serve quantum advancing many jobs).
Flows cross threads: the engine's dispatch (main thread), the fetch
watchdog's read (`tt-fetch-watchdog`) and the writer's checkpoint write
(`tt-jsonl-writer`) render as connected arrows, and every span of a
serve job's life shares the job's flow, so `trace --job ID` shows one
timeline. Ids at or above XFLOW_BASE are cross-process chains (minted by
a fleet gateway) and are kept verbatim when several logs are stitched.

Clock: `time.monotonic()` offsets from the tracer's construction epoch.
A disabled tracer (the default) is a no-op: `span()` yields at once and
`record` returns. Nesting depth is tracked per thread.

Stdlib only: the trace exporter imports this module without torch.
"""

from __future__ import annotations

import contextlib
import threading
import time

# flow ids at/above this value are CROSS-PROCESS chains (module
# docstring): allocated only by the one process that owns the chain's
# root (the fleet gateway), shipped over the wire, and kept verbatim
# when `tt trace` stitches multiple logs. Local (per-process) flows
# stay far below it.
XFLOW_BASE = 1 << 32


class SpanTracer:
    """Emits spanEntry records onto a (writer-wrapped) stream.

    `out` is anything the jsonl emitters accept — normally the run's
    AsyncWriter, so span serialization rides the telemetry thread.
    `enabled=False` (or out=None) makes every call a no-op."""

    def __init__(self, out=None, enabled: bool = True,
                 clock=time.monotonic, flow_base: int = 0):
        self.enabled = bool(enabled) and out is not None
        self._out = out
        self._clock = clock
        self._epoch = clock()
        self._local = threading.local()
        self._tids: dict[int, int] = {}
        self._tid_lock = threading.Lock()
        # flow ids are flow_base + n: 0 for ordinary per-process
        # tracers, XFLOW_BASE for the one tracer whose chains cross
        # process boundaries (the fleet gateway's)
        self._flow_base = int(flow_base)
        self._next_flow = 0

    # -- flows ----------------------------------------------------------

    def new_flow(self) -> int:
        """Allocate a flow id for one causal chain (a dispatch's
        enqueue→fetch→process life, a serve job's admit→...→finalize).
        Spans of the chain carry it as `flow=<id>` (or `flow=[ids]` when
        one span advances several chains); `tt trace` turns shared ids
        into Perfetto flow arrows across thread lanes. Returns 0 when
        the tracer is disabled — callers thread the id through
        unconditionally and the no-op spans discard it."""
        if not self.enabled:
            return 0
        with self._tid_lock:
            self._next_flow += 1
            return self._flow_base + self._next_flow

    # -- clocks ---------------------------------------------------------

    def now(self) -> float:
        """Seconds since the tracer epoch (the spanEntry `ts` domain)."""
        return self._clock() - self._epoch

    def _tid(self) -> int:
        """Small stable per-thread id (0 = first thread seen, normally
        the main loop) — the Chrome trace `tid` lane."""
        ident = threading.get_ident()
        t = self._tids.get(ident)
        if t is None:
            with self._tid_lock:
                t = self._tids.setdefault(ident, len(self._tids))
        return t

    def _depth_stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # -- emission -------------------------------------------------------

    def _emit(self, name: str, cat: str, ts: float, dur: float,
              depth: int, **attrs) -> None:
        # local import: obs must stay importable without the runtime
        # package half-initialized (jsonl imports faults only — cheap)
        from timetabling_ga_tpu_torch.runtime import jsonl
        jsonl.span_entry(self._out, name, cat, ts, dur, depth,
                         self._tid(), **attrs)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "engine", **attrs):
        """Bracketed span; nests (depth = enclosing spans on this
        thread). Exceptions propagate after the span is emitted with
        `error=True`, so a failed phase is visible in the timeline."""
        if not self.enabled:
            yield self
            return
        stack = self._depth_stack()
        depth = len(stack)
        stack.append(name)
        t0 = self._clock()
        try:
            yield self
        except BaseException:
            attrs = dict(attrs, error=True)
            raise
        finally:
            stack.pop()
            t1 = self._clock()
            try:
                self._emit(name, cat, t0 - self._epoch, t1 - t0, depth,
                           **attrs)
            except Exception:
                # a dying writer must not mask the body's own outcome;
                # its error re-raises at the next direct write anyway
                pass

    def record(self, name: str, start_monotonic: float, dur: float,
               cat: str = "engine", **attrs) -> None:
        """Emit a span measured by the caller's own monotonic clocks
        (`start_monotonic` = a raw time.monotonic() reading)."""
        if not self.enabled:
            return
        self._emit(name, cat, start_monotonic - self._epoch,
                   max(0.0, dur), len(self._depth_stack()), **attrs)


# Shared disabled tracer: callers that may or may not have obs wired
# (e.g. _polish_chunks' default argument) use this instead of None-
# checking at every site.
NULL_TRACER = SpanTracer(out=None, enabled=False)
