"""TT601 — wall-clock reads and span emission inside device programs.

A `time.time()` / `time.monotonic()` / `time.perf_counter()` call (or a
span tracer's `span()` / `record()` — obs/spans.py) inside a device
program times the ENQUEUE, not the device: eager torch returns from
each launch as soon as it is queued, so a clock read between two
launches measures how fast the host queues kernels, and a span around
them closes long before the card has run them — telemetry that looks
alive and is wrong. (Under a torch transform or a CUDA-graph capture
the read runs once, at capture, and never again.) The tt-obs design
rule is that device time belongs to CUDA events and the profiler
(obs/prof.py, obs/cost.py), and host timing to the dispatch loop's
fence brackets (runtime/engine.py, serve/scheduler.py), which read the
clock after the fence that retires the work.

The rule reuses TT101's device-program collection (rules_trace.py):
every function of ops/, the functions handed to `dcore.program`, and
those handed to torch's transforms, nested defs and lambdas included.
"""

from __future__ import annotations

import ast
import re

from timetabling_ga_tpu_torch.analysis.core import Finding, qual_matches, qualname
from timetabling_ga_tpu_torch.analysis.rules_trace import outermost_targets

RULE = "TT601"

# dotted clock callees (tail-matched, so `time.monotonic` also catches
# an aliased `t.monotonic` import form) plus the bare from-imports.
# `time` alone is deliberately absent: a bare `time()` cannot be told
# from a local named `time`, and the dotted form covers real usage.
_CLOCK_CALLEES = {
    "time.time", "time.time_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.process_time", "time.process_time_ns",
    "time.thread_time", "time.thread_time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "monotonic", "monotonic_ns", "perf_counter", "perf_counter_ns",
    "process_time", "process_time_ns",
}

# span-tracer entry points: `<receiver>.span(...)` / `.record(...)`
# where the receiver is tracer-shaped (`tracer`, `self.tracer`,
# `self._tracer`, `NULL_TRACER`, a SpanTracer(...) literal)
_SPAN_METHODS = {"span", "record"}
_TRACER_RECV = re.compile(r"(^|\.)_?(tracer|null_tracer|span_tracer)$",
                          re.IGNORECASE)


def _is_span_call(call: ast.Call) -> bool:
    fn = call.func
    if not (isinstance(fn, ast.Attribute) and fn.attr in _SPAN_METHODS):
        return False
    recv = fn.value
    if isinstance(recv, ast.Call):          # SpanTracer(...).span(...)
        return qual_matches(qualname(recv.func),
                            {"SpanTracer", "spans.SpanTracer"})
    qn = qualname(recv)
    return qn is not None and bool(_TRACER_RECV.search(qn))


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    findings: list[Finding] = []
    for fn in outermost_targets(tree, path, ctx):
        name = getattr(fn, "name", "<lambda>")
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            qn = qualname(node.func)
            if qual_matches(qn, _CLOCK_CALLEES):
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"wall-clock read `{qn}` inside device program "
                    f"`{name}` — it times the enqueue, not the device; "
                    f"device time belongs to CUDA events and the "
                    f"profiler (obs/prof.py), host time to the dispatch "
                    f"loop's fence brackets"))
            elif _is_span_call(node):
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"span tracer call "
                    f"`{qualname(node.func) or 'tracer.span'}` inside "
                    f"device program `{name}` — spans are host-side "
                    f"telemetry of the dispatch loop (obs/spans.py); a "
                    f"span around launches closes when they are queued, "
                    f"long before the card runs them"))
    return findings
