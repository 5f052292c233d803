"""TT606 — incident-bundle serialization off the recorder thread.

The flight recorder's contract (obs/flight.py) has two sides:

  - DUMPS BELONG ON THE RECORDER THREAD. Bundle serialization and the
    file I/O around it (`json.dump`/`json.dumps` of bundle-sized
    payloads, `open`, `os.replace`/`os.rename`/`os.fsync`) are
    milliseconds-to-seconds of host work; inside a DEVICE PROGRAM they
    stand between launches on every call, and inside a DISPATCH LOOP
    they serialize the pipeline the loops exist to keep full — the
    exact stall class TT301/TT603 ban for readbacks and introspection. The tee feeding the rings is O(1) appends on
    the writer thread; everything heavier runs where a hang is
    harmless.
  - HANDLERS ONLY READ. `GET /metrics/history` and `GET /v1/incident`
    serve lock-guarded in-memory state (`HistoryRing.window()`,
    `FlightRecorder.latest()`); a handler that TRIGGERS or PERFORMS a
    dump (`recorder.trigger(...)`, `flight.dump(...)`, `json.dump` to
    a file) turns a scrape storm into a disk storm and couples the
    observer to the observed — the TT602 discipline, extended to the
    flight surface (audited with the same `_reachable` walk over
    handler classes and `*Api` roots).

Scope: half 1 scans device programs module-wide (TT601's collection)
plus For/While bodies in the configured dispatch modules (TT301's
scope); half 2 scans handler-reachable code everywhere. obs/flight.py
itself is exempt — it IS the sanctioned recorder-thread home.
"""

from __future__ import annotations

import ast
import re

from timetabling_ga_tpu_torch.analysis.core import Finding, qual_matches, qualname
from timetabling_ga_tpu_torch.analysis.rules_http import _reachable
from timetabling_ga_tpu_torch.analysis.rules_trace import outermost_targets

RULE = "TT606"

# serialization / file-I/O callees that mean "a bundle is being built
# or written here" (tail-matched like TT602's blocking list)
_SERIALIZE_CALLEES = {"json.dump", "json.dumps",
                      "os.replace", "os.rename", "os.fsync"}

# handler-path receivers that ARE the flight recorder (a handler may
# read `latest()`; it must never trigger or perform a dump)
_RECORDER_RECV = re.compile(r"(^|\.)_?(flight|recorder)$", re.IGNORECASE)
_RECORDER_MUTATORS = {"trigger", "dump", "dump_now", "note_record",
                      "poll_once", "close"}

# modules whose own bodies are the sanctioned recorder/sampler home
_EXEMPT_SUFFIXES = ("obs/flight.py", "obs/history.py")


def _is_serialize_call(node: ast.Call) -> bool:
    qn = qualname(node.func)
    if qual_matches(qn, _SERIALIZE_CALLEES):
        return True
    return isinstance(node.func, ast.Name) and node.func.id == "open"


def _flag_hot(findings, path, node, where: str) -> None:
    qn = qualname(node.func) or "open"
    findings.append(Finding(
        RULE, path, node.lineno, node.col_offset,
        f"bundle serialization / file I/O `{qn}(...)` {where} — dumps "
        f"belong on the flight recorder's own thread (obs/flight.py): "
        f"serializing or writing on the dispatch stream stalls the "
        f"pipeline exactly like the readbacks TT301/TT603 ban"))


class _LoopScanner:
    """Flag serialization calls inside For/While bodies of a host
    function — the dispatch-loop half, scoped to the configured
    dispatch modules (the TT603 scanner's shape)."""

    def __init__(self, path, findings):
        self.path = path
        self.findings = findings

    def scan(self, fn: ast.AST) -> None:
        self._stmts(getattr(fn, "body", []), in_loop=False)

    def _check(self, node: ast.AST, in_loop: bool) -> None:
        if not in_loop:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _is_serialize_call(sub):
                _flag_hot(self.findings, self.path, sub,
                          "inside a dispatch loop")

    def _stmts(self, stmts, in_loop: bool) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, (ast.For, ast.While)):
                if isinstance(st, ast.While):
                    self._check(st.test, in_loop)
                else:
                    self._check(st.iter, in_loop)
                self._stmts(st.body, True)
                self._stmts(st.orelse, True)
                continue
            for field in ("value", "test", "iter"):
                v = getattr(st, field, None)
                if isinstance(v, ast.expr):
                    self._check(v, in_loop)
            for item in getattr(st, "items", []) or []:
                # `with open(...) as fh:` — the context expression is
                # where the file I/O call sits
                self._check(item.context_expr, in_loop)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if isinstance(sub, list):
                    self._stmts(sub, in_loop)
            for h in getattr(st, "handlers", []) or []:
                self._stmts(h.body, in_loop)


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    norm = path.replace("\\", "/")
    if norm.endswith(_EXEMPT_SUFFIXES):
        return []
    findings: list[Finding] = []
    # half 1a: device programs, module-wide (rules_trace.py's set)
    for fn in outermost_targets(tree, path, ctx):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _is_serialize_call(node):
                _flag_hot(findings, path, node,
                          "inside a device program")
    # half 1b: dispatch loops, in the configured dispatch modules only
    if any(norm.endswith(suffix)
           for suffix in ctx.config.dispatch_modules):
        scanner = _LoopScanner(path, findings)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                scanner.scan(node)
    # half 2: handler paths (the TT602 reachability walk, including
    # the configured *Api roots) — a handler may only READ the flight
    # surface (`latest()`, `window()`), never trigger or perform a
    # dump, and never serialize a bundle to a file itself
    suffixes = tuple(getattr(ctx.config, "handler_api_suffixes",
                             ("Api",)))
    for where, fn in _reachable(tree, suffixes):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and f.attr in _RECORDER_MUTATORS
                    and (qn_recv := qualname(f.value)) is not None
                    and _RECORDER_RECV.search(qn_recv)):
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"flight-recorder mutation `{qn_recv}.{f.attr}"
                    f"(...)` on the HTTP handler path `{where}` — "
                    f"handlers serve `latest()`/`window()` from "
                    f"memory; triggering or performing dumps from a "
                    f"handler couples scrapes to disk writes "
                    f"(obs/flight.py design rules)"))
                continue
            if qual_matches(qualname(f), {"json.dump"}):
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"file serialization `json.dump(...)` on the HTTP "
                    f"handler path `{where}` — bundle writes belong "
                    f"on the recorder thread; handlers reply from the "
                    f"in-memory `latest()` copy (obs/flight.py)"))
    # a call can sit both in a loop and in a device program at one line;
    # dedupe by (line, col) like TT603
    seen: set = set()
    out = []
    for f in findings:
        k = (f.line, f.col)
        if k in seen:
            continue
        seen.add(k)
        out.append(f)
    return out
