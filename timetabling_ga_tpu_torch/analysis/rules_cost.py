"""TT603 — memory/device introspection on hot paths.

`torch.cuda.memory_stats()` / `memory_allocated()` /
`max_memory_allocated()` / `memory_reserved()` / `mem_get_info()` /
`get_device_properties()` are host calls into the CUDA driver or the
caching allocator: `mem_get_info` is a driver round trip, the stats
walk the allocator under its lock, and each one on the dispatch path
stands between two launches the card could already be running. None
belongs there (`get_device_properties` reads a struct PyTorch keeps per
card after its first query; a site that needs it says so in its
suppression):

  - inside a DEVICE PROGRAM (rules_trace.py's set) it runs once per
    call, between launches, on every generation;
  - inside a DISPATCH LOOP (the configured dispatch modules' host
    loops, TT301's scope) it runs once per chunk or quantum, on the
    path the pipeline keeps full.

The sanctioned home is the cost observatory (obs/cost.py): its
MemPoller reads the allocator from its own daemon thread on the
metricsEntry cadence, and everything else reads the resulting registry
gauges.
"""

from __future__ import annotations

import ast

from timetabling_ga_tpu_torch.analysis.core import Finding
from timetabling_ga_tpu_torch.analysis.rules_trace import outermost_targets

RULE = "TT603"

_COST_METHODS = {"memory_stats", "memory_allocated", "max_memory_allocated",
                 "memory_reserved", "max_memory_reserved", "mem_get_info",
                 "get_device_properties", "memory_summary",
                 "memory_snapshot", "list_gpu_processes", "utilization"}

# modules whose own bodies ARE the sanctioned obs paths
_EXEMPT_SUFFIXES = ("obs/cost.py",)


def _cost_calls(fn: ast.AST):
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _COST_METHODS):
            yield node


def _flag(findings, path, node, where: str) -> None:
    findings.append(Finding(
        RULE, path, node.lineno, node.col_offset,
        f"`.{node.func.attr}()` {where} — device/allocator "
        f"introspection is a driver or allocator call between launches; "
        f"it belongs in the obs paths only: the cost observatory polls "
        f"memory from its own thread (obs/cost.py MemPoller)"))


class _LoopScanner:
    """Flag the cost methods inside any For/While body of a host
    function — the dispatch-loop half of the rule, scoped to the
    configured dispatch modules like TT301."""

    def __init__(self, path, findings):
        self.path = path
        self.findings = findings

    def scan(self, fn: ast.AST) -> None:
        self._stmts(getattr(fn, "body", []), in_loop=False)

    def _check(self, node: ast.AST, in_loop: bool) -> None:
        if not in_loop:
            return
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _COST_METHODS):
                _flag(self.findings, self.path, sub,
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
    # half 1: device programs, module-wide (TT601's collection)
    for fn in outermost_targets(tree, path, ctx):
        for node in _cost_calls(fn):
            _flag(findings, path, node, "inside a device program")
    # half 2: dispatch loops, in the configured dispatch modules only
    if any(norm.endswith(suffix)
           for suffix in ctx.config.dispatch_modules):
        scanner = _LoopScanner(path, findings)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scanner.scan(node)
    # a call both in a program and in a loop would double-report one line;
    # the analyzer's set-dedupe collapses identical findings, and the
    # two message variants differ, so dedupe here by (line, col)
    seen: set = set()
    out = []
    for f in findings:
        k = (f.line, f.col)
        if k in seen:
            continue
        seen.add(k)
        out.append(f)
    return out
