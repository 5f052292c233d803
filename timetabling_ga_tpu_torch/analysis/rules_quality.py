"""TT604 — quality accounting must stay on device.

The search-quality observatory (obs/quality.py, README "Search-quality
observatory") ships diversity/operator/migration telemetry as packed
int32 columns on the telemetry leaf the dispatch loop ALREADY fetches:
one leaf, no extra device round trips, no host math beyond a numpy
decode. Two ways to silently lose that property:

  - HOST RECOMPUTE: calling a population-evaluation routine
    (`batch_penalty`, `evaluate`, `event_heat`, ...) inside a dispatch
    loop's body to derive quality numbers from the fetched population —
    a per-dispatch O(pop x E) host bill (and, on device arrays, a
    hidden sync) that the on-device reduction exists to avoid. Scoped
    to the configured dispatch modules' For/While bodies, like TT301 /
    TT603's loop halves.

  - NEW COLLECTIVES OR DRAWS: a quality-reduction helper (any function
    whose name matches the configured quality-path pattern, in the
    island-mesh modules) introducing a collective (a torch.distributed
    collective or point-to-point call, or a comm group's `all_gather`
    / `all_reduce_min` / `exchange` / `broadcast`) or a random draw
    (`randperm` / `multinomial` / `rand*` / `permutation` / `shuffle` /
    `choice`). Telemetry must ride existing exchanges: the
    migration-gain reduction reads the rows the ring ALREADY exchanges,
    and the Hamming sample uses a deterministic coprime stride precisely
    so no draw (which would move an island generator's stream, and with
    it the record stream) ever enters the telemetry path.

The sanctioned shape: reductions in parallel/islands.py (and the K14
kernels) pack the block on the card; runtime/engine.py and
serve/scheduler.py only slice and numpy-decode the fetched rows
(obs_quality.decode_rows).
"""

from __future__ import annotations

import ast
import re

from timetabling_ga_tpu_torch.analysis.core import Finding
from timetabling_ga_tpu_torch.analysis.rules_sync import (
    dist_aliases, dist_call)

RULE = "TT604"

# collectives (torch.distributed's, binding-aware, and the comm group's
# on any receiver) and random draws: none may be INTRODUCED by a
# quality-reduction helper
_GROUP_COLLECTIVES = {"all_gather", "all_reduce_min", "exchange",
                      "broadcast"}
_RANDOM_OPS = {"permutation", "shuffle", "choice", "randperm",
               "multinomial", "rand", "randn", "randint", "bernoulli",
               "normal"}


def _call_name(node: ast.Call) -> str | None:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


class _LoopScanner:
    """Flag quality-recompute callees inside any For/While body of a
    host function — structurally the TT603 loop half, with the callee
    set configured as `quality-recompute-callees`."""

    def __init__(self, path, callees, findings):
        self.path = path
        self.callees = set(callees)
        self.findings = findings

    def scan(self, fn: ast.AST) -> None:
        self._stmts(getattr(fn, "body", []), in_loop=False)

    def _check(self, node: ast.AST, in_loop: bool) -> None:
        if not in_loop:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _call_name(
                    sub) in self.callees:
                self.findings.append(Finding(
                    RULE, self.path, sub.lineno, sub.col_offset,
                    f"`{_call_name(sub)}(...)` inside a dispatch loop — "
                    f"host-side per-generation quality recompute; the "
                    f"on-device quality block already carries these "
                    f"numbers on the fetched leaf (obs/quality.py, "
                    f"README \"Search-quality observatory\")"))

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
    findings: list[Finding] = []
    cfg = ctx.config
    # half 1: dispatch-loop host recompute, configured modules only
    if any(norm.endswith(suffix) for suffix in cfg.dispatch_modules):
        scanner = _LoopScanner(path, cfg.quality_recompute_callees,
                               findings)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scanner.scan(node)
    # half 2: collectives / random draws introduced in quality-reduction
    # helpers of the island-mesh modules
    if any(frag in norm for frag in cfg.sharded_modules):
        qpat = re.compile(cfg.quality_path_pattern)
        aliases = dist_aliases(tree)
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if not qpat.search(node.name):
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                # both call forms: `dist.all_reduce(...)` AND a bare
                # `all_reduce(...)` after `from torch.distributed import
                # all_reduce` — same hazard, same flag
                name = _call_name(sub)
                if dist_call(sub, aliases) is not None or (
                        isinstance(sub.func, ast.Attribute)
                        and name in _GROUP_COLLECTIVES):
                    kind = "collective"
                elif name in _RANDOM_OPS:
                    kind = "random draw"
                else:
                    continue
                findings.append(Finding(
                    RULE, path, sub.lineno, sub.col_offset,
                    f"`{name}` is a {kind} inside quality-"
                    f"reduction helper `{node.name}` — quality "
                    f"telemetry must ride existing exchanges and "
                    f"deterministic strides, never add collectives "
                    f"or draws (parallel/islands.py div_stats / "
                    f"mesh_migrate return_gain are the sanctioned "
                    f"patterns)"))
    # a nested quality helper inside a scanned loop could double-report
    # one line; dedupe by (line, col) like TT603
    seen: set = set()
    out = []
    for f in findings:
        k = (f.line, f.col)
        if k in seen:
            continue
        seen.add(k)
        out.append(f)
    return out
