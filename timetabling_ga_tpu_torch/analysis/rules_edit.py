"""TT309 — edit-solve work on the dispatch path or in device programs.

tt-edit (serve/editsolve.py) is ADMISSION-TIME machinery: edit-spec
parsing, base-problem loading, diff/apply, anchor attachment, and the
population transplant are host-side numpy (plus one batched
re-evaluation) that run once per submitted edit. Two placements are
banned:

  - inside the For/While loops of the configured dispatch modules
    (runtime/engine.py, parallel/islands.py, serve/scheduler.py, ...):
    a per-quantum diff or transplant re-derives admission-time state
    on every control fence — the drive loop's per-dispatch cost must
    stay O(lanes), never O(edit);
  - inside device programs anywhere (rules_trace.py's set: ops/, the
    functions handed to `dcore.program`, torch's transforms): editsolve
    is host numpy + JSON run once per edit; inside a program it runs
    per dispatch on the host between launches, and under a transform
    it fails or bakes a stale edit in; the edit seam belongs OUTSIDE
    the programs (the anchored objective already rides ProblemArrays
    as data).

Binding-aware: the rule recognizes `editsolve.f(...)` /
`timetabling_ga_tpu_torch.serve.editsolve.f(...)` via import aliases and names imported
with `from ...editsolve import f` — lazy function-level imports
included (the scheduler's own sanctioned use is a lazy import OUTSIDE
any loop).
"""

from __future__ import annotations

import ast

from timetabling_ga_tpu_torch.analysis.core import Finding, qualname
from timetabling_ga_tpu_torch.analysis.rules_trace import outermost_targets

RULE = "TT309"

_MODULE = "timetabling_ga_tpu_torch.serve.editsolve"


def _edit_bindings(tree: ast.Module):
    """(prefixes, names): dotted call prefixes bound to the editsolve
    module and bare callables imported from it, across the whole file
    (function-level lazy imports included)."""
    prefixes: set[str] = set()
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _MODULE or a.name.endswith(".editsolve"):
                    prefixes.add((a.asname or a.name) + ".")
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == _MODULE or mod.endswith(".editsolve"):
                for a in node.names:
                    names.add(a.asname or a.name)
            elif a_editsolve := [a for a in node.names
                                 if a.name == "editsolve"]:
                for a in a_editsolve:
                    prefixes.add((a.asname or a.name) + ".")
    return prefixes, names


def _is_edit_call(call: ast.Call, prefixes, names) -> bool:
    qn = qualname(call.func)
    if qn is None:
        return False
    if qn in names:
        return True
    return any(qn.startswith(p) for p in prefixes)


def _flag(findings, path, node, where):
    qn = qualname(node.func)
    findings.append(Finding(
        RULE, path, node.lineno, node.col_offset,
        f"`{qn}` (serve/editsolve.py) {where} — edit resolution and "
        f"population transplant are admission-time host work: hoist "
        f"to the submit/prepare seam (Scheduler.prepare_edit), "
        f"outside loops and device programs"))


def _walk_loops(stmts, in_loop, prefixes, names, findings, path):
    for st in stmts:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue          # nested defs get their own pass
        nested_loop = in_loop or isinstance(st, (ast.For, ast.While))
        if in_loop:
            for sub in ast.walk(st):
                if isinstance(sub, ast.Call) and _is_edit_call(
                        sub, prefixes, names):
                    _flag(findings, path, sub,
                          "inside a dispatch loop")
            continue          # everything below is already covered
        for field in ("body", "orelse", "finalbody"):
            inner = getattr(st, field, None)
            if inner:
                _walk_loops(inner, nested_loop, prefixes, names,
                            findings, path)
        if isinstance(st, ast.Try):
            for h in st.handlers:
                _walk_loops(h.body, nested_loop, prefixes, names,
                            findings, path)


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    if RULE not in ctx.config.rules:
        return []
    prefixes, names = _edit_bindings(tree)
    if not prefixes and not names:
        return []
    findings: list[Finding] = []
    # device programs: editsolve anywhere inside one
    seen: set = set()
    for fn in outermost_targets(tree, path, ctx):
        for sub in ast.walk(fn):
            if (isinstance(sub, ast.Call) and id(sub) not in seen
                    and _is_edit_call(sub, prefixes, names)):
                seen.add(id(sub))
                _flag(findings, path, sub, "inside a device program")
    # dispatch loops: only in the configured dispatch modules
    norm = path.replace("\\", "/")
    if any(norm.endswith(suffix)
           for suffix in ctx.config.dispatch_modules):
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                _walk_loops(node.body, False, prefixes, names,
                            findings, path)
    return findings
