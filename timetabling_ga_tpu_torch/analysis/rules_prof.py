"""TT310 — phase scopes outside the tt-prof registry, or on handler
paths.

tt-prof (obs/prof.py) attributes device time to phases by joining the
torch.profiler trace's `record_function` ranges back to the `tt.*`
scope names. That join is only as good as the scope discipline:

  - every phase scope must come from the ONE registry
    (`obs/prof.py` PHASES, read here by AST): a free-hand
    `torch.profiler.record_function("my_phase")` (or an
    `obs_prof.scope(...)` with an unregistered / non-literal name)
    silently lands in the profiler's `unattributed` bucket — or
    collides with a future registry name and mis-attributes someone
    else's kernels. Scope names are a shared namespace; the registry is
    where they are declared.
  - HTTP handler paths (the TT602-reachable set: `do_*` methods, their
    intra-module callees, `*Api` fronts) must not ENTER scopes at all:
    a `record_function` range opened on a scrape thread is profiler
    machinery on a handler (the pull front's contract is stdlib-only
    reads, obs/http.py design rules), and under a capture that records
    every thread it lands in the run's trace as a phase that never ran.

Binding-aware like TT309: recognizes `torch.profiler.record_function`
(and `record_function` imported from torch.profiler), `obs_prof.scope`
/ `prof.scope` via import aliases of the port's obs.prof, and bare
names imported with `from ...prof import scope` — decorator position
included (that is how the ops modules thread phases). obs/prof.py
itself is exempt: it is the registry's implementation and opens ranges
from validated variables.
"""

from __future__ import annotations

import ast

from timetabling_ga_tpu_torch.analysis.config import load_phases
from timetabling_ga_tpu_torch.analysis.core import Finding, qualname
from timetabling_ga_tpu_torch.analysis.rules_http import _reachable

RULE = "TT310"

_MODULE = "timetabling_ga_tpu_torch.obs.prof"
_RANGE_CALLS = ("torch.profiler.record_function", "profiler.record_function")

# the registry implementation itself (validates names at runtime)
_EXEMPT_SUFFIXES = ("obs/prof.py",)


def _prof_bindings(tree: ast.Module):
    """(prefixes, names): dotted call prefixes bound to the obs.prof
    module, and bare scope callables (its `scope`, torch.profiler's
    `record_function`), across the whole file (function-level lazy
    imports included)."""
    prefixes: set[str] = set()
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _MODULE or a.name.endswith(".prof"):
                    prefixes.add((a.asname or a.name) + ".")
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == _MODULE or mod.endswith(".prof"):
                for a in node.names:
                    if a.name == "scope":
                        names.add(a.asname or a.name)
            elif mod == "torch.profiler":
                for a in node.names:
                    if a.name == "record_function":
                        names.add(a.asname or a.name)
            else:
                for a in node.names:
                    if a.name == "prof":
                        prefixes.add((a.asname or a.name) + ".")
    return prefixes, names


def _scope_call(call: ast.Call, prefixes, names):
    """The phase-name argument node when `call` enters a phase scope
    (torch.profiler.record_function or a bound obs.prof scope()), None
    when it has none, else False."""
    qn = qualname(call.func)
    if qn is None:
        return False
    if qn in _RANGE_CALLS:
        return call.args[0] if call.args else None
    if qn in names:
        return call.args[0] if call.args else None
    if any(qn == p + "scope" for p in prefixes):
        return call.args[0] if call.args else None
    return False


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    if RULE not in ctx.config.rules:
        return []
    if path.replace("\\", "/").endswith(_EXEMPT_SUFFIXES):
        return []
    prefixes, names = _prof_bindings(tree)
    if "phases" not in ctx.__dict__:
        ctx.phases = load_phases(ctx.config)
    findings: list[Finding] = []

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        arg = _scope_call(node, prefixes, names)
        if arg is False:
            continue
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if arg.value not in ctx.phases:
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"phase scope {arg.value!r} is not in the tt-prof "
                    f"registry (obs/prof.py PHASES) — unregistered "
                    f"scopes land in the profiler's `unattributed` "
                    f"bucket or collide with future registry names; "
                    f"declare the phase in PHASES or reuse an "
                    f"existing one"))
        else:
            findings.append(Finding(
                RULE, path, node.lineno, node.col_offset,
                "phase scope name is not a string literal — the "
                "tt-prof attribution join is static (registry "
                "membership must be checkable at lint time); pass a "
                "literal from obs/prof.py PHASES"))

    # handler paths: entering ANY scope is profiler machinery on a
    # scrape thread (same reachable set as TT602)
    suffixes = tuple(getattr(ctx.config, "handler_api_suffixes",
                             ("Api",)))
    for where, fn in _reachable(tree, suffixes):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if _scope_call(node, prefixes, names) is False:
                continue
            findings.append(Finding(
                RULE, path, node.lineno, node.col_offset,
                f"phase scope entered on the HTTP handler path "
                f"`{where}` — a record_function range opened on a "
                f"scrape thread; handlers are stdlib-only readers "
                f"(obs/http.py design rules), and under a capture of "
                f"every thread the range lands in the run's trace as a "
                f"phase that never ran"))
    return findings
