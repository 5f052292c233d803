"""TT607 — usage-ledger mutation and wall-clock metering off its home
threads.

The tt-meter contract (obs/usage.py) mirrors the flight recorder's:

  - THE LEDGER IS FED FROM THE DRIVE LOOP AND FOLDED ON ITS OWN
    THREAD. A ledger mutation (`.job()` / `.dispatch()` / `.final()`
    / `.close()`) inside a DEVICE PROGRAM meters every program call
    instead of every retired quantum — the meter counts enqueues, not
    the fence-retired work it conserves — and on an HTTP HANDLER
    path it couples billing truth to scrape traffic: a poller that
    bumps the meter turns monitoring into revenue (the TT602
    registry-mutation hazard, with money attached). Handlers READ the
    ledger (`totals()`, a job's `usage` dict); only the scheduler's
    park fence feeds it.
  - METERING TIMESTAMPS BELONG TO THE DRIVE LOOP. A wall-clock read
    (`time.monotonic()` and friends) on a handler path means someone
    is measuring usage where requests land, not where work retires —
    numbers from the wrong clock domain that drift from the fence
    components the ledger conserves. (Clocks inside device programs
    are TT601's finding; this rule covers the handler half so the two
    compose without double-reporting.)

Scope: ledger mutations in device programs (TT101's collection)
module-wide AND on handler-reachable paths (TT602's `_reachable` walk,
including the configured `*Api` roots); wall-clock reads on the
handler paths only. obs/usage.py itself is exempt — it IS the
sanctioned ledger-thread home.
"""

from __future__ import annotations

import ast
import re

from timetabling_ga_tpu_torch.analysis.core import Finding, qualname, qual_matches
from timetabling_ga_tpu_torch.analysis.rules_http import _reachable
from timetabling_ga_tpu_torch.analysis.rules_obs import _CLOCK_CALLEES
from timetabling_ga_tpu_torch.analysis.rules_trace import outermost_targets

RULE = "TT607"

# receiver shapes that ARE the usage ledger: `usage`, `self._usage`,
# `svc.usage`, `ledger`, `usage_ledger`, ...
_LEDGER_RECV = re.compile(r"(^|\.)_?(usage|ledger|usage_ledger)$",
                          re.IGNORECASE)

# the ledger's mutating surface (obs/usage.py UsageLedger): reads —
# totals() / alive() — stay allowed everywhere
_LEDGER_MUTATORS = {"job", "dispatch", "final", "close", "drain",
                    "poll_once"}

# the sanctioned ledger home (and the metrics module its counters
# live in, already exempt from TT602's walk)
_EXEMPT_SUFFIXES = ("obs/usage.py",)


def _ledger_mutation(node: ast.Call):
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr in _LEDGER_MUTATORS):
        return None
    qn = qualname(f.value)
    if qn is not None and _LEDGER_RECV.search(qn):
        return qn
    return None


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    if path.replace("\\", "/").endswith(_EXEMPT_SUFFIXES):
        return []
    findings: list[Finding] = []
    # half 1: ledger mutations inside device programs, module-wide
    for fn in outermost_targets(tree, path, ctx):
        name = getattr(fn, "name", "<lambda>")
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            qn = _ledger_mutation(node)
            if qn is not None:
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"usage-ledger mutation `{qn}.{node.func.attr}"
                    f"(...)` inside device program `{name}` — it meters "
                    f"every program call, not the fence-retired work; "
                    f"metering feeds from the scheduler's park fence "
                    f"on the host (obs/usage.py design rules)"))
    # half 2: handler paths (TT602's reachability walk incl. *Api
    # roots) — no ledger mutation, no wall-clock metering
    suffixes = tuple(getattr(ctx.config, "handler_api_suffixes",
                             ("Api",)))
    for where, fn in _reachable(tree, suffixes):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            qn = _ledger_mutation(node)
            if qn is not None:
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"usage-ledger mutation `{qn}.{node.func.attr}"
                    f"(...)` on the HTTP handler path `{where}` — "
                    f"handlers READ the meter (totals(), a job's "
                    f"usage dict); a scrape that bumps it turns "
                    f"monitoring traffic into billed capacity "
                    f"(obs/usage.py design rules)"))
                continue
            if qual_matches(qualname(node.func), _CLOCK_CALLEES):
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"wall-clock read "
                    f"`{qualname(node.func)}` on the HTTP handler "
                    f"path `{where}` — metering timestamps belong to "
                    f"the drive loop's fence brackets; a handler-side "
                    f"clock meters where requests land, not where "
                    f"work retires (obs/usage.py design rules)"))
    # a call can be both device-program- and handler-reachable at one
    # line; dedupe by (line, col) like TT603/TT606
    seen: set = set()
    out = []
    for f in findings:
        k = (f.line, f.col)
        if k in seen:
            continue
        seen.add(k)
        out.append(f)
    return out
