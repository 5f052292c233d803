"""TT608 — fleet actuation off the scaler thread.

The tt-scale contract (fleet/autoscaler.py): the autoscaler's control
loop is the ONLY legal actuation site for replica-count mutation.
Actuator calls — spawning workers (`spawn_one` / `spawn_local` /
`subprocess.Popen` / a handle's `respawn`), retiring them
(`preempt_replica` / `retire_replica` / `terminate`), adopting them
(`adopt_replica`), or grabbing ports (`free_port`) — are banned in two
places:

  - ON HTTP HANDLER PATHS (TT602's `_reachable` walk, including the
    configured `*Api` roots): a handler that spawns or preempts turns
    request traffic into process churn — any client (or scrape storm)
    could resize the fleet, bypassing the policy's sustained-window
    evidence, cooldown hysteresis, and warmth guard entirely. Handlers
    ENQUEUE; the decision belongs to the scaler.
  - INSIDE DISPATCHER-TICK BODIES (`scale-tick-pattern` function
    names — the gateway's `_dispatch_loop`/`_handle`/`_poll*`/
    `_tick*`/`_drain_tick` family): a spawn is seconds of process
    launch and a preempt is an HTTP round trip with policy
    consequences; on the ONE dispatcher thread either stalls routing,
    polling, and failover (the `dispatcher_stalled` watchdog's exact
    failure class) and actuates without the policy's guards. The
    dispatcher executes the preempt COMMAND the scaler enqueued
    (`handle.drain(mode=...)`) — it never originates scale decisions.

Scope: the configured fleet modules (`fleet-modules` in pyproject —
the gateway/replica/router layer, where both handler paths and the
dispatcher live). fleet/autoscaler.py itself is exempt — it IS the
sanctioned actuation site.
"""

from __future__ import annotations

import ast
import re

from timetabling_ga_tpu_torch.analysis.core import (
    Finding, qual_matches, qualname)
from timetabling_ga_tpu_torch.analysis.rules_http import _reachable

RULE = "TT608"

# attribute-call actuators: replica-count / process mutation verbs on
# any receiver (a gateway, a ReplicaSet, a handle)
_ACTUATOR_ATTRS = {"preempt_replica", "retire_replica",
                   "adopt_replica", "spawn_one", "spawn_local",
                   "respawn", "terminate"}

# qualified/bare-name actuators: process and port mutation
_ACTUATOR_CALLEES = {"subprocess.Popen", "Popen", "spawn_one",
                     "spawn_local", "free_port"}

_EXEMPT_SUFFIXES = ("fleet/autoscaler.py",)


def _in_scope(path: str, ctx) -> bool:
    rel = path.replace("\\", "/")
    modules = getattr(ctx.config, "fleet_modules", ["fleet/"])
    return any(m in rel for m in modules)


def _actuator(node: ast.Call) -> str | None:
    """The actuator callee's display name, or None."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _ACTUATOR_ATTRS:
        qn = qualname(f)
        return qn if qn is not None else f.attr
    qn = qualname(f)
    if qual_matches(qn, _ACTUATOR_CALLEES):
        return qn
    return None


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    norm = path.replace("\\", "/")
    if norm.endswith(_EXEMPT_SUFFIXES) or not _in_scope(path, ctx):
        return []
    findings: list[Finding] = []
    # half 1: handler-reachable paths (incl. the *Api roots) — an
    # actuator there lets request traffic resize the fleet
    suffixes = tuple(getattr(ctx.config, "handler_api_suffixes",
                             ("Api",)))
    for where, fn in _reachable(tree, suffixes):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _actuator(node)
            if name is not None:
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"fleet actuator call `{name}(...)` on the HTTP "
                    f"handler path `{where}` — spawning, preempting, "
                    f"or adopting replicas from a handler bypasses "
                    f"the autoscaler's evidence/cooldown/warmth "
                    f"policy and turns request traffic into process "
                    f"churn; handlers enqueue, the tt-scale scaler "
                    f"thread actuates (fleet/autoscaler.py, TT608)"))
    # half 2: dispatcher-tick bodies — the one dispatcher thread must
    # execute enqueued commands, never originate actuation
    tick_re = re.compile(getattr(
        ctx.config, "scale_tick_pattern",
        r"^_dispatch_loop$|^_handle$|^_poll|^_tick|^_drain_tick$"))
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
            continue
        if not tick_re.search(node.name):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name = _actuator(sub)
            if name is not None:
                findings.append(Finding(
                    RULE, path, sub.lineno, sub.col_offset,
                    f"fleet actuator call `{name}(...)` inside the "
                    f"dispatcher-tick body `{node.name}` — a spawn "
                    f"or preempt on the one dispatcher thread stalls "
                    f"routing/polling/failover and actuates without "
                    f"the policy's guards; the tt-scale scaler "
                    f"thread is the only legal actuation site "
                    f"(fleet/autoscaler.py, TT608)"))
    # a call can be both handler- and tick-reachable at one line;
    # dedupe by (line, col) like TT606/TT607
    seen: set = set()
    out = []
    for f in findings:
        k = (f.line, f.col)
        if k in seen:
            continue
        seen.add(k)
        out.append(f)
    return out
