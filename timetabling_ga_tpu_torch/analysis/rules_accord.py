"""TT307 — collectives banned on the recovery/agreement path.

The tt-accord contract (runtime/control_channel.py): after a fault, a
torch.distributed collective is poisoned on at least one process (the
faulted or dead peer never enters it), so any code that decides WHAT
to do about the fault — the control side channel itself, and the
Supervisor's recovery policy — must stay on the host-side channel. A
`torch.distributed` collective or point-to-point call (`all_reduce`,
`all_gather`, `broadcast`, `barrier`, `send`/`recv`, ...), or one of
the comm group's collectives (parallel/comm.py ProcessGroup
`all_gather`, `all_reduce_min`, `exchange`, `broadcast`) on that path
recreates the hang the channel exists to prevent. The channel's own
TCPStore (`set`/`get`/`add`/`wait`/`compare_set`) is the channel and
stays allowed.

Two scopes:

  - ACCORD MODULES (`accord_modules`, path suffix match —
    runtime/control_channel.py): the whole file is the side channel.
  - `*Supervisor` CLASS BODIES in any analyzed file: the recovery
    policy surface (classify / agree_on_fault / snapshot / the ladder;
    runtime/dispatch_core.py Supervisor).

The run loop's healthy-path collectives (dispatch_core.fetch's
all_gather, entered behind the channel's guard) are out of scope: they
are the program, not the recovery decision about it.
"""

from __future__ import annotations

import ast

from timetabling_ga_tpu_torch.analysis.core import Finding, qualname
from timetabling_ga_tpu_torch.analysis.rules_sync import (
    dist_aliases, dist_call)

RULE = "TT307"

# the comm group's collectives (parallel/comm.py ProcessGroup), on any
# receiver
_GROUP_COLLECTIVES = {"all_gather", "all_reduce_min", "exchange",
                      "broadcast"}


def _accord_module(path: str, ctx) -> bool:
    rel = path.replace("\\", "/")
    return any(m in rel for m in ctx.config.accord_modules)


def _violation(node: ast.Call, aliases) -> str | None:
    """The banned callee's display name, or None."""
    name = dist_call(node, aliases)
    if name is not None:
        return name
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _GROUP_COLLECTIVES:
        return qualname(f) or f.attr
    return None


def _check_body(root: ast.AST, path: str, where: str, aliases,
                findings: list) -> None:
    for node in ast.walk(root):
        if not isinstance(node, ast.Call):
            continue
        name = _violation(node, aliases)
        if name is not None:
            findings.append(Finding(
                RULE, path, node.lineno, node.col_offset,
                f"collective `{name}(...)` on the recovery/agreement "
                f"path ({where}) — after a fault a collective is "
                f"poisoned on at least one process, so one here hangs "
                f"at the rendezvous the faulted peer never reaches; "
                f"recovery must ride the host-side control channel "
                f"(runtime/control_channel.py, TT307)"))


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    findings: list[Finding] = []
    aliases = dist_aliases(tree)
    if _accord_module(path, ctx):
        _check_body(tree, path, "accord module", aliases, findings)
        return findings
    for node in ast.walk(tree):
        if (isinstance(node, ast.ClassDef)
                and node.name.endswith("Supervisor")):
            _check_body(node, path,
                        f"`{node.name}` recovery policy", aliases,
                        findings)
    return findings
