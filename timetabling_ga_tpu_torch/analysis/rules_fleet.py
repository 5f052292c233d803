"""TT605 — fleet handler discipline: no device work, bounded reads.

The fleet front's one contract (fleet/gateway.py docstring): HTTP
handlers ENQUEUE and READ ONLY. The drive loop owns every device call;
the dispatcher thread owns every piece of outbound I/O. Two ways a
handler silently breaks that:

  - DEVICE WORK INLINE: any `torch.cuda.*` call, a `.synchronize()`,
    moving tensors (`.cuda()`, `.to(<device>)`), launching a kernel
    (`kernels.launch`), copying to or from the card (`HostCopy`,
    `host_copies`, `place_state`, `reshard_state`, `fetch_state`,
    `fetch_final`, `device_arrays`), or touching the solve path's
    dispatch-loop callees (`step`, `drive`, `submit`, `prepare`) from a
    handler thread. A handler that does device work serializes tenant
    requests behind the card AND races the drive loop's control fences
    (the drive loop is the only thread that touches the card,
    dispatch_core.CommandFence) — the exact coupling the inbox exists
    to prevent.
  - UNBOUNDED SOCKET READS: `self.rfile.read()` with no size parks the
    handler thread until the CLIENT closes the connection (HTTP/1.1
    keep-alive: possibly never) — a tenant-controlled hang. Bodies
    must be read with an explicit Content-Length-derived bound
    (ApiHandler._body is the sanctioned shape).

Scope: handler-reachable code (the TT602 reachability walk — handler
classes' methods plus intra-module `self.x()` / bare-name callees) in
the configured fleet modules (`fleet-modules` in pyproject, default
the fleet/ package).
"""

from __future__ import annotations

import ast

from timetabling_ga_tpu_torch.analysis.core import Finding, qual_matches, qualname
from timetabling_ga_tpu_torch.analysis.rules_http import _reachable

RULE = "TT605"

# callee tails that mean "device work" when reached from a handler:
# the port's kernel launch and host<->card copies plus the solve path's
# dispatch-loop entries (torch.cuda.*, .synchronize(), .cuda() and
# .to(<device>) are matched by shape, _device_call)
_DEVICE_CALLEES = {
    "kernels.launch", "HostCopy", "host_copies", "place_state",
    "device_arrays", "reshard_state", "fetch_state", "fetch_final",
    # scheduler/service dispatch entries: a handler may enqueue a
    # command FOR these, never call them
    "scheduler.step", "scheduler.drive", "svc.step", "svc.drive",
    "svc.submit", "scheduler.prepare",
}


def _in_scope(path: str, ctx) -> bool:
    rel = path.replace("\\", "/")
    modules = getattr(ctx.config, "fleet_modules", ["fleet/"])
    return any(m in rel for m in modules)


def _device_call(node: ast.Call) -> str | None:
    """The display name of a call that does device work, or None."""
    qn = qualname(node.func)
    if qual_matches(qn, _DEVICE_CALLEES) or (qn or "").startswith(
            "torch.cuda."):
        return qn
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in ("synchronize", "cuda"):
            return qn or f".{f.attr}"
        if f.attr == "to":
            arg = (node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "device"),
                None))
            aq = qualname(arg) if arg is not None else None
            if arg is not None and not (aq is not None and (
                    aq.startswith("torch.") or aq.endswith(".dtype"))):
                return qn or ".to"
    return None


def _is_unbounded_rfile_read(node: ast.Call) -> str | None:
    """`<...>.rfile.read()` (or a bare `rfile.read()`) with no size
    argument — the read that blocks until the peer hangs up."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr == "read"):
        return None
    if node.args or node.keywords:
        return None
    recv = qualname(f.value)
    if recv is not None and recv.split(".")[-1] == "rfile":
        return recv
    return None


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    if not _in_scope(path, ctx):
        return []
    # same roots as TT602: handler classes PLUS the *Api surfaces the
    # handlers call into (handler-api-suffixes in pyproject)
    suffixes = tuple(getattr(ctx.config, "handler_api_suffixes",
                             ("Api",)))
    findings: list[Finding] = []
    for where, fn in _reachable(tree, suffixes):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            qn = _device_call(node)
            if qn is not None:
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"device/dispatch call `{qn}` on the fleet "
                    f"handler path `{where}` — handlers enqueue and "
                    f"read only; device work belongs to the drive "
                    f"loop, the only thread on the card; outbound I/O "
                    f"to the dispatcher thread "
                    f"(fleet/gateway.py handler discipline)"))
                continue
            recv = _is_unbounded_rfile_read(node)
            if recv is not None:
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"unbounded socket read `{recv}.read()` on the "
                    f"fleet handler path `{where}` — a body read with "
                    f"no Content-Length bound parks this handler "
                    f"thread until the CLIENT closes the connection; "
                    f"read exactly the declared length "
                    f"(fleet/gateway.py ApiHandler._body)"))
    return findings
