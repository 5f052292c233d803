"""TT203 — a non-blocking device->host copy read before its fence.

The port donates nothing (`--no-donate` is a no-op), so JAX's hazard of
a donated buffer read after its dispatch has no literal counterpart.
The torch hazard of the same kind is a host buffer that is not yet
valid: a `non_blocking=True` copy from the card into pinned host memory
(`dest.copy_(src, non_blocking=True)`, `t.to("cpu", non_blocking=True)`)
returns at once, and the destination holds its bytes only once the
stream has reached the copy — after the event recorded behind it is
`synchronize()`d (runtime/dispatch_core.py HostCopy.wait), or after a
`torch.cuda.synchronize()`. Reading it before then reads whatever the
pinned buffer held: no error, wrong numbers, and only when the card is
busy enough for the copy to be late.

The analysis is a linear per-function scan, like JAX's:

  - a destination becomes PENDING at a non-blocking copy into host
    memory: `.to(<cpu>, non_blocking=True)`, or `.copy_(...,
    non_blocking=True)` into a name or attribute chain bound in the
    same function from a pinned or CPU allocation (`pin_memory=True`,
    `.pin_memory()`, `device="cpu"`);
  - any `synchronize()` (an event's, a stream's, `torch.cuda`'s) or a
    `.wait()` makes every pending destination valid;
  - any load of a pending destination before then flags, once; a rebind
    clears it.

The cross-module form — a HostCopy made in one module and its `.host`
read in another before `wait()` — is TT304 (rules_interproc.py).
"""

from __future__ import annotations

import ast

from timetabling_ga_tpu_torch.analysis.core import (
    Finding, qualname, target_names)

RULE = "TT203"

_SYNC_METHODS = {"synchronize", "wait"}


def _is_cpu(expr) -> bool:
    if isinstance(expr, ast.Constant):
        return expr.value == "cpu"
    if isinstance(expr, ast.Call) and (qualname(expr.func) or "").endswith(
            "device"):
        return bool(expr.args) and _is_cpu(expr.args[0])
    return False


def _kw(call: ast.Call, name: str):
    return next((kw.value for kw in call.keywords if kw.arg == name), None)


def _non_blocking(call: ast.Call) -> bool:
    v = _kw(call, "non_blocking")
    return isinstance(v, ast.Constant) and v.value is True


def _is_host_alloc(expr: ast.AST) -> bool:
    """An expression making host (pinned or CPU) memory."""
    for sub in ast.walk(expr):
        if not isinstance(sub, ast.Call):
            continue
        if isinstance(sub.func, ast.Attribute) \
                and sub.func.attr == "pin_memory":
            return True
        pin = _kw(sub, "pin_memory")
        if isinstance(pin, ast.Constant) and pin.value is True:
            return True
        dev = _kw(sub, "device")
        if dev is not None and _is_cpu(dev):
            return True
    return False


def _d2h_to(call: ast.AST) -> bool:
    """`x.to(<cpu>, non_blocking=True)`."""
    return (isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr == "to" and _non_blocking(call)
            and ((call.args and _is_cpu(call.args[0]))
                 or _is_cpu(_kw(call, "device"))))


class _Scan:
    """Linear statement walk of one scope: destinations turn pending at
    their copy, valid at a fence, and flag on a read in between."""

    def __init__(self, fn, path, findings):
        self.fn = fn
        self.path = path
        self.findings = findings
        self.host: set[str] = set()      # chains bound to host memory
        self.pending: dict[str, int] = {}   # chain -> copy lineno

    def _flag(self, node, chain):
        self.findings.append(Finding(
            RULE, self.path, node.lineno, node.col_offset,
            f"`{chain}` is the destination of a non-blocking "
            f"device->host copy on line {self.pending.pop(chain)} and "
            f"is read before any synchronize()/wait() — its bytes are "
            f"valid only once the stream reaches the copy; wait on the "
            f"copy's event first (dispatch_core.HostCopy.wait)"))

    def _check_reads(self, node: ast.AST):
        if not self.pending:
            return
        receivers = {id(sub.func.value) for sub in ast.walk(node)
                     if isinstance(sub, ast.Call)
                     and isinstance(sub.func, ast.Attribute)
                     and sub.func.attr == "copy_"}
        for sub in ast.walk(node):
            if id(sub) in receivers or not isinstance(
                    getattr(sub, "ctx", None), ast.Load):
                continue
            chain = qualname(sub)
            if chain in self.pending:
                self._flag(sub, chain)

    def _handle_calls(self, node: ast.AST):
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            qn = qualname(f) or ""
            if ((isinstance(f, ast.Attribute)
                    and f.attr in _SYNC_METHODS)
                    or qn.endswith("cuda.synchronize")):
                self.pending.clear()
            elif (isinstance(f, ast.Attribute) and f.attr == "copy_"
                    and _non_blocking(sub)):
                chain = qualname(f.value)
                if chain in self.host:
                    self.pending[chain] = sub.lineno

    def _bind(self, targets, value):
        pend = _d2h_to(value)
        host = pend or _is_host_alloc(value)
        for tgt in targets:
            chains = ([qualname(tgt)] if isinstance(tgt, ast.Attribute)
                      else list(target_names(tgt)))
            for chain in chains:
                if chain is None:
                    continue
                self.pending.pop(chain, None)
                (self.host.add if host else self.host.discard)(chain)
                if pend:
                    self.pending[chain] = value.lineno

    def _expr(self, node):
        self._check_reads(node)
        self._handle_calls(node)

    def _stmt(self, st):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # nested scopes are scanned separately
        if isinstance(st, ast.Assign):
            self._expr(st.value)
            self._bind(st.targets, st.value)
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign, ast.Expr,
                             ast.Return, ast.Raise, ast.Assert)):
            val = getattr(st, "value", None) or getattr(st, "test", None)
            if val is not None:
                self._expr(val)
            if isinstance(st, ast.AnnAssign) and st.value is not None:
                self._bind([st.target], st.value)
        elif isinstance(st, (ast.If, ast.While)):
            self._expr(st.test)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.For):
            self._expr(st.iter)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.With):
            for item in st.items:
                self._expr(item.context_expr)
            self._stmts(st.body)
        elif isinstance(st, ast.Try):
            self._stmts(st.body)
            for h in st.handlers:
                self._stmts(h.body)
            self._stmts(st.orelse)
            self._stmts(st.finalbody)

    def _stmts(self, stmts):
        for st in stmts:
            self._stmt(st)

    def run(self):
        self._stmts(self.fn.body if isinstance(self.fn.body, list) else [])


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    findings: list[Finding] = []
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
    for scope in scopes:
        _Scan(scope, path, findings).run()
    return findings
