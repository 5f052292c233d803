"""TT303/TT304/TT305/TT306 — whole-program device taint, host-copy
fences and fence discipline (the interprocedural upgrade of
TT301/TT203).

The rules run over analysis/project.py's view of the scan set, so a
dispatch program built in one module (`dcore.program(name,
islands.mesh_*)`, runtime/dispatch_core.py) is tracked into the module
that calls it (runtime/engine.py, serve/scheduler.py). They cover ONLY
what the single-module rules cannot: taint and copies whose source
resolves ACROSS a module boundary.

TT303 — cross-module device taint reaching a host-forcing sink. Values
a dispatch program produced (the result of calling a program factory's
product, `dcore.program(...)(...)` or a name bound to one, or of a
function summarized device-returning, such as `islands.mesh_*`) are
device values through assignments, tuple unpacks, `for` targets and
calls. Inside a loop of a configured dispatch module, `float()`/
`int()`/`bool()`, `np.asarray`/`np.array`, `.item()`/`.tolist()`/
`.cpu()`/`.numpy()`/`.to("cpu")`, and control-flow tests on a device
value (a comparison, or an implicit bool()) each wait for every queued
kernel: exactly the syncs the sanctioned fetch helpers (`sync_helpers`;
calling one clears the taint) exist to batch.

TT304 — a non-blocking device->host copy read across modules before its
fence. `dcore.HostCopy(x)` / `dcore.host_copies(x)` (and functions
summarized as returning one) start a copy into pinned memory; its
destination (`.host`) is valid only after the copy's event: `.wait()`,
a sanctioned fetch of the copy, or a synchronize. A read of
`<copy>.host` (or `<copies>[i].host`) before then flags.

TT305 — fence discipline inside dispatch loops: a control host read
must precede the next dispatch, telemetry must not.
  (a) a sanctioned-fetch result that never steers control flow
      (telemetry) fetched BEFORE a later dispatch in the same loop
      iteration fences that dispatch for data nobody decides on — move
      it after the dispatch. A bare `fetch(x)` expression statement is
      exempt: an unbound fetch is a deliberate fence.
  (b) control flow steered through a synchronize
      (`torch.cuda.synchronize()`, an event's or stream's) — a
      whole-device wait followed, in the same iteration, by a control
      test on a device value, where the discipline wants the packed
      readback (`fetch`) that batches the round trip and feeds the
      watchdog.

TT306 — host fetch of device-RESIDENT group state outside a park
fence. serve/scheduler.py keeps a stacked group's population on the
card between quanta in `_resident` (`resident_stores`). Any value rooted
in that store reaching a host fetch (a `sync_helpers` call, or a sink
above) in a dispatch module flags, UNLESS the enclosing function is a
`fence_helpers` park-fence helper (`_flush_bucket`, `_flush_job`,
`flush_resident`): fetching resident state anywhere else moves the
bytes without the snapshot/ship units re-syncing. A rebind from a plain
call clears rootedness (`state, trace = runner(..., state, ...)` makes
`state` the quantum's OUTPUT).

Scope: function bodies named in `sync_helpers` are exempt (they ARE the
sanctioned sync points), as are `fence_helpers` bodies for TT306;
nested closures are not scanned.
"""

from __future__ import annotations

import ast

from timetabling_ga_tpu_torch.analysis.core import (
    Finding, qual_matches, qualname, target_names)
from timetabling_ga_tpu_torch.analysis.project import Project, project_of
from timetabling_ga_tpu_torch.analysis.rules_sync import (
    is_cpu_move, is_sync_call)

RULE_SYNC = "TT303"
RULE_COPY = "TT304"
RULE_FENCE = "TT305"
RULE_RESIDENT = "TT306"

_METHOD_SINKS = {"item", "tolist", "cpu", "numpy"}
# the attribute of a host copy holding its destination (HostCopy.host)
_COPY_ATTRS = {"host"}


def _sink_sets(config):
    """Partition the configured `taint_sinks` into bare conversion
    calls (`float`), dotted call names (`np.asarray`, tail-matched),
    and method sinks (`item`/`tolist`/`cpu`/`numpy`)."""
    converts, dotted, methods = set(), set(), set()
    for s in config.taint_sinks:
        if s in _METHOD_SINKS:
            methods.add(s)
        elif "." in s:
            dotted.add(s)
        else:
            converts.add(s)
    return converts, dotted, methods


def _is_dispatch_module(mod, config) -> bool:
    norm = mod.rel.replace("\\", "/")
    return any(norm.endswith(sfx) for sfx in config.dispatch_modules)


class _FuncFacts:
    """Cross-module bindings of one function body: dispatch programs,
    host copies, and sanctioned-fetch classification."""

    def __init__(self, proj: Project, fi):
        self.proj = proj
        self.fi = fi
        self.sync_helpers = set(proj.config.sync_helpers)
        # names bound to a dispatch program built by a factory resolved
        # in ANOTHER module, name -> factory qname
        self.cross_progs: dict[str, str] = {}
        # names bound to a host copy made in another module
        self.cross_copies: set[str] = set()
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Assign) \
                    or not isinstance(node.value, ast.Call):
                continue
            callee = self._cross_callee(node.value.func)
            is_factory = (callee is not None
                          and callee.qname in proj.program_factories)
            is_copy = (proj.is_copy_call(fi.module, node.value)
                       and self._cross(node.value.func))
            for tgt in node.targets:
                if not isinstance(tgt, ast.Name):
                    continue
                if is_factory:
                    self.cross_progs[tgt.id] = callee.qname
                if is_copy:
                    self.cross_copies.add(tgt.id)

    def _cross(self, func_expr) -> bool:
        mod, _ = self.proj.resolve_target(self.fi.module, func_expr)
        return mod is not None and mod.name != self.fi.module.name

    def _cross_callee(self, func_expr):
        callee = self.proj.resolve(self.fi.module, func_expr)
        if callee is None or not self.proj.is_cross_module(
                self.fi.module, callee):
            return None
        return callee

    def is_sanctioned(self, call: ast.Call) -> bool:
        qn = qualname(call.func)
        if qn is not None \
                and qn.rsplit(".", 1)[-1] in self.sync_helpers:
            return True
        callee = self.proj.resolve(self.fi.module, call.func)
        return callee is not None and callee.name in self.sync_helpers

    def device_call_origin(self, call: ast.Call) -> str | None:
        """Factory/function qname when `call` produces a device value
        whose producer lives in another module, else None."""
        f = call.func
        if isinstance(f, ast.Name) and f.id in self.cross_progs:
            return self.cross_progs[f.id]
        if isinstance(f, ast.Call):
            callee = self._cross_callee(f.func)
            if callee is not None \
                    and callee.qname in self.proj.program_factories:
                return callee.qname
            return None
        callee = self._cross_callee(f)
        if callee is not None \
                and callee.qname in self.proj.device_returning:
            return callee.qname
        return None


class _TaintChecker:
    """TT303: linear statement walk tracking cross-module device taint
    into host-forcing sinks inside loops."""

    def __init__(self, facts: _FuncFacts, path, findings):
        self.facts = facts
        self.path = path
        self.findings = findings
        self.device: dict[str, str] = {}   # tainted name -> origin
        self.ever: set[str] = set()        # every name ever tainted
        (self._converts, self._dotted,
         self._methods) = _sink_sets(facts.proj.config)

    def _flag(self, node, what, origin):
        self.findings.append(Finding(
            RULE_SYNC, self.path, node.lineno, node.col_offset,
            f"hidden host-device sync: {what} on a value produced by "
            f"`{origin}` (another module's dispatch program) inside a "
            f"dispatch loop — route the readback through a sanctioned "
            f"fetch helper"))

    def _origin(self, node: ast.AST) -> str | None:
        """Origin qname when the expression carries cross-module device
        taint, else None."""
        if isinstance(node, ast.Name):
            return self.device.get(node.id)
        if isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
            return self._origin(node.value)
        if isinstance(node, ast.Call):
            f = node.func
            qn = qualname(f)
            # a sanctioned fetch, and a sink's own result, are host
            # values (the sink itself is flagged where it is)
            if self.facts.is_sanctioned(node) or is_cpu_move(node) or (
                    isinstance(f, ast.Attribute)
                    and f.attr in self._methods) or (
                    qn in self._converts
                    or qual_matches(qn, self._dotted)):
                return None
            origin = self.facts.device_call_origin(node)
            if origin is not None:
                return origin
            if isinstance(f, ast.Attribute):
                o = self._origin(f.value)
                if o is not None:
                    return o
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                o = self._origin(a)
                if o is not None:
                    return o
            return None
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                o = self._origin(child)
                if o is not None:
                    return o
        return None

    def _check_sinks(self, node: ast.AST, in_loop: bool):
        if not in_loop:
            return
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            qn = qualname(sub.func)
            if (isinstance(sub.func, ast.Attribute)
                    and (sub.func.attr in self._methods
                         or is_cpu_move(sub))):
                o = self._origin(sub.func.value)
                if o is not None:
                    what = ('.to("cpu")' if sub.func.attr == "to"
                            else f".{sub.func.attr}()")
                    self._flag(sub, f"`{what}`", o)
            elif qn in self._converts and sub.args:
                o = self._origin(sub.args[0])
                if o is not None:
                    self._flag(sub, f"`{qn}()`", o)
            elif qual_matches(qn, self._dotted) and sub.args:
                o = self._origin(sub.args[0])
                if o is not None:
                    self._flag(sub, f"`{qn}()`", o)

    def _check_test(self, test: ast.AST, in_loop: bool):
        """Control-flow test on a tainted value: a comparison, or the
        value itself (an implicit bool())."""
        if not in_loop:
            return
        for sub in ast.walk(test):
            if isinstance(sub, ast.Compare):
                for opnd in [sub.left] + list(sub.comparators):
                    o = self._origin(opnd)
                    if o is not None:
                        self._flag(
                            sub, "control-flow-steering comparison", o)
                        return
        heads = [test]
        while heads:
            h = heads.pop()
            if isinstance(h, ast.BoolOp):
                heads.extend(h.values)
            elif isinstance(h, ast.UnaryOp) and isinstance(h.op, ast.Not):
                heads.append(h.operand)
            elif not isinstance(h, ast.Compare):
                o = self._origin(h)
                if o is not None:
                    self._flag(h, "implicit bool() in a control-flow test",
                               o)
                    return

    def _bind(self, targets, value, origin=None):
        origin = origin if value is None else self._origin(value)
        for tgt in targets:
            for name in target_names(tgt):
                if origin is not None:
                    self.device[name] = origin
                    self.ever.add(name)
                else:
                    self.device.pop(name, None)

    def run(self):
        self._stmts(self.facts.fi.node.body, in_loop=False)

    def _stmts(self, stmts, in_loop):
        for st in stmts:
            self._stmt(st, in_loop)

    def _stmt(self, st, in_loop):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return
        if isinstance(st, ast.Assign):
            self._check_sinks(st.value, in_loop)
            self._bind(st.targets, st.value)
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign, ast.Expr,
                             ast.Return)):
            if getattr(st, "value", None) is not None:
                self._check_sinks(st.value, in_loop)
        elif isinstance(st, (ast.If, ast.While)):
            self._check_test(st.test, in_loop)
            self._check_sinks(st.test, in_loop)
            inner = in_loop or isinstance(st, ast.While)
            self._stmts(st.body, inner)
            self._stmts(st.orelse, inner)
        elif isinstance(st, ast.For):
            self._check_sinks(st.iter, in_loop)
            self._bind([st.target], None, self._origin(st.iter))
            self._stmts(st.body, True)
            self._stmts(st.orelse, in_loop)
        elif isinstance(st, ast.With):
            self._stmts(st.body, in_loop)
        elif isinstance(st, ast.Try):
            self._stmts(st.body, in_loop)
            for h in st.handlers:
                self._stmts(h.body, in_loop)
            self._stmts(st.orelse, in_loop)
            self._stmts(st.finalbody, in_loop)


class _CopyChecker:
    """TT304: `<copy>.host` read before the copy's fence, for copies
    made by another module's HostCopy / host_copies."""

    def __init__(self, facts: _FuncFacts, path, findings):
        self.facts = facts
        self.path = path
        self.findings = findings
        self.pending: dict[str, int] = {}   # name -> copy lineno

    def _root(self, node) -> str | None:
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        return node.id if isinstance(node, ast.Name) else None

    def _visit(self, node: ast.AST):
        if not self.pending:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                f = sub.func
                if is_sync_call(sub):
                    self.pending.clear()
                    return
                if self.facts.is_sanctioned(sub):
                    names = [self._root(a) for a in sub.args]
                    if isinstance(f, ast.Attribute):
                        names.append(self._root(f.value))
                    for n in names:
                        self.pending.pop(n, None)
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Attribute) and sub.attr in _COPY_ATTRS
                    and isinstance(sub.ctx, ast.Load)):
                name = self._root(sub.value)
                if name in self.pending:
                    lineno = self.pending.pop(name)
                    self.findings.append(Finding(
                        RULE_COPY, self.path, sub.lineno, sub.col_offset,
                        f"`{qualname(sub) or sub.attr}` read before the "
                        f"non-blocking device->host copy made on line "
                        f"{lineno} (another module's HostCopy) is fenced"
                        f" — its bytes are valid only after the copy's "
                        f"event; call `.wait()` (or a sanctioned fetch) "
                        f"first"))

    def run(self):
        self._stmts(self.facts.fi.node.body)

    def _stmts(self, stmts):
        for st in stmts:
            self._stmt(st)

    def _stmt(self, st):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return
        if isinstance(st, ast.Assign):
            self._visit(st.value)
            for tgt in st.targets:
                for name in target_names(tgt):
                    self.pending.pop(name, None)
            if (isinstance(st.value, ast.Call)
                    and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Name)
                    and st.targets[0].id in self.facts.cross_copies
                    and self.facts.proj.is_copy_call(
                        self.facts.fi.module, st.value)):
                self.pending[st.targets[0].id] = st.lineno
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign, ast.Expr,
                             ast.Return, ast.Raise, ast.Assert)):
            val = getattr(st, "value", None) or getattr(st, "test", None)
            if val is not None:
                self._visit(val)
        elif isinstance(st, (ast.If, ast.While)):
            self._visit(st.test)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.For):
            self._visit(st.iter)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.With):
            for item in st.items:
                self._visit(item.context_expr)
            self._stmts(st.body)
        elif isinstance(st, ast.Try):
            self._stmts(st.body)
            for h in st.handlers:
                self._stmts(h.body)
            self._stmts(st.orelse)
            self._stmts(st.finalbody)


class _FenceChecker:
    """TT305: telemetry fetches that fence the next dispatch, and
    control flow steered through a synchronize."""

    def __init__(self, facts: _FuncFacts, path, findings, device_names):
        self.facts = facts
        self.path = path
        self.findings = findings
        self.device_names = device_names
        # every name read by a control-flow test anywhere in the scope
        self.control_names: set[str] = set()
        for node in ast.walk(facts.fi.node):
            if isinstance(node, (ast.If, ast.While)):
                self.control_names |= {
                    n.id for n in ast.walk(node.test)
                    if isinstance(n, ast.Name)}

    def run(self):
        for node in ast.walk(self.facts.fi.node):
            if isinstance(node, (ast.For, ast.While)):
                self._check_loop(node)

    def _flat(self, stmts):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            yield st
            for attr in ("body", "orelse", "finalbody"):
                yield from self._flat(getattr(st, attr, []) or [])
            for h in getattr(st, "handlers", []) or []:
                yield from self._flat(h.body)

    def _own(self, st):
        """The nodes of `st` itself, not of its nested statements."""
        todo = [st]
        while todo:
            node = todo.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, ast.stmt):
                    todo.append(child)

    def _is_dispatch(self, st) -> bool:
        return any(isinstance(sub, ast.Call)
                   and self.facts.device_call_origin(sub) is not None
                   for sub in self._own(st))

    def _fetch_binding(self, st):
        """(call, bound_names) when `st` assigns a sanctioned-fetch
        result; bare Expr fetches are deliberate fences (exempt)."""
        if not isinstance(st, ast.Assign) \
                or not isinstance(st.value, ast.Call):
            return None
        if not self.facts.is_sanctioned(st.value):
            return None
        names = {n for tgt in st.targets for n in target_names(tgt)}
        return (st.value, names) if names else None

    def _check_loop(self, loop):
        stmts = list(self._flat(loop.body))
        dispatch_at = [i for i, st in enumerate(stmts)
                       if self._is_dispatch(st)]
        if dispatch_at:
            last_dispatch = dispatch_at[-1]
            for st in stmts[:last_dispatch]:
                hit = self._fetch_binding(st)
                if hit is None:
                    continue
                call, names = hit
                if names & self.control_names:
                    continue   # control read before dispatch: the rule
                self.findings.append(Finding(
                    RULE_FENCE, self.path, call.lineno,
                    call.col_offset,
                    f"telemetry host read "
                    f"`{qualname(call.func)}(...)` fences the next "
                    f"dispatch — only control reads may precede a "
                    f"dispatch; move telemetry after it (or drop the "
                    f"binding to make the fence explicit)"))
        for i, st in enumerate(stmts):
            for sub in self._own(st):
                if not (isinstance(sub, ast.Call) and is_sync_call(sub)):
                    continue
                steered = any(
                    isinstance(later, (ast.If, ast.While))
                    and {n.id for n in ast.walk(later.test)
                         if isinstance(n, ast.Name)} & self.device_names
                    for later in stmts[i:])
                if steered:
                    self.findings.append(Finding(
                        RULE_FENCE, self.path, sub.lineno,
                        sub.col_offset,
                        "control flow steered through a synchronize — "
                        "a whole-device wait before a control test on a "
                        "device value; control fences must use the "
                        "sanctioned packed fetch helper"))


class _ResidentChecker:
    """TT306: a host fetch rooted in a device-resident group store,
    outside a park-fence helper. Store accesses and names assigned from
    them are rooted; a rebind from any plain call clears rootedness."""

    def __init__(self, facts: _FuncFacts, path, findings):
        self.facts = facts
        self.path = path
        self.findings = findings
        cfg = facts.proj.config
        self.stores = set(cfg.resident_stores)
        (self._converts, self._dotted,
         self._methods) = _sink_sets(cfg)
        self.rooted: set[str] = set()

    def _flag(self, node, what):
        self.findings.append(Finding(
            RULE_RESIDENT, self.path, node.lineno, node.col_offset,
            f"host fetch of device-resident group state ({what}) "
            f"outside a park-fence helper — resident population state "
            f"may only reach the host inside a `fence_helpers` flush "
            f"body, where the group's snapshot/ship units re-sync; "
            f"fetch the dispatch OUTPUT at the park fence, or move "
            f"this read into the flush path"))

    def _store_access(self, node: ast.AST) -> bool:
        return any(isinstance(sub, ast.Attribute)
                   and sub.attr in self.stores
                   for sub in ast.walk(node))

    def _rooted_expr(self, node: ast.AST) -> bool:
        if self._store_access(node):
            return True
        if isinstance(node, ast.Call):
            return False
        return any(isinstance(sub, ast.Name)
                   and isinstance(sub.ctx, ast.Load)
                   and sub.id in self.rooted
                   for sub in ast.walk(node))

    def _check_sinks(self, node: ast.AST):
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            qn = qualname(sub.func)
            args = list(sub.args) + [kw.value for kw in sub.keywords]
            if self.facts.is_sanctioned(sub):
                if any(self._rooted_expr(a) for a in args):
                    self._flag(sub, f"`{qn}(...)`")
            elif (isinstance(sub.func, ast.Attribute)
                    and (sub.func.attr in self._methods
                         or is_cpu_move(sub))):
                if self._rooted_expr(sub.func.value):
                    self._flag(sub, f"`.{sub.func.attr}()`")
            elif ((qn in self._converts
                   or qual_matches(qn, self._dotted)) and sub.args):
                if self._rooted_expr(sub.args[0]):
                    self._flag(sub, f"`{qn}(...)`")

    def _bind(self, targets, value):
        rooted = self._rooted_expr(value)
        for tgt in targets:
            for name in target_names(tgt):
                if rooted:
                    self.rooted.add(name)
                else:
                    self.rooted.discard(name)

    def run(self):
        self._stmts(self.facts.fi.node.body)

    def _stmts(self, stmts):
        for st in stmts:
            self._stmt(st)

    def _stmt(self, st):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return
        if isinstance(st, ast.Assign):
            self._check_sinks(st.value)
            self._bind(st.targets, st.value)
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign, ast.Expr,
                             ast.Return, ast.Raise, ast.Assert)):
            val = getattr(st, "value", None) or getattr(st, "test",
                                                        None)
            if val is not None:
                self._check_sinks(val)
        elif isinstance(st, (ast.If, ast.While)):
            self._check_sinks(st.test)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.For):
            self._check_sinks(st.iter)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.With):
            for item in st.items:
                self._check_sinks(item.context_expr)
            self._stmts(st.body)
        elif isinstance(st, ast.Try):
            self._stmts(st.body)
            for h in st.handlers:
                self._stmts(h.body)
            self._stmts(st.orelse)
            self._stmts(st.finalbody)


def _analyze_project(proj: Project, ctx) -> dict[str, list[Finding]]:
    out: dict[str, list[Finding]] = {}
    rules = ctx.config.rules
    sync_helpers = set(ctx.config.sync_helpers)
    fence_helpers = set(ctx.config.fence_helpers)
    for fi in proj.functions.values():
        if fi.name in sync_helpers:
            continue   # the sanctioned sync points themselves
        facts = _FuncFacts(proj, fi)
        findings = out.setdefault(fi.module.rel, [])
        if "TT304" in rules and facts.cross_copies:
            _CopyChecker(facts, fi.module.rel, findings).run()
        if not _is_dispatch_module(fi.module, ctx.config):
            continue
        taint = _TaintChecker(facts, fi.module.rel,
                              findings if "TT303" in rules else [])
        taint.run()
        if "TT305" in rules:
            _FenceChecker(facts, fi.module.rel, findings,
                          taint.ever).run()
        if "TT306" in rules and fi.name not in fence_helpers:
            _ResidentChecker(facts, fi.module.rel, findings).run()
    return out


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    cache = getattr(ctx, "interproc_findings", None)
    if cache is None:
        cache = _analyze_project(project_of(ctx, tree, src, path), ctx)
        ctx.interproc_findings = cache
    return list(cache.get(path, []))
