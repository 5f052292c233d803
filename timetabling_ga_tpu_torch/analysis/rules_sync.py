"""TT301/TT302 — hidden host syncs in dispatch loops, and collectives
outside the comm group.

TT301 — hidden host-device synchronization in dispatch loops. Inside
the host loops (`for`/`while` bodies) of the configured dispatch
modules (runtime/engine.py, parallel/islands.py,
runtime/dispatch_core.py, serve/scheduler.py, fleet/replicas.py), each
of these waits for every kernel queued on the card and serializes the
dispatch pipeline:

  - `.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `.to("cpu")`,
    `float()`/`int()`/`bool()`, `np.asarray()`/`np.array()` on a device
    value;
  - `torch.cuda.synchronize()` and an event's or stream's
    `.synchronize()`, whatever they wait on.

Every readback must go through the sanctioned helpers (`sync_helpers`:
dispatch_core fetch, fetch_leaf, fetch_state, fetch_final, HostCopy.wait,
_to_host), which batch the round trip, run under the fetch watchdog and
are exempt. Device values are seeded from the programs called by a bare
name in the same module (`program(...)(...)`, and `device_programs`:
`mesh_*(...)`), from `.cuda()` / `.to(<device>)`, and from `torch.*`
calls given a `device=`; methods and arithmetic keep them, and a
sanctioned helper's result is host memory. Programs built in another
module are TT303's (rules_interproc.py).

TT302 — a `torch.distributed` collective or point-to-point call in the
code that runs on an island mesh's shards (`sharded_modules`: ops/ and
parallel/) outside the comm module (`comm_modules`: parallel/comm.py).
comm.ProcessGroup carries every collective the port makes, each staged
and then entered behind the accord guard, so a dead or faulted peer is
classified on the host (PeerLost, AccordPeerFault) instead of hanging
inside the collective; a direct call skips both and, where the ranks'
loops diverge, waits forever at a rendezvous one rank never reaches.
"""

from __future__ import annotations

import ast
import re

from timetabling_ga_tpu_torch.analysis.core import (
    Finding, qual_matches, qualname, target_names)

RULE = "TT301"
RULE_COLLECTIVE = "TT302"

# torch.distributed's collectives and point-to-point calls
DIST_CALLS = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "broadcast", "broadcast_object_list", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "scatter", "scatter_object_list", "gather",
    "gather_object", "barrier", "monitored_barrier", "send", "recv",
    "isend", "irecv", "batch_isend_irecv",
}

_CONVERT_CALLS = {"float", "int", "bool"}
_NUMPY_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# torch constructors given a `device=` that make no tensor
_NON_TENSOR = {"Generator", "device", "Stream", "Event"}
# host-producing reads: their result is no device value
_HOST_METHODS = _SYNC_METHODS | {"size", "dim", "numel", "element_size",
                                 "stride", "data_ptr", "is_contiguous"}


def dist_aliases(tree: ast.Module) -> tuple[set[str], set[str]]:
    """(module aliases, bare names) bound to torch.distributed and its
    collectives in this module: `import torch.distributed as dist`,
    `from torch import distributed`, `from torch.distributed import
    all_reduce`; `torch.distributed.x` spells itself."""
    mods, bare = {"torch.distributed"}, set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        mods.add(a.asname or a.name)
            elif node.module == "torch.distributed":
                for a in node.names:
                    if a.name in DIST_CALLS:
                        bare.add(a.asname or a.name)
    return mods, bare


def dist_call(node: ast.Call, aliases) -> str | None:
    """The dotted name of a torch.distributed collective/p2p call, or
    None (binding-aware: a local named `dist` that is a tensor is not
    torch.distributed)."""
    mods, bare = aliases
    qn = qualname(node.func)
    if qn is None:
        return None
    if qn in bare:
        return qn
    head, _, tail = qn.rpartition(".")
    return qn if head in mods and tail in DIST_CALLS else None


def is_sync_call(node: ast.Call) -> bool:
    """`torch.cuda.synchronize(...)` or `<event|stream>.synchronize()`."""
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr == "synchronize")


def is_cpu_move(node: ast.Call) -> bool:
    """`x.to("cpu")` / `x.to(device="cpu")` / `x.to(torch.device("cpu"))`."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr == "to"):
        return False
    args = list(node.args[:1]) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and qual_matches(qualname(a.func),
                                                    {"torch.device"}):
            a = a.args[0] if a.args else None
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
    return False


def _to_device(node: ast.Call) -> bool:
    """`.cuda()`, or `.to(...)` to a device that is not the CPU (a dtype
    cast keeps the value where it was)."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr == "cuda":
        return True
    if f.attr != "to" or is_cpu_move(node):
        return False
    if any(kw.arg == "device" for kw in node.keywords):
        return True
    if not node.args:
        return False
    qn = qualname(node.args[0])
    return qn is None or not (qn.startswith("torch.")
                              or qn.endswith(".dtype"))


class _FuncChecker:
    def __init__(self, fn, path, ctx, findings):
        self.fn = fn
        self.path = path
        self.findings = findings
        self.sync_helpers = set(ctx.config.sync_helpers)
        self.producer_res = [re.compile(p)
                             for p in ctx.config.device_programs]
        self.factory_res = [re.compile(p)
                            for p in ctx.config.taint_sources]
        self.programs: set[str] = set()   # names of dispatch programs
        self.device: set[str] = set()     # names holding device values

    def _is_factory(self, call: ast.Call) -> bool:
        """`program("x", fn)`: its result is a dispatch program."""
        qn = qualname(call.func)
        return qn is not None and any(r.match(qn)
                                      for r in self.factory_res)

    def _is_producer(self, call: ast.Call) -> bool:
        """A call whose result is a device value: a program called by a
        bare name (`mesh_init(...)`), or a factory's product called
        (`program("x", fn)(args)`)."""
        if isinstance(call.func, ast.Call):
            return self._is_factory(call.func) \
                or self._is_producer(call.func)
        qn = qualname(call.func)
        return (qn is not None and not self._is_factory(call)
                and any(r.match(qn) for r in self.producer_res))

    def _is_sync_helper_call(self, call: ast.Call) -> bool:
        qn = qualname(call.func)
        return (qn is not None
                and qn.rsplit(".", 1)[-1] in self.sync_helpers)

    def value_kind(self, node: ast.AST) -> str:
        """'device' | 'host' for an expression."""
        if isinstance(node, ast.Name):
            return "device" if node.id in self.device else "host"
        if isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
            return self.value_kind(node.value)
        if isinstance(node, ast.Call):
            f = node.func
            if self._is_sync_helper_call(node) or is_cpu_move(node):
                return "host"
            if isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS:
                return "host"
            qn = qualname(f)
            if (self._is_producer(node) or _to_device(node)
                    or (qn is not None
                        and qn.rsplit(".", 1)[-1] in self.programs)
                    or (qn or "").startswith("torch.")
                    and qn.rsplit(".", 1)[-1] not in _NON_TENSOR
                    and any(kw.arg == "device" for kw in node.keywords)):
                return "device"
            if any(self.value_kind(a) == "device"
                   for a in list(node.args)
                   + [kw.value for kw in node.keywords]):
                return "device"
            if (isinstance(f, ast.Attribute)
                    and self.value_kind(f.value) == "device"):
                return "device"   # method call on a device value
            return "host"
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.value_kind(node.elt)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                if self.value_kind(child) == "device":
                    return "device"
        return "host"

    def _bind(self, target: ast.AST, kind_device: bool, program: bool):
        for name in target_names(target):
            if program:
                self.programs.add(name)
                self.device.discard(name)
            elif kind_device:
                self.device.add(name)
                self.programs.discard(name)
            else:
                self.device.discard(name)
                self.programs.discard(name)

    def _flag(self, node, what, on_device=True):
        where = "on a device value " if on_device else ""
        self.findings.append(Finding(
            RULE, self.path, node.lineno, node.col_offset,
            f"hidden host-device sync: {what} {where}inside a dispatch "
            f"loop — it waits for every queued kernel; batch the "
            f"readback through the sanctioned fetch helper instead"))

    def _check_expr_for_syncs(self, node: ast.AST, in_loop: bool):
        if not in_loop:
            return
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            qn = qualname(sub.func)
            if is_sync_call(sub):
                self._flag(sub, f"`{qn or '.synchronize'}()`", False)
            elif (isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _SYNC_METHODS
                    and self.value_kind(sub.func.value) == "device"):
                self._flag(sub, f"`.{sub.func.attr}()`")
            elif (is_cpu_move(sub)
                    and self.value_kind(sub.func.value) == "device"):
                self._flag(sub, "`.to(\"cpu\")`")
            elif (qn in _CONVERT_CALLS and sub.args
                    and self.value_kind(sub.args[0]) == "device"):
                self._flag(sub, f"`{qn}()`")
            elif (qual_matches(qn, _NUMPY_CALLS) and sub.args
                    and self.value_kind(sub.args[0]) == "device"):
                self._flag(sub, f"`{qn}()`")

    def run(self):
        self._stmts(self.fn.body, in_loop=False)

    def _stmts(self, stmts, in_loop):
        for st in stmts:
            self._stmt(st, in_loop)

    def _stmt(self, st, in_loop):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return
        if isinstance(st, ast.Assign):
            self._check_expr_for_syncs(st.value, in_loop)
            if isinstance(st.value, ast.Call) and self._is_factory(
                    st.value):
                for tgt in st.targets:
                    self._bind(tgt, False, program=True)
            else:
                kind = self.value_kind(st.value)
                for tgt in st.targets:
                    self._bind(tgt, kind == "device", program=False)
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            if st.value is not None:
                self._check_expr_for_syncs(st.value, in_loop)
        elif isinstance(st, (ast.Expr, ast.Return)):
            if st.value is not None:
                self._check_expr_for_syncs(st.value, in_loop)
        elif isinstance(st, (ast.If, ast.While)):
            self._check_expr_for_syncs(st.test, in_loop)
            inner = in_loop or isinstance(st, ast.While)
            self._stmts(st.body, inner)
            self._stmts(st.orelse, inner)
        elif isinstance(st, ast.For):
            self._check_expr_for_syncs(st.iter, in_loop)
            # iterating a device value gives device values
            self._bind(st.target, self.value_kind(st.iter) == "device",
                       program=False)
            self._stmts(st.body, True)
            self._stmts(st.orelse, in_loop)
        elif isinstance(st, ast.With):
            for item in st.items:
                self._check_expr_for_syncs(item.context_expr, in_loop)
            self._stmts(st.body, in_loop)
        elif isinstance(st, ast.Try):
            self._stmts(st.body, in_loop)
            for h in st.handlers:
                self._stmts(h.body, in_loop)
            self._stmts(st.orelse, in_loop)
            self._stmts(st.finalbody, in_loop)
        elif isinstance(st, (ast.Raise, ast.Assert)):
            pass


def _check_collectives(tree: ast.Module, path: str, ctx) -> list[Finding]:
    norm = path.replace("\\", "/")
    if not any(part in norm for part in ctx.config.sharded_modules):
        return []
    if any(norm.endswith(m) for m in ctx.config.comm_modules):
        return []
    aliases = dist_aliases(tree)
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = dist_call(node, aliases)
        if name is not None:
            findings.append(Finding(
                RULE_COLLECTIVE, path, node.lineno, node.col_offset,
                f"`{name}` in code that runs on an island mesh's shards, "
                f"outside the comm group (parallel/comm.py) — it skips "
                f"the staging and the accord guard, so a dead or faulted "
                f"peer hangs it at the rendezvous; call the collective "
                f"through comm.ProcessGroup"))
    return findings


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    findings: list[Finding] = []
    if "TT302" in ctx.config.rules:
        findings += _check_collectives(tree, path, ctx)
    norm = path.replace("\\", "/")
    if "TT301" in ctx.config.rules and any(
            norm.endswith(suffix)
            for suffix in ctx.config.dispatch_modules):
        sync_helpers = set(ctx.config.sync_helpers)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name in sync_helpers:
                    continue  # the sanctioned sync points themselves
                _FuncChecker(node, path, ctx, findings).run()
    return findings
