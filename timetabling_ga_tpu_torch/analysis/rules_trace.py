"""TT101/TT102 — implicit host syncs in device programs.

TT101: a Python `if` / `while` / `assert` / `for` whose condition (or
iterable) is a tensor, inside a device program. On a tensor each is an
implicit `bool()` (or `__index__`/`__iter__`): the host waits for every
kernel queued before it, in the middle of a generation, and the
pipeline the dispatch loop keeps full drains. Inside a device program
the data-dependent forms are `torch.where`, masks and the kernels' own
branches; a host decision belongs at a control fence (dispatch_core
fetch).

TT102: `and` / `or` with a tensor operand in the same programs: the
short-circuit calls `bool()` on every operand but the last, the TT101
sync hidden in expression position. The element-wise forms are `&` /
`|` (torch.logical_and / logical_or).

Device programs: every function of the configured `program_modules`
(ops/), the functions handed to a program factory as its `fn` anywhere
in the scan set (the `dcore.program(name, islands.mesh_*)` programs,
analysis/project.py), and functions handed to torch's transforms
(`torch.compile`, `torch.jit.script`/`trace`, `vmap`, `torch.func.*`,
`torch.cuda.make_graphed_callables`), lambdas included.

Tensor values: parameters annotated `Tensor` (or a class of tensors,
such as ops/ga.py PopState); unannotated parameters the function itself
uses as tensors (a tensor method, a `shape`/`dtype`/`ndim` read, an
`x[..., None]` index, the first argument of `torch.gather`/`where`/...)
and in no other way (no other attribute, not a `range` bound, no literal
default), so `pa` and `cfg` stay host objects; fields annotated only as
tensors in the scanned classes (`pa.conflict`, `state.penalty`, on any
receiver); results of `torch.*` calls that make tensors, methods and
arithmetic on tensors, and names bound from them. Exempt, as host
values: `shape`/`ndim`/`dtype`/`device`/`is_cuda`, `numel()`/`dim()`/
`size()`/`stride()`, `len`, `isinstance`, `is`/`is not` comparisons,
iteration over a tuple or list display, and the explicit reads
`.item()`/`.tolist()`/`.cpu()`/`.numpy()`/`int()`/`float()`/`bool()`: a
sync the code asks for by name. TT301 audits those in the dispatch
modules' loops only; inside `ops/` no rule does.
"""

from __future__ import annotations

import ast

from timetabling_ga_tpu_torch.analysis.core import (
    Finding, qual_matches, qualname, target_names)
from timetabling_ga_tpu_torch.analysis.project import (
    param_evidence, project_of, torch_aliases)

RULE = "TT101"
RULE_BOOLOP = "TT102"

# callees whose function-valued arguments are traced, compiled or
# captured
_TRACING_CALLEES = {
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.vmap", "torch.func.vmap", "vmap", "func.vmap",
    "torch.func.grad", "torch.func.grad_and_value",
    "torch.func.jacrev", "torch.func.jacfwd", "torch.func.functional_call",
    "grad", "torch.cuda.make_graphed_callables",
}

# attribute reads that are host values on a tensor
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "is_leaf", "names", "itemsize",
                 "nbytes"}
# tensor methods returning host values: metadata, and the explicit reads
_HOST_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                 "stride", "storage_offset", "is_contiguous", "data_ptr",
                 "get_device", "is_floating_point", "is_complex",
                 "item", "tolist", "cpu", "numpy"}
# calls yielding host values whatever their arguments
_STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "callable",
                 "id", "int", "float", "bool", "str", "repr"}
# torch.<f> calls that make no tensor
_NON_TENSOR = {"device", "Generator", "Size", "dtype", "iinfo", "finfo",
               "is_tensor", "is_floating_point", "get_default_dtype",
               "set_default_dtype", "manual_seed", "no_grad",
               "inference_mode", "enable_grad", "set_grad_enabled",
               "compile", "promote_types", "result_type", "can_cast",
               "equal"}
# torch submodules whose calls make tensors (others: cuda, distributed,
# profiler, backends, autograd, utils, jit ... make none)
_TENSOR_SUBMODULES = {"nn", "linalg", "special", "fft", "sparse"}


def _is_tensor_annotation(ann, tensor_types=frozenset()) -> bool:
    """`ann` names a Tensor, or a class of tensors (Optional and unions
    included)."""
    names = {"Tensor"} | set(tensor_types)
    return ann is not None and any(
        (isinstance(n, ast.Name) and n.id in names)
        or (isinstance(n, ast.Attribute) and n.attr in names)
        for n in ast.walk(ann))


def _tracing_targets(tree: ast.Module):
    """Functions and lambdas handed to (or decorated by) a torch
    transform in this module."""
    defs_by_name: dict[str, list] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, []).append(node)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                inner = dec.func if isinstance(dec, ast.Call) else dec
                if qual_matches(qualname(inner), {"functools.partial",
                                                  "partial"}):
                    if (isinstance(dec, ast.Call) and dec.args
                            and qual_matches(qualname(dec.args[0]),
                                             _TRACING_CALLEES)):
                        yield node
                elif qual_matches(qualname(inner), _TRACING_CALLEES):
                    yield node
        elif (isinstance(node, ast.Call)
                and qual_matches(qualname(node.func), _TRACING_CALLEES)):
            cands = list(node.args) + [kw.value for kw in node.keywords]
            for arg in list(cands):
                if isinstance(arg, (ast.List, ast.Tuple)):
                    cands.extend(arg.elts)
            for arg in cands:
                if isinstance(arg, ast.Lambda):
                    yield arg
                elif isinstance(arg, ast.Name):
                    yield from defs_by_name.get(arg.id, [])


def _collect_targets(tree: ast.Module, path: str, ctx):
    """The device programs of this module (module docstring), each once,
    nested defs of a program included; computed once a run a file."""
    cache = ctx.__dict__.setdefault("targets", {})
    if path not in cache:
        cache[path] = _find_targets(tree, path, ctx)
    return cache[path]


def outermost_targets(tree: ast.Module, path: str, ctx):
    """The device programs not nested in another one: the roots a rule
    that walks a program's whole body visits once each."""
    targets = _collect_targets(tree, path, ctx)
    inner = {id(sub) for t in targets for sub in ast.walk(t)
             if sub is not t}
    return [t for t in targets if id(t) not in inner]


def _find_targets(tree: ast.Module, path: str, ctx):
    norm = path.replace("\\", "/")
    whole = any(m in norm for m in ctx.config.program_modules)
    proj = project_of(ctx, tree, None, path)
    handed = {fi.node for qn, fi in proj.functions.items()
              if qn in proj.program_targets and fi.module.tree is tree}
    targets: list = []
    seen: set[int] = set()

    def add(node):
        for sub in ast.walk(node):
            if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda))
                    and id(sub) not in seen):
                seen.add(id(sub))
                targets.append(sub)

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and (whole or node in handed):
            add(node)
    for node in _tracing_targets(tree):
        add(node)
    return targets


class _TaintChecker:
    def __init__(self, fn, path: str, findings: list[Finding],
                 torch_names: set[str], proj):
        self.path = path
        self.findings = findings
        self.fn = fn
        self.torch_names = torch_names
        self.tensor_types = proj.tensor_types
        self.tensor_fields = proj.tensor_fields
        a = fn.args
        self.tainted: set[str] = {
            p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            if _is_tensor_annotation(p.annotation, self.tensor_types)}
        inferred = proj.tensor_params.get(id(fn))
        if inferred is None:          # a nested def or a lambda
            _, inferred, neg = param_evidence(fn, torch_names)
            inferred = inferred - neg
        self.tainted |= inferred

    def _torch_call(self, qn: str | None):
        """True/False for a torch-rooted call that does/does not make a
        tensor; None when `qn` is not rooted at torch."""
        if qn is None:
            return None
        parts = qn.split(".")
        if parts[0] not in self.torch_names:
            return None
        if len(parts) == 2:
            return parts[1] not in _NON_TENSOR
        return len(parts) > 2 and parts[1] in _TENSOR_SUBMODULES

    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return (node.attr in self.tensor_fields
                    or self.is_tainted(node.value))
        if isinstance(node, ast.Call):
            qn = qualname(node.func)
            made = self._torch_call(qn)
            if made is not None:
                return made
            if qual_matches(qn, _STATIC_CALLS) and isinstance(
                    node.func, ast.Name):
                return False
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _HOST_METHODS:
                    return False
                if self.is_tainted(node.func.value):
                    return True
            return any(self.is_tainted(a)
                       for a in list(node.args)
                       + [kw.value for kw in node.keywords])
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
        if isinstance(node, ast.Lambda):
            return False
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.keyword)):
                if self.is_tainted(child):
                    return True
        return False

    def flag(self, node: ast.AST, what: str):
        name = getattr(self.fn, "name", "<lambda>")
        self.findings.append(Finding(
            RULE, self.path, node.lineno, node.col_offset,
            f"Python `{what}` on a tensor inside device program `{name}`"
            f" — an implicit bool() that waits for every queued kernel; "
            f"use torch.where / a mask, or decide at a control fence "
            f"(dispatch_core.fetch)"))

    def flag_boolop(self, node: ast.BoolOp):
        name = getattr(self.fn, "name", "<lambda>")
        op = "and" if isinstance(node.op, ast.And) else "or"
        self.findings.append(Finding(
            RULE_BOOLOP, self.path, node.lineno, node.col_offset,
            f"`{op}` short-circuit on a tensor inside device program "
            f"`{name}` — short-circuit calls bool() on the tensor (the "
            f"TT101 sync in expression position); use "
            f"`{'&' if op == 'and' else '|'}` (torch.logical_{op})"))

    def _boolops(self, node: ast.AST):
        """Flag the OUTERMOST tainted BoolOp under `node`. bool() runs
        on every operand but the last, so a tensor in final position
        is legal."""
        if node is None:
            return
        if isinstance(node, ast.BoolOp) and any(
                self.is_tainted(v) for v in node.values[:-1]):
            self.flag_boolop(node)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.keyword,
                                  ast.comprehension)):
                self._boolops(child)

    def run(self):
        body = (self.fn.body if isinstance(self.fn.body, list)
                else [ast.Expr(self.fn.body)])
        self._stmts(body)

    def _stmts(self, stmts):
        for st in stmts:
            self._stmt(st)

    def _stmt(self, st: ast.stmt):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # nested defs are targets of their own
        for field in ("value", "test", "iter"):
            self._boolops(getattr(st, field, None))
        if isinstance(st, ast.With):
            for item in st.items:
                self._boolops(item.context_expr)
        if isinstance(st, ast.Assign):
            t = self.is_tainted(st.value)
            for tgt in st.targets:
                for name in target_names(tgt):
                    (self.tainted.add if t
                     else self.tainted.discard)(name)
        elif isinstance(st, ast.AugAssign):
            if self.is_tainted(st.value) and isinstance(st.target, ast.Name):
                self.tainted.add(st.target.id)
        elif isinstance(st, ast.AnnAssign):
            if isinstance(st.target, ast.Name):
                t = (_is_tensor_annotation(st.annotation,
                                           self.tensor_types)
                     or (st.value is not None
                         and self.is_tainted(st.value)))
                (self.tainted.add if t
                 else self.tainted.discard)(st.target.id)
        elif isinstance(st, ast.If):
            if self.is_tainted(st.test):
                self.flag(st, "if")
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.While):
            if self.is_tainted(st.test):
                self.flag(st, "while")
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.Assert):
            if self.is_tainted(st.test):
                self.flag(st, "assert")
        elif isinstance(st, ast.For):
            if isinstance(st.iter, (ast.Tuple, ast.List)):
                # a Python container of values: no tensor is iterated
                if any(self.is_tainted(e) for e in st.iter.elts):
                    self.tainted.update(target_names(st.target))
            elif self.is_tainted(st.iter):
                self.flag(st, "for")
                for name in target_names(st.target):
                    self.tainted.add(name)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.With):
            self._stmts(st.body)
        elif isinstance(st, ast.Try):
            self._stmts(st.body)
            for h in st.handlers:
                self._stmts(h.body)
            self._stmts(st.orelse)
            self._stmts(st.finalbody)


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    findings: list[Finding] = []
    names = torch_aliases(tree)
    proj = project_of(ctx, tree, src, path)
    for fn in _collect_targets(tree, path, ctx):
        _TaintChecker(fn, path, findings, names, proj).run()
    return findings
