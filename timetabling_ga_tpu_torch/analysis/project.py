"""The whole-program layer under TT303/TT304/TT305/TT306 (and the device
program set TT101's family reads): module graph, per-function summaries
and cross-module call resolution, the counterpart of
timetabling_ga_tpu/analysis/project.py.

The port dispatches through `dcore.program(name, fn)`
(runtime/dispatch_core.py): the program proxy is built in one module,
its `fn` (a `parallel/islands.py` mesh_* program) lives in another, and
it is called in a third (runtime/engine.py, serve/scheduler.py). This
module gives the rules what they need to follow that:

  Project        all scanned files loaded as one unit. Modules get
                 dotted names rooted at their outermost package (the
                 nearest ancestor directory without an __init__.py),
                 so resolution works alike for the shipped package and
                 for test fixture packages.
  import maps    per-module alias -> dotted target, from `import a.b`,
                 `import a.b as c`, `from a.b import c [as d]`, and
                 explicit-relative forms. Star imports are ignored.
  resolve()      a call expression's dotted name, resolved through the
                 calling module's alias map to a FunctionInfo in
                 another scanned module; tail matching as in
                 core.qual_matches.
  summaries      fixpoint-computed per-function facts:
                 `program_factories` (returns a dispatch program: the
                 `program` proxy), `device_returning` (returns a value
                 a dispatch program produced: the mesh_* programs
                 themselves, and any function returning a program's
                 output or another device-returning call), and
                 `copy_returning` (returns a non-blocking device->host
                 copy: HostCopy, host_copies, and passthroughs).
  program_targets  the functions handed to a program factory as its
                 `fn` anywhere in the scan set: the device programs.
  tensor_types   names of the classes whose every annotated field is a
                 Tensor or another such class (ops/ga.py PopState,
                 BreedDraws, ...): a parameter annotated with one holds
                 tensors.
  tensor_fields  field names annotated as a Tensor (or a class of
                 tensors) in some class and as nothing else in any
                 (problem.py ProblemArrays `conflict`, PopState
                 `penalty`): `x.<field>` holds a tensor whatever `x` is.
  tensor_params  for each function (by id of its node), the
                 unannotated parameters it uses as tensors and in no
                 other way: a tensor method, a `shape`/`dtype`/`ndim`
                 read, an `x[..., None]` index, the first argument of
                 `torch.gather`/`where`/..., or passed on as an argument
                 that the callee takes as a tensor (to a fixpoint, so
                 `compute_scv(pa, slots)` knows `slots` from
                 `attendance_matrix`). Another attribute read, a `range`
                 bound or a literal default keeps a parameter a host
                 value (`pa`, `cfg`, `n`).

Stdlib-only, like every analysis module.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from timetabling_ga_tpu_torch.analysis.core import qualname


@dataclasses.dataclass
class ModuleInfo:
    name: str                     # dotted, rooted at outermost package
    path: str
    rel: str                      # path relative to config root
    tree: ast.Module
    src: str
    imports: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FunctionInfo:
    qname: str                    # "pkg.mod.func" / "pkg.mod.Cls.func"
    name: str                     # bare function name
    module: ModuleInfo
    node: ast.AST
    cls: str | None = None


def _module_name(path: str) -> str:
    """Dotted module name rooted at the outermost enclosing package."""
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.exists(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    name = ".".join(reversed(parts))
    return name[:-len(".__init__")] if name.endswith(".__init__") else name


def _import_map(tree: ast.Module, modname: str) -> dict[str, str]:
    """Local alias -> dotted target for one module's import statements."""
    pkg = modname.rsplit(".", 1)[0] if "." in modname else ""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    out[alias.asname] = alias.name
                else:
                    # `import a.b.c` binds `a`; attribute chains off it
                    # spell the full dotted path themselves
                    out[alias.name.split(".")[0]] = \
                        alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = pkg.split(".") if pkg else []
                up = up[:len(up) - (node.level - 1)] if node.level > 1 \
                    else up
                base = ".".join(x for x in [".".join(up), base] if x)
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                out[local] = f"{base}.{alias.name}" if base \
                    else alias.name
    return out


class Project:
    """All scanned sources as one unit; built once per analyzer run."""

    def __init__(self, sources, config):
        # sources: iterable of (path, rel, tree, src) for parsed files
        self.config = config
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        for path, rel, tree, src in sources:
            name = _module_name(path)
            mod = ModuleInfo(name, path, rel, tree, src)
            mod.imports = _import_map(tree, name)
            self.modules[name] = mod
        for mod in self.modules.values():
            self._index_functions(mod)
        self._factory_res = [re.compile(p) for p in config.taint_sources]
        self._program_res = [re.compile(p)
                             for p in config.device_programs]
        self._copy_names = set(config.copy_factories)
        self.program_factories: set[str] = set()
        self.device_returning: set[str] = set()
        self.copy_returning: set[str] = set()
        self._summarize()
        self.program_targets: set[str] = self._program_targets()
        self.tensor_types: set[str] = _tensor_types_of(
            self.modules.values())
        self.tensor_fields: set[str] = _tensor_fields_of(
            self.modules.values(), self.tensor_types)
        self.tensor_params: dict[int, set[str]] = self._tensor_params()

    # -- loading --------------------------------------------------------

    def _index_functions(self, mod: ModuleInfo) -> None:
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{mod.name}.{node.name}"
                self.functions[qn] = FunctionInfo(qn, node.name, mod,
                                                  node)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        qn = f"{mod.name}.{node.name}.{sub.name}"
                        self.functions[qn] = FunctionInfo(
                            qn, sub.name, mod, sub, cls=node.name)

    # -- resolution -----------------------------------------------------

    def _module_by_tail(self, dotted: str) -> ModuleInfo | None:
        if dotted in self.modules:
            return self.modules[dotted]
        best = None
        for name, mod in self.modules.items():
            if name.endswith("." + dotted):
                if best is None or len(name) < len(best.name):
                    best = mod
        return best

    def resolve_target(self, caller_mod: ModuleInfo, expr: ast.AST):
        """(module, name) a dotted expression names in another scanned
        module or this one: a function, a class or any module-level
        binding; (None, None) for anything else."""
        qn = qualname(expr)
        if qn is None:
            return None, None
        parts = qn.split(".")
        if len(parts) == 1:
            if (f"{caller_mod.name}.{parts[0]}" in self.functions
                    or any(isinstance(n, ast.ClassDef)
                           and n.name == parts[0]
                           for n in caller_mod.tree.body)):
                return caller_mod, parts[0]
            target = caller_mod.imports.get(parts[0])
            if target is None:
                return None, None
            parts = target.split(".")
        else:
            target = caller_mod.imports.get(parts[0])
            if target is not None:
                parts = target.split(".") + parts[1:]
        if len(parts) < 2:
            return None, None
        mod = self._module_by_tail(".".join(parts[:-1]))
        if mod is None:
            return None, None
        return mod, parts[-1]

    def resolve(self, caller_mod: ModuleInfo, func_expr: ast.AST
                ) -> FunctionInfo | None:
        """The FunctionInfo a call expression resolves to, through the
        calling module's import aliases; None when the callee is not a
        scanned module-level function (method calls, builtins, foreign
        libraries)."""
        mod, name = self.resolve_target(caller_mod, func_expr)
        if mod is None:
            return None
        return self.functions.get(f"{mod.name}.{name}")

    def is_cross_module(self, caller_mod: ModuleInfo,
                        callee: FunctionInfo) -> bool:
        return callee.module.name != caller_mod.name

    def is_copy_call(self, caller_mod: ModuleInfo, call: ast.Call) -> bool:
        """`call` makes a non-blocking device->host copy: a configured
        copy factory (class or function) of a scanned module, or a
        function summarized copy-returning."""
        mod, name = self.resolve_target(caller_mod, call.func)
        if mod is None:
            return False
        return (name in self._copy_names
                or f"{mod.name}.{name}" in self.copy_returning)

    def is_factory_call(self, caller_mod: ModuleInfo, call: ast.AST
                        ) -> bool:
        """`call` is a call of a program factory (its result a
        dispatch program)."""
        if not isinstance(call, ast.Call):
            return False
        callee = self.resolve(caller_mod, call.func)
        return callee is not None and callee.qname in self.program_factories

    # -- summaries ------------------------------------------------------

    def _return_exprs(self, fn: ast.AST):
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                yield node.value

    def _summarize(self) -> None:
        # seeds: the program factory (the cost proxy `program`), the
        # device programs (mesh_*) and the copy factories
        for qn, fi in self.functions.items():
            if fi.cls is None and any(r.match(fi.name)
                                      for r in self._factory_res):
                self.program_factories.add(qn)
            if fi.cls is None and any(r.match(fi.name)
                                      for r in self._program_res):
                self.device_returning.add(qn)
            if fi.cls is None and fi.name in self._copy_names:
                self.copy_returning.add(qn)
        # fixpoint: returning another factory's product / a device
        # value / a copy propagates the fact
        for _ in range(len(self.modules) + 2):
            changed = False
            for qn, fi in self.functions.items():
                for ret in self._return_exprs(fi.node):
                    changed |= self._propagate(qn, fi, ret)
            if not changed:
                break

    def _propagate(self, qn: str, fi: FunctionInfo, ret: ast.AST
                   ) -> bool:
        changed = False
        head = ret.elts[0] if (isinstance(ret, ast.Tuple) and ret.elts) \
            else ret
        if not isinstance(head, ast.Call):
            return False
        callee = self.resolve(fi.module, head.func)
        if callee is not None:
            for facts in (self.program_factories, self.device_returning,
                          self.copy_returning):
                if callee.qname in facts and qn not in facts:
                    facts.add(qn)
                    changed = True
        elif (self.is_copy_call(fi.module, head)
                and qn not in self.copy_returning):
            self.copy_returning.add(qn)
            changed = True
        # device value: return <program>(...) where <program> was bound
        # from a factory call inside this function, or is one
        if qn not in self.device_returning:
            inner = head.func
            if ((isinstance(inner, ast.Name)
                    and inner.id in self._program_bindings(fi))
                    or self.is_factory_call(fi.module, inner)):
                self.device_returning.add(qn)
                changed = True
        return changed

    def _program_bindings(self, fi: FunctionInfo) -> set[str]:
        """Names bound inside `fi` to a dispatch program (a factory
        call's result)."""
        names: set[str] = set()
        for node in ast.walk(fi.node):
            if (isinstance(node, ast.Assign)
                    and self.is_factory_call(fi.module, node.value)):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        names.add(tgt.id)
        return names

    def _tensor_params(self) -> dict[int, set[str]]:
        """id(function node) -> its tensor parameters (module doc)."""
        aliases = {name: torch_aliases(mod.tree)
                   for name, mod in self.modules.items()}
        kinds = {"Tensor"} | self.tensor_types
        facts = {}
        for qn, fi in self.functions.items():
            a = fi.node.args
            annotated = {
                p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                if p.annotation is not None and any(
                    getattr(n, "id", getattr(n, "attr", None)) in kinds
                    for n in ast.walk(p.annotation))}
            cands, pos, neg = param_evidence(fi.node,
                                             aliases[fi.module.name])
            facts[qn] = ([p.arg for p in a.posonlyargs + a.args],
                         cands - neg, pos - neg | annotated)
        # (caller, callee, callee's parameter, caller's parameter passed)
        passes = []
        for qn, fi in self.functions.items():
            open_ = facts[qn][1]
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                callee = self.resolve(fi.module, node.func)
                if callee is None or callee.qname not in facts:
                    continue
                # positions are known only up to a `*args`
                shown = node.args[:next(
                    (i for i, a in enumerate(node.args)
                     if isinstance(a, ast.Starred)), len(node.args))]
                pairs = list(zip(facts[callee.qname][0], shown)) + [
                    (kw.arg, kw.value) for kw in node.keywords]
                passes += [(qn, callee.qname, cp, arg.id)
                           for cp, arg in pairs
                           if isinstance(arg, ast.Name) and arg.id in open_]
        changed = True
        while changed:
            changed = False
            for qn, callee, cp, arg in passes:
                known = facts[qn][2]
                if cp in facts[callee][2] and arg not in known:
                    known.add(arg)
                    changed = True
        return {id(fi.node): facts[qn][2]
                for qn, fi in self.functions.items()}

    def _program_targets(self) -> set[str]:
        """qnames of the functions handed to a program factory as its
        `fn` (the second positional argument, or `fn=`), anywhere."""
        out: set[str] = set()
        for mod in self.modules.values():
            for node in ast.walk(mod.tree):
                if not self.is_factory_call(mod, node):
                    continue
                args = list(node.args[1:2]) + [
                    kw.value for kw in node.keywords if kw.arg == "fn"]
                for a in args:
                    fi = self.resolve(mod, a)
                    if fi is not None:
                        out.add(fi.qname)
        return out


# attribute reads that show an unannotated parameter is a tensor
_TENSOR_ATTRS = {"shape", "dtype", "ndim", "is_cuda", "T", "mT"}
# tensor methods: a call of one on an unannotated parameter shows it
# is a tensor
_TENSOR_METHODS = {
    "any", "all", "sum", "prod", "mean", "amax", "amin", "max", "min",
    "argmax", "argmin", "argsort", "topk", "cumsum", "cumprod",
    "view", "view_as", "reshape", "reshape_as", "expand", "expand_as",
    "unsqueeze", "squeeze", "flatten", "permute", "transpose", "narrow",
    "contiguous", "clone", "detach", "to", "long", "int", "float",
    "bool", "short", "half", "double", "byte", "gather", "scatter",
    "scatter_", "scatter_add", "scatter_add_", "index_select",
    "index_put_", "index_add_", "index_copy_", "masked_fill",
    "masked_fill_", "masked_select", "where", "clamp", "clamp_",
    "clamp_min", "clamp_max", "eq", "ne", "lt", "le", "gt", "ge",
    "nonzero", "count_nonzero", "repeat", "repeat_interleave", "roll",
    "flip", "fill_", "zero_", "copy_", "add_", "sub_", "mul_", "div_",
    "new_zeros", "new_ones", "new_full", "new_empty", "new_tensor",
    "abs", "neg", "bitwise_and", "bitwise_or", "bitwise_xor",
    "logical_and", "logical_or", "logical_not", "unbind", "chunk",
    "tile", "diagonal", "tril", "triu", "cpu", "cuda", "item",
    "tolist", "numpy", "numel", "dim", "size", "stride", "unique",
}
# attributes a tensor has: reading one is no evidence against a tensor
_TENSOR_FIELDS = _TENSOR_ATTRS | {"device", "layout", "requires_grad",
                                  "is_leaf", "names", "itemsize",
                                  "nbytes", "data", "grad", "real",
                                  "imag"}
# torch.<f> whose first argument is a tensor
_TENSOR_FIRST_ARG = {
    "gather", "scatter", "scatter_add", "index_select", "where",
    "masked_fill", "take_along_dim", "sort", "argsort", "topk",
    "cumsum", "sum", "any", "all", "amax", "amin", "clamp",
    "clamp_min", "clamp_max", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "logical_and", "logical_or",
    "logical_not", "searchsorted", "bucketize", "unique", "nonzero",
    "count_nonzero", "flip", "roll", "minimum", "maximum", "eq", "ne",
    "lt", "le", "gt", "ge", "argmax", "argmin", "zeros_like",
    "ones_like", "full_like", "empty_like", "abs", "unbind",
}


def torch_aliases(tree: ast.Module) -> set[str]:
    """Names the module binds to the `torch` package itself."""
    return {alias.asname or "torch" for node in ast.walk(tree)
            if isinstance(node, ast.Import) for alias in node.names
            if alias.name == "torch"}


def param_evidence(fn, torch_names: set[str]):
    """(candidates, for, against) of `fn`'s own body: the unannotated
    parameters with no literal default, those it uses as tensors, and
    those it uses as host values (another attribute, a `range` bound)."""
    a = fn.args
    positional = a.posonlyargs + a.args
    defaults = {p.arg: d for p, d in zip(positional[::-1],
                                         a.defaults[::-1])}
    defaults.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults)
                     if d is not None})
    cands = {p.arg for p in positional + a.kwonlyargs
             if p.annotation is None and p.arg not in ("self", "cls")
             and not (isinstance(defaults.get(p.arg), ast.Constant)
                      and defaults[p.arg].value is not None)}
    pos: set[str] = set()
    neg: set[str] = set()

    def param(node):
        return isinstance(node, ast.Name) and node.id in cands

    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and param(node.value):
            if node.attr in _TENSOR_ATTRS:
                pos.add(node.value.id)
            elif (node.attr not in _TENSOR_FIELDS
                  and node.attr not in _TENSOR_METHODS):
                neg.add(node.value.id)
        elif isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and param(f.value)
                    and f.attr in _TENSOR_METHODS):
                pos.add(f.value.id)
            qn = qualname(f)
            if qn == "range":
                neg.update(x.id for x in node.args if param(x))
            elif qn and node.args and param(node.args[0]):
                parts = qn.split(".")
                if (len(parts) == 2 and parts[0] in torch_names
                        and parts[1] in _TENSOR_FIRST_ARG):
                    pos.add(node.args[0].id)
        elif (isinstance(node, ast.Subscript) and param(node.value)
                and any(isinstance(n, ast.Constant)
                        and (n.value is None or n.value is Ellipsis)
                        for n in ast.walk(node.slice))):
            pos.add(node.value.id)
    return cands, pos, neg


def _ann_tail(ann) -> str | None:
    qn = qualname(ann) if ann is not None else None
    return qn.rsplit(".", 1)[-1] if qn else None


def _class_fields(modules):
    """(class name, field name, annotation tail) of every annotated
    field of every class."""
    for mod in modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                for st in node.body:
                    if (isinstance(st, ast.AnnAssign)
                            and isinstance(st.target, ast.Name)):
                        yield (node.name, st.target.id,
                               _ann_tail(st.annotation))


def _tensor_fields_of(modules, tensor_types) -> set[str]:
    """Field names annotated only as Tensors or classes of tensors."""
    kinds: dict[str, set] = {}
    for _, field, ann in _class_fields(modules):
        kinds.setdefault(field, set()).add(
            ann == "Tensor" or ann in tensor_types)
    return {f for f, k in kinds.items() if k == {True}}


def _tensor_types_of(modules) -> set[str]:
    """Class names whose annotated fields are all Tensors or such
    classes, to a fixpoint."""
    fields: dict[str, list] = {}
    for cls, _, ann in _class_fields(modules):
        fields.setdefault(cls, []).append(ann)
    out: set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, anns in fields.items():
            if name not in out and all(a == "Tensor" or a in out
                                       for a in anns):
                out.add(name)
                changed = True
    return out


def project_of(ctx, tree, src, path) -> Project:
    """The run's Project, built once from the shared parsed sources and
    kept on the rule context."""
    proj = getattr(ctx, "project", None)
    if proj is None:
        sources = getattr(ctx, "sources", None) \
            or [(path, path, tree, src)]
        proj = ctx.project = Project(sources, ctx.config)
    return proj
