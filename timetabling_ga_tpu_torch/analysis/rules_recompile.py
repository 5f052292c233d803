"""TT201 / TT202 — cache-key hazards.

TT201: a `functools.lru_cache` (or `functools.cache`) function — the
port's made-once device constants, `ops/moves.py` move_probs and
`ops/sweep.py` _coprimes_on — called with an unhashable argument (a
list/dict/set display, `np.array`), which raises at call time, with a
tensor (`torch.tensor`/`as_tensor`/`from_numpy`: hashed by identity, so
every call misses and the cache pins each one), or with the loop
variable of an enclosing Python `for`, which misses on every iteration
and makes the device constant the cache exists to make once. Callees
are resolved across modules (analysis/project.py).

TT202: build/program cache completeness. A module-level cache dict
(`_LIBS`, `PROGRAMS`, `*_CACHE`) must key on EVERY value its entry is
built from: a factory argument (`load(name, path)`,
`obs_cost.instrument(fn, name)`, `make_*`) missing from the key means
two builds that differ only in that value collide on one entry, and the
cached library or program silently runs with the first one's. The
writes seen are `CACHE[key] = factory(...)` (directly or through a
name bound in the same scope), `CACHE.setdefault(key, factory(...))`
and `CACHE.update(...)` with a dict display or comprehension, on the
cache by its name or as a module attribute (`kernels._LIBS`). An
`update` with a dict built elsewhere (k5_phases.py's swap of
instrumented libraries, `kernels._LIBS.update(prof)`) shows no key and
is not seen.
"""

from __future__ import annotations

import ast
import re

from timetabling_ga_tpu_torch.analysis.core import (
    Finding, func_params, qual_matches, qualname, target_names)
from timetabling_ga_tpu_torch.analysis.project import project_of

RULE_STATIC = "TT201"
RULE_CACHE = "TT202"

_CACHE_DECORATORS = {"functools.lru_cache", "lru_cache", "functools.cache",
                     "cache"}
_UNHASHABLE_CALLS = {"np.array", "np.asarray", "numpy.array",
                     "numpy.asarray", "list", "dict", "set"}
_IDENTITY_CALLS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}


def _is_cached(fn) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        inner = dec.func if isinstance(dec, ast.Call) else dec
        if qual_matches(qualname(inner), _CACHE_DECORATORS):
            return True
    return False


def _hazard(expr: ast.AST) -> str | None:
    if isinstance(expr, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return "an unhashable value"
    if isinstance(expr, ast.Call):
        qn = qualname(expr.func)
        if qual_matches(qn, _UNHASHABLE_CALLS):
            return "an unhashable value"
        if qual_matches(qn, _IDENTITY_CALLS):
            return "a tensor (hashed by identity: every call misses)"
    return None


def _check_cached_calls(tree: ast.Module, path: str, ctx) -> list[Finding]:
    proj = project_of(ctx, tree, None, path)
    mod = next((m for m in proj.modules.values() if m.tree is tree), None)
    findings: list[Finding] = []
    if mod is None:
        return findings

    class V(ast.NodeVisitor):
        def __init__(self):
            self.loop_vars: list[set[str]] = []

        def visit_For(self, node: ast.For):
            self.loop_vars.append(set(target_names(node.target)))
            self.generic_visit(node)
            self.loop_vars.pop()

        def _check_expr(self, expr, name):
            what = _hazard(expr)
            if what is None and isinstance(expr, ast.Name) and any(
                    expr.id in lv for lv in self.loop_vars):
                what = f"loop variable `{expr.id}`"
            if what is not None:
                findings.append(Finding(
                    RULE_STATIC, path, expr.lineno, expr.col_offset,
                    f"argument of cached `{name}` (functools.lru_cache) "
                    f"receives {what} — unhashable keys raise at call "
                    f"time; keys that change on every call miss the "
                    f"cache and rebuild what it exists to make once"))

        def visit_Call(self, node: ast.Call):
            callee = proj.resolve(mod, node.func)
            if callee is not None and _is_cached(callee.node):
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    self._check_expr(arg, qualname(node.func))
            self.generic_visit(node)

    V().visit(tree)
    return findings


def _value_names(node: ast.AST) -> set[str]:
    """Data names an expression depends on: Name ids excluding callee
    chains (`obs_cost.instrument(fn)` depends on `fn`, not `obs_cost`)
    and lambda-bound parameters."""
    names: set[str] = set()

    def rec(n, bound: frozenset):
        if isinstance(n, ast.Call):
            for a in list(n.args) + [kw.value for kw in n.keywords]:
                rec(a, bound)      # skip n.func: callee, not data
        elif isinstance(n, ast.Lambda):
            rec(n.body, bound | frozenset(func_params(n)))
        elif isinstance(n, ast.Name):
            if n.id not in bound:
                names.add(n.id)
        else:
            for c in ast.iter_child_nodes(n):
                rec(c, bound)

    rec(node, frozenset())
    return names


def _factory_arg_names(call: ast.Call) -> set[str]:
    """Names a cached entry is built from: every data name in the
    factory call's arguments."""
    names: set[str] = set()
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        names |= _value_names(arg)
    return names


def _walk_scope(scope: ast.AST):
    """Walk a scope's own statements, not those of nested functions or
    classes (they are separate scopes with their own analysis)."""
    todo = list(ast.iter_child_nodes(scope))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            todo.extend(ast.iter_child_nodes(node))


def _method_stores(call: ast.Call) -> list[tuple[ast.AST, ast.AST]]:
    """(key, value) pairs a `setdefault` / `update` call on a cache
    writes, where the call shows them."""
    method = call.func.attr
    if method == "setdefault" and len(call.args) == 2:
        return [(call.args[0], call.args[1])]
    if method != "update" or len(call.args) != 1:
        return []
    arg = call.args[0]
    if isinstance(arg, ast.Dict):
        return [(k, v) for k, v in zip(arg.keys, arg.values)
                if k is not None]
    if isinstance(arg, ast.DictComp):
        return [(arg.key, arg.value)]
    return []


def _check_cache_keys(tree: ast.Module, path: str, ctx) -> list[Finding]:
    findings: list[Finding] = []
    cache_re = re.compile(ctx.config.cache_name_pattern)
    factory_re = re.compile(ctx.config.factory_pattern)

    def factory(val):
        if isinstance(val, ast.Call):
            fq = qualname(val.func)
            if fq and factory_re.match(fq.rsplit(".", 1)[-1]):
                return val
        return None

    def is_cache(node) -> bool:
        name = (node.id if isinstance(node, ast.Name)
                else node.attr if isinstance(node, ast.Attribute)
                else None)
        return name is not None and cache_re.match(name) is not None

    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
    for scope in scopes:
        key_tuples: dict[str, ast.Tuple] = {}
        factory_calls: dict[str, ast.Call] = {}
        stores: list[tuple[ast.AST, ast.AST]] = []  # (key expr, value)

        for node in _walk_scope(scope):
            if isinstance(node, ast.Assign):
                val = node.value
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        if isinstance(val, ast.Tuple):
                            key_tuples[tgt.id] = val
                        elif factory(val) is not None:
                            factory_calls[tgt.id] = val
                    elif (isinstance(tgt, ast.Subscript)
                          and is_cache(tgt.value)):
                        stores.append((tgt.slice, val))
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and is_cache(node.func.value)):
                stores.extend(_method_stores(node))

        for key, value in stores:
            call = factory(value)
            if call is None and isinstance(value, ast.Name):
                call = factory_calls.get(value.id)
            if call is None:
                continue
            label = qualname(key) or ast.unparse(key)
            if isinstance(key, ast.Name) and key.id in key_tuples:
                key = key_tuples[key.id]
            missing = sorted(_factory_arg_names(call)
                             - _value_names(key))
            for name in missing:
                findings.append(Finding(
                    RULE_CACHE, path, call.lineno, call.col_offset,
                    f"cache key `{label}` omits `{name}`, which the "
                    f"cached entry is built from — two builds differing "
                    f"only in `{name}` collide on one entry"))
    return findings


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    out = []
    if "TT201" in ctx.config.rules:
        out += _check_cached_calls(tree, path, ctx)
    if "TT202" in ctx.config.rules:
        out += _check_cache_keys(tree, path, ctx)
    return out
