"""TT401 / TT402 — generator discipline.

The port draws every random number through an explicit
`torch.Generator` (one per island, ops/moves.py, ops/ga.py,
parallel/islands.py lane_generator), seeded from the run's seed tree, so
that a run's record stream depends on its seed and its layout alone.
Two ways to break that with no runtime error to catch it — the torch
shape of JAX's key reuse:

TT401 — a draw outside its generator, or two generators on one seed.
  (a) a torch random op with no `generator=`: `torch.rand` /
      `randn` / `randint` / `rand_like` / `randn_like` / `randint_like`
      / `randperm` / `multinomial` / `bernoulli` / `normal` / `poisson`,
      the method forms `.multinomial()` / `.bernoulli()`, and the
      in-place `.uniform_()` / `.random_()` / `.normal_()` /
      `.exponential_()` / `.bernoulli_()` / `.geometric_()` /
      `.cauchy_()` / `.log_normal_()`. Such a draw comes from the
      process-global generator: it shifts with every other global draw
      in the process (a test, a library, another island's thread), so
      two layouts of one seed stop giving the same stream.
  (b) one seed expression feeding two generators in one scope
      (`g.manual_seed(s)` at two sites, no rebind of the expression's
      names between them): the two generators draw identical streams.

TT402 — a loop-carried seed: `manual_seed(e)` inside a `for` loop (or a
comprehension) where `e` does not depend on the loop variable (or a
name derived from it). The site runs once an iteration, so every
generator it seeds in the loop draws the same stream — N "independent"
islands or restarts that are all one.

Seeds of the global generator (`torch.manual_seed`) are not TT401's:
the port never draws from it, and (a) finds any draw that would.
"""

from __future__ import annotations

import ast

from timetabling_ga_tpu_torch.analysis.core import (
    Finding, qualname, target_names)
from timetabling_ga_tpu_torch.analysis.project import torch_aliases

RULE = "TT401"
RULE_LOOP = "TT402"

# torch.<f> random ops and their Tensor-method forms
_TORCH_DRAWS = {"rand", "randn", "randint", "rand_like", "randn_like",
                "randint_like", "randperm", "multinomial", "bernoulli",
                "normal", "poisson"}
_METHOD_DRAWS = {"multinomial", "bernoulli", "uniform_", "random_",
                 "normal_", "exponential_", "bernoulli_", "geometric_",
                 "cauchy_", "log_normal_"}


def _draw_name(call: ast.Call, torch_names: set[str]) -> str | None:
    """The op's display name when `call` is a torch random draw (numpy's
    `np.random.*` and `rng.*` draws are not torch's)."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    recv = (qualname(f.value) or "").split(".")
    if recv[0] in torch_names and len(recv) == 1:
        return f"torch.{f.attr}" if f.attr in _TORCH_DRAWS else None
    if f.attr in _METHOD_DRAWS and not (
            recv[0] in ("np", "numpy") or {"random", "rng"} & set(recv)):
        return f".{f.attr}"
    return None


def _seed_arg(call: ast.Call):
    """The seed expression of a generator's `.manual_seed(e)`, else
    None (`torch.manual_seed` and `torch.cuda.manual_seed*` seed the
    global generators)."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "manual_seed"
            and call.args):
        return None
    if (qualname(f.value) or "").split(".")[0] == "torch":
        return None
    return call.args[0]


def _check_draws(tree, path, torch_names, findings):
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _draw_name(node, torch_names)
        if name is None or any(kw.arg == "generator"
                               for kw in node.keywords):
            continue
        findings.append(Finding(
            RULE, path, node.lineno, node.col_offset,
            f"`{name}(...)` draws without `generator=` — from the "
            f"process-global generator, whose stream moves with every "
            f"other global draw in the process; pass the island's (or "
            f"lane's) torch.Generator"))


def _scope_walk(scope):
    """Walk a scope's nodes without descending into nested functions
    (they are their own scopes)."""
    todo = list(ast.iter_child_nodes(scope))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
            todo.extend(ast.iter_child_nodes(node))


def _names_under(node) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _SeedScan:
    """TT401(b): linear walk of one scope; a seed expression seen at a
    second manual_seed site flags, until a name in it is rebound."""

    def __init__(self, path, findings):
        self.path = path
        self.findings = findings
        self.seen: dict[str, int] = {}      # ast.dump(seed) -> lineno
        self.names: dict[str, set] = {}     # ast.dump(seed) -> names

    def _calls(self, node):
        todo = [node]
        while todo:
            sub = todo.pop()
            if isinstance(sub, (ast.ListComp, ast.SetComp, ast.DictComp,
                                ast.GeneratorExp, ast.Lambda)):
                continue        # a comprehension's sites are TT402's
            todo.extend(ast.iter_child_nodes(sub))
            if not isinstance(sub, ast.Call):
                continue
            seed = _seed_arg(sub)
            if seed is None:
                continue
            key = ast.dump(seed)
            if key in self.seen:
                self.findings.append(Finding(
                    RULE, self.path, sub.lineno, sub.col_offset,
                    f"seed `{ast.unparse(seed)}` already seeded a "
                    f"generator on line {self.seen[key]} — the two "
                    f"generators draw identical streams; derive a "
                    f"distinct seed for each"))
            else:
                self.seen[key] = sub.lineno
                self.names[key] = _names_under(seed)

    def _rebind(self, names):
        for key in [k for k, ns in self.names.items() if ns & names]:
            del self.seen[key], self.names[key]

    def run(self, scope):
        body = scope.body if isinstance(scope.body, list) else []
        self._stmts(body)

    def _stmts(self, stmts):
        for st in stmts:
            self._stmt(st)

    def _stmt(self, st):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return
        if isinstance(st, (ast.For, ast.While)):
            # a loop site is TT402's; its body rebinds what it binds
            bound = set(target_names(st.target)) if isinstance(
                st, ast.For) else set()
            for node in ast.walk(st):
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        bound |= set(target_names(tgt))
            self._rebind(bound)
            return
        for field in ("value", "test"):
            v = getattr(st, field, None)
            if isinstance(v, ast.expr):
                self._calls(v)
        if isinstance(st, ast.With):
            for item in st.items:
                self._calls(item.context_expr)
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            tgts = st.targets if isinstance(st, ast.Assign) else [st.target]
            self._rebind({n for t in tgts for n in target_names(t)})
        for field in ("body", "orelse", "finalbody"):
            self._stmts(getattr(st, field, []) or [])
        for h in getattr(st, "handlers", []) or []:
            self._stmts(h.body)


def _loops(scope):
    """(loop node, loop variables, body nodes) for each `for` statement
    and comprehension of one scope."""
    for node in _scope_walk(scope):
        if isinstance(node, ast.For):
            yield node, set(target_names(node.target)), node.body
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            loop_vars = set()
            for gen in node.generators:
                loop_vars |= set(target_names(gen.target))
            body = [node.key, node.value] if isinstance(
                node, ast.DictComp) else [node.elt]
            yield node, loop_vars, body


def _check_loop_seeds(scope, path, findings):
    for loop, loop_vars, body in _loops(scope):
        # names derived from a loop variable vary per iteration too
        derived = set(loop_vars)
        changed = True
        while changed:
            changed = False
            for node in ast.walk(loop):
                if (isinstance(node, ast.Assign)
                        and _names_under(node.value) & derived):
                    for tgt in node.targets:
                        for nm in target_names(tgt):
                            if nm not in derived:
                                derived.add(nm)
                                changed = True
        for part in body:
            for call in ast.walk(part):
                if not isinstance(call, ast.Call):
                    continue
                seed = _seed_arg(call)
                if seed is None or _names_under(seed) & derived:
                    continue
                findings.append(Finding(
                    RULE_LOOP, path, call.lineno, call.col_offset,
                    f"`manual_seed({ast.unparse(seed)})` runs on every "
                    f"iteration of the enclosing loop with a seed free "
                    f"of the loop variable — every generator it seeds "
                    f"there draws the same stream; fold the loop index "
                    f"into the seed"))


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    findings: list[Finding] = []
    if "TT401" in ctx.config.rules:
        _check_draws(tree, path, torch_aliases(tree), findings)
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
    for scope in scopes:
        if "TT401" in ctx.config.rules:
            _SeedScan(path, findings).run(scope)
        if "TT402" in ctx.config.rules:
            _check_loop_seeds(scope, path, findings)
    return findings
