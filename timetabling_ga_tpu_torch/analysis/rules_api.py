"""TT501/TT502 — no JAX, and the pinned torch surface.

TT501 has two halves.

  The no-reference rule: the port never imports `jax`, `jaxlib` or the
  JAX package `timetabling_ga_tpu` (its own copies of what it needs
  live in timetabling_ga_tpu_torch), whether by an import statement or
  by `importlib.import_module("...")` / `__import__("...")` with a
  literal name, guarded or not: a guarded import of the reference is
  still a run that differs with what the machine has installed.

  The pinned surface: every `import torch...` / `import triton...` and
  every `from torch... import x` must be declared in the compatibility
  table (`TORCH_COMPAT_TABLE` in timetabling_ga_tpu_torch/compat.py,
  read by AST): the table is the set of torch symbols known to exist on
  every PyTorch the port runs on (the sandbox's CPU build and the card
  machine's CUDA build, where chip_smoke.py resolves every entry).

TT502: the same pinning for ATTRIBUTE access. `torch.cuda.mem_get_info`
or `torch.distributed.TCPStore` never appear in an import statement, so
they bypass TT501 — yet an attribute a supported torch does not export
fails the same way, just later (first call instead of import). Every
maximal attribute chain rooted at a name bound by a torch import
(`torch`, `dist` from `import torch.distributed as dist`, ...) must
resolve through the table: the longest table-key module prefix is
found, and the next component must be in that entry's list. "*" allows
any public name (a private `_x` must be listed by name).

Constructs inside a `try:` whose handler catches ImportError (TT501's
second half) or ImportError/AttributeError (TT502) are exempt: those
are the sanctioned version-tolerance idioms, where a missing symbol is
handled, not fatal. `getattr(torch, "name", default)` probing is not an
attribute chain.
"""

from __future__ import annotations

import ast

from timetabling_ga_tpu_torch.analysis.core import Finding, qualname

RULE = "TT501"
RULE_ATTR = "TT502"

_IMPORT_ERRORS = {"ImportError", "ModuleNotFoundError", "Exception",
                  "BaseException"}
_ATTR_ERRORS = _IMPORT_ERRORS | {"AttributeError"}
# packages the port may not import at all
_BANNED = ("jax", "jaxlib", "timetabling_ga_tpu")
# packages whose surface the table pins
_PINNED = ("torch", "triton")


def _is_under(mod: str, roots) -> bool:
    return any(mod == r or mod.startswith(r + ".") for r in roots)


def _guarded_lines(tree: ast.Module, error_names: set[str]) -> set[int]:
    """Line numbers inside try/except bodies whose handlers catch one
    of `error_names`."""
    lines: set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        catches = False
        for h in node.handlers:
            if h.type is None:
                catches = True
                continue
            types = h.type.elts if isinstance(h.type, ast.Tuple) \
                else [h.type]
            for t in types:
                qn = qualname(t)
                if qn and qn.rsplit(".", 1)[-1] in error_names:
                    catches = True
        if not catches:
            continue
        for part in ([node.body] + [h.body for h in node.handlers]
                     + [node.orelse]):
            for st in part:
                lines.update(range(st.lineno,
                                   (st.end_lineno or st.lineno) + 1))
    return lines


def _aliases(tree: ast.Module) -> dict[str, str]:
    """Local name -> dotted torch/triton path it is bound to."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if _is_under(a.name, _PINNED):
                    if a.asname:
                        out[a.asname] = a.name
                    else:
                        root = a.name.split(".")[0]
                        out[root] = root
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level or not _is_under(mod, _PINNED):
                continue
            for a in node.names:
                if a.name != "*":
                    out[a.asname or a.name] = f"{mod}.{a.name}"
    return out


def _allowed(allowed, name: str) -> bool:
    return name in allowed or ("*" in allowed
                               and not name.startswith("_"))


def _check_attrs(tree: ast.Module, path: str, table) -> list[Finding]:
    """TT502: maximal torch-rooted attribute chains vs the table."""
    aliases = _aliases(tree)
    if not aliases:
        return []
    guarded = _guarded_lines(tree, _ATTR_ERRORS)
    sub_chains = {id(node.value) for node in ast.walk(tree)
                  if isinstance(node, ast.Attribute)
                  and isinstance(node.value, ast.Attribute)}
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute) or id(node) in sub_chains:
            continue
        qn = qualname(node)
        if qn is None or node.lineno in guarded:
            continue
        root, _, rest = qn.partition(".")
        if root not in aliases:
            continue
        q = aliases[root] + "." + rest
        parts = q.split(".")
        for i in range(len(parts) - 1, 0, -1):
            prefix = ".".join(parts[:i])
            allowed = table.get(prefix)
            if allowed is None:
                continue
            if not _allowed(allowed, parts[i]):
                findings.append(Finding(
                    RULE_ATTR, path, node.lineno, node.col_offset,
                    f"`{q}` is outside the pinned torch surface — "
                    f"`{parts[i]}` is not declared under `{prefix}` in "
                    f"TORCH_COMPAT_TABLE (compat.py); declare it (the "
                    f"chip smoke resolves every entry on the card's "
                    f"PyTorch) or guard it"))
            break
    return findings


def _banned_finding(path, node, what) -> Finding:
    return Finding(
        RULE, path, node.lineno, node.col_offset,
        f"{what} references JAX or the JAX package — the port imports "
        f"neither (its tests alone hold it against the reference); keep "
        f"the port's own copy of what it needs")


def _dynamic_import(node: ast.Call) -> str | None:
    qn = qualname(node.func)
    if qn in ("importlib.import_module", "import_module", "__import__") \
            and node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    table = ctx.compat_table
    findings: list[Finding] = []
    if "TT502" in ctx.config.rules and table:
        findings += _check_attrs(tree, path, table)
    guarded = _guarded_lines(tree, _IMPORT_ERRORS)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                mod = alias.name
                if _is_under(mod, _BANNED):
                    findings.append(_banned_finding(
                        path, node, f"`import {mod}`"))
                elif (_is_under(mod, _PINNED) and table
                        and node.lineno not in guarded
                        and mod not in table):
                    findings.append(Finding(
                        RULE, path, node.lineno, node.col_offset,
                        f"`import {mod}` is outside the pinned torch "
                        f"surface — declare it in TORCH_COMPAT_TABLE "
                        f"(compat.py)"))
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                continue
            if _is_under(mod, _BANNED):
                findings.append(_banned_finding(
                    path, node, f"`from {mod} import ...`"))
                continue
            if not (_is_under(mod, _PINNED) and table) \
                    or node.lineno in guarded:
                continue
            allowed = table.get(mod)
            for alias in node.names:
                if allowed is not None and _allowed(allowed, alias.name):
                    continue
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"`from {mod} import {alias.name}` is outside the "
                    f"pinned torch surface — declare it in "
                    f"TORCH_COMPAT_TABLE (compat.py)"))
        elif isinstance(node, ast.Call):
            name = _dynamic_import(node)
            if name is not None and _is_under(name, _BANNED):
                findings.append(_banned_finding(
                    path, node, f"`{qualname(node.func)}({name!r})`"))
    return findings
