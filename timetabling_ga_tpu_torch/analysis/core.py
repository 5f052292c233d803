"""Shared infrastructure of the port's tt-analyze rules: findings, the
inline-suppression protocol and the small AST utilities every rule uses
(the counterpart of timetabling_ga_tpu/analysis/core.py, whose semantics
it keeps unchanged).

Stdlib-only: the analyzer runs without importing torch, JAX or either
package, and without a device.
"""

from __future__ import annotations

import ast
import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str          # e.g. "TT101"
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# `# tt-analyze: ignore` suppresses every rule on that line;
# `# tt-analyze: ignore[TT301]` / `ignore[TT301,TT401]` only those.
_SUPPRESS_RE = re.compile(
    r"#\s*tt-analyze:\s*ignore(?:\[([A-Za-z0-9_,\s]+)\])?")


def iter_markers(src: str):
    """Every `# tt-analyze: ignore` marker in `src` as
    (marker_line, rules | None, covered_lines): a marker covers its own
    line, and — on a comment-only line — the line below it too.

    A marker is a COMMENT TOKEN that begins with the marker text:
    tokenizing (not line-grepping) keeps docstrings and prose comments
    that merely MENTION the syntax from acting as suppressions — and,
    under --warn-unused-ignores, from being reported as stale."""
    import io
    import tokenize
    lines = src.splitlines()
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(src).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return
    for tok in toks:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.match(tok.string)
        if not m:
            continue
        i = tok.start[0]
        rules = (None if m.group(1) is None
                 else {r.strip() for r in m.group(1).split(",")
                       if r.strip()})
        covered = {i}
        if i <= len(lines) and lines[i - 1].lstrip().startswith("#"):
            covered.add(i + 1)
        yield i, rules, covered


def suppressions(src: str) -> dict[int, set[str] | None]:
    """Map 1-based line number -> suppressed rule ids (None = all rules).

    A marker suppresses findings on its own line; a marker on a
    comment-only line also suppresses findings on the line below it.
    """
    out: dict[int, set[str] | None] = {}
    for _, rules, covered in iter_markers(src):
        for ln in covered:
            cur = out.get(ln, set())
            out[ln] = None if (rules is None or cur is None) \
                else cur | rules
    return out


def filter_suppressed(findings: list[Finding], src: str) -> list[Finding]:
    supp = suppressions(src)
    kept = []
    for f in findings:
        rules = supp.get(f.line, set())
        if rules is None or (rules and f.rule in rules):
            continue
        kept.append(f)
    return kept


def unused_suppressions(findings: list[Finding], src: str, path: str
                        ) -> list[Finding]:
    """Markers that suppress nothing — the unused-noqa analogue.

    `findings` must be the PRE-suppression list for this file: a marker
    is used iff some finding on a covered line matches its rule scope.
    A marker scoped to a disabled rule is unused (like flake8)."""
    out = []
    for line, rules, covered in iter_markers(src):
        used = any(f.line in covered
                   and (rules is None or f.rule in rules)
                   for f in findings)
        if not used:
            scope = "all rules" if rules is None \
                else ",".join(sorted(rules))
            out.append(Finding(
                "TT901", path, line, 0,
                f"unused suppression: `# tt-analyze: ignore` marker "
                f"({scope}) suppresses no finding — drop the stale "
                f"marker"))
    return out


def qualname(node: ast.AST) -> str | None:
    """Dotted name of a Name/Attribute chain ('torch.cuda.synchronize'), else
    None for anything not a plain attribute path."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def qual_matches(qn: str | None, names: set[str]) -> bool:
    """True if the dotted name's tail matches any entry:
    'torch.cuda.synchronize' matches both 'cuda.synchronize' and
    'synchronize' entries."""
    if qn is None:
        return False
    parts = qn.split(".")
    for i in range(len(parts)):
        if ".".join(parts[i:]) in names:
            return True
    return False


def target_names(target: ast.AST):
    """Bound names of an assignment target (handles tuple/list/star)."""
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, ast.Starred):
        yield from target_names(target.value)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from target_names(elt)


def name_ids(node: ast.AST) -> set[str]:
    """Every Name id appearing anywhere under `node`."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def func_params(fn: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda
                ) -> list[str]:
    a = fn.args
    params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        params.append(a.vararg.arg)
    if a.kwarg:
        params.append(a.kwarg.arg)
    return params
