"""tt-analyze for the port — static analysis of timetabling_ga_tpu_torch.

Usage:
    python -m timetabling_ga_tpu_torch.analysis [--strict] [--json]
        [--sarif] [--warn-unused-ignores] [--rules ...] [--list-rules]
        [--root .] [paths...]

The counterpart of timetabling_ga_tpu/analysis: the same 26 rule ids,
each guarding the same hazard in its torch form (README "Static
analysis of the port"; `--list-rules` prints one line a rule):

  TT101/TT102  implicit bool() on a tensor in a device program
  TT201/TT202  lru_cache keys and build/program cache keys
  TT203/TT304  a non-blocking device->host copy read before its event,
               in one function / across modules
  TT301        hidden host syncs in dispatch loops
  TT302        torch.distributed calls outside the comm group
  TT303        whole-program device taint into host sinks
  TT305        dispatch-fence discipline
  TT306        host fetch of resident group state outside a park fence
  TT307        collectives on the recovery/agreement path
  TT309        edit-solve work in dispatch loops or device programs
  TT310        profiler ranges outside the PHASES registry or on
               handler paths
  TT401/TT402  generator discipline: draws without `generator=`, shared
               seeds, loop-carried seeds
  TT501/TT502  no JAX; the pinned torch surface (compat.py)
  TT601        clocks and spans inside device programs
  TT602        blocking I/O / registry writes on HTTP handler paths
  TT603        allocator/device introspection on hot paths
  TT604        quality accounting off the card
  TT605        device work / unbounded reads on fleet handler paths
  TT606        incident-bundle serialization off the recorder thread
  TT607        usage-ledger mutation off its home threads
  TT608        fleet actuation off the scaler thread

Suppress one finding inline with `# tt-analyze: ignore[TT301]` (on the
line, or on a comment line directly above); `--warn-unused-ignores`
reports markers that suppress nothing (TT901). The settings live in
config.py (JAX's `[tool.tt-analyze]` mapped to the port's names; no
pyproject.toml section is read). Exit status: 0, or 1 under --strict
when findings remain.

Every file is parsed exactly once per run; the parsed trees are shared
across all rules and the whole-program layer (analysis/project.py), and
`--json` reports per-rule and total wall time.

Stdlib-only: linting imports neither torch nor JAX nor either package,
and needs no device.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import time

from timetabling_ga_tpu_torch.analysis.config import (
    ALL_RULES, AnalyzerConfig, load_compat_table, load_config)
from timetabling_ga_tpu_torch.analysis.core import (
    Finding, filter_suppressed, unused_suppressions)

__all__ = ["Finding", "AnalyzerConfig", "run_analysis", "main",
           "ALL_RULES"]


class _Context:
    """Per-run state shared by the rules: config, the pinned torch
    table, and — set by run_analysis — the shared parsed sources the
    whole-program layer (analysis/project.py) is built from, once."""

    def __init__(self, config: AnalyzerConfig):
        self.config = config
        self.compat_table = load_compat_table(config)
        self.sources: list[tuple] = []        # (path, rel, tree, src)
        self.interproc_findings = None        # rules_interproc cache
        self.project = None                   # project.project_of cache


def _rule_modules():
    from timetabling_ga_tpu_torch.analysis import (
        rules_accord, rules_api, rules_cost, rules_donate,
        rules_edit, rules_fleet, rules_flight, rules_http,
        rules_interproc, rules_obs, rules_prof, rules_quality,
        rules_recompile, rules_rng, rules_scale, rules_sync,
        rules_trace, rules_usage)
    return {
        "TT101": rules_trace,
        "TT102": rules_trace,
        "TT201": rules_recompile,
        "TT202": rules_recompile,
        "TT203": rules_donate,
        "TT301": rules_sync,
        "TT302": rules_sync,
        "TT303": rules_interproc,
        "TT304": rules_interproc,
        "TT305": rules_interproc,
        "TT306": rules_interproc,
        "TT307": rules_accord,
        "TT309": rules_edit,
        "TT310": rules_prof,
        "TT401": rules_rng,
        "TT402": rules_rng,
        "TT501": rules_api,
        "TT502": rules_api,
        "TT601": rules_obs,
        "TT602": rules_http,
        "TT603": rules_cost,
        "TT604": rules_quality,
        "TT605": rules_fleet,
        "TT606": rules_flight,
        "TT607": rules_usage,
        "TT608": rules_scale,
    }


# each rule's torch meaning, one line (--list-rules, SARIF)
RULE_DOCS = {
    "TT101": "if/while/assert/for on a tensor in a device program "
             "(an implicit bool() host sync)",
    "TT102": "and/or short-circuit on a tensor in a device program "
             "(bool() in expression position)",
    "TT201": "functools.lru_cache called with unhashable, tensor or "
             "loop-varying arguments",
    "TT202": "build/program cache key omitting a value the entry is "
             "built from (kernels._LIBS, dcore.PROGRAMS)",
    "TT203": "non-blocking device->host copy destination read before "
             "its synchronize()/wait()",
    "TT301": "hidden host syncs (.item/.cpu/.numpy/float/np.asarray/"
             "synchronize) in dispatch loops",
    "TT302": "torch.distributed collective in ops/ or parallel/ "
             "outside parallel/comm.py",
    "TT303": "whole-program device taint from another module's "
             "dispatch program reaching a host sink in a dispatch loop",
    "TT304": "HostCopy.host read across modules before the copy's "
             "event is waited on",
    "TT305": "fence discipline: telemetry fetch fencing a dispatch; "
             "control steered through a synchronize",
    "TT306": "host fetch of device-resident group state (_resident) "
             "outside a park-fence helper",
    "TT307": "torch.distributed / comm collectives in the accord "
             "channel or *Supervisor bodies",
    "TT309": "edit-solve (serve/editsolve.py) work in dispatch loops "
             "or device programs",
    "TT310": "obs_prof.scope / record_function names outside PHASES, "
             "or ranges on handler paths",
    "TT401": "torch random op without generator= (global stream), or "
             "one seed feeding two generators",
    "TT402": "manual_seed in a loop on a seed free of the loop "
             "variable",
    "TT501": "import of jax/jaxlib/timetabling_ga_tpu, or of torch "
             "outside TORCH_COMPAT_TABLE",
    "TT502": "torch.* attribute chain outside TORCH_COMPAT_TABLE",
    "TT601": "wall-clock reads and span calls inside device programs "
             "(they time the enqueue)",
    "TT602": "blocking I/O or MetricsRegistry mutation on HTTP "
             "handler paths",
    "TT603": "torch.cuda memory/device introspection in device "
             "programs or dispatch loops",
    "TT604": "host quality recompute in dispatch loops; collectives or "
             "draws in quality helpers",
    "TT605": "device work (torch.cuda, .to(device), kernels.launch, "
             "copies) or unbounded reads on fleet handler paths",
    "TT606": "bundle serialization/file I/O in dispatch loops or "
             "device programs; dump triggers on handler paths",
    "TT607": "usage-ledger mutation in device programs or on handler "
             "paths; handler-side metering clocks",
    "TT608": "fleet actuator calls on handler paths or in "
             "dispatcher-tick bodies",
}


def _rule_docs() -> dict[str, str]:
    docs = dict(RULE_DOCS)
    docs["TT000"] = "syntax error"
    docs["TT901"] = "unused `# tt-analyze: ignore` suppression marker"
    return docs


def _iter_py_files(paths, root):
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            yield full
        else:
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith((".", "__pycache")))
                for fname in sorted(filenames):
                    if fname.endswith(".py"):
                        yield os.path.join(dirpath, fname)


def _rule_groups(config):
    """(label, module) pairs for the enabled rules, one entry per rule
    module, labels joining the rule ids the module implements."""
    mods = _rule_modules()
    groups: list[tuple[list[str], object]] = []
    for rule in config.rules:
        mod = mods.get(rule)
        if mod is None:
            continue
        for rules, m in groups:
            if m is mod:
                rules.append(rule)
                break
        else:
            groups.append(([rule], mod))
    return [("+".join(rules), mod) for rules, mod in groups]


def run_analysis(paths=None, config: AnalyzerConfig | None = None,
                 timings: dict | None = None) -> list[Finding]:
    """Analyze `paths` (files or directories); returns all findings.

    Single-parse: every file is read and parsed exactly once, and the
    trees are shared by all per-file rules and the whole-program layer.
    Pass a dict as `timings` to receive {"total_s", "per_rule_s"}.
    """
    if config is None:
        config = load_config(".")
    ctx = _Context(config)
    t_total = time.perf_counter()

    order: list[str] = []             # rel paths in walk order
    srcs: dict[str, str] = {}
    syntax_errors: dict[str, Finding] = {}
    for path in _iter_py_files(paths or config.paths, config.root):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        rel = os.path.relpath(path, config.root)
        if rel.startswith(".."):
            rel = path
        order.append(rel)
        srcs[rel] = src
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            syntax_errors[rel] = Finding(
                "TT000", rel, e.lineno or 0, e.offset or 0,
                f"syntax error: {e.msg}")
            continue
        ctx.sources.append((path, rel, tree, src))

    per_file: dict[str, list[Finding]] = {rel: [] for rel in order}
    per_rule_s: dict[str, float] = {}
    for label, mod in _rule_groups(config):
        t0 = time.perf_counter()
        for _, rel, tree, src in ctx.sources:
            per_file[rel].extend(mod.check(tree, src, rel, ctx))
        per_rule_s[label] = round(time.perf_counter() - t0, 6)

    findings: list[Finding] = []
    enabled = set(config.rules)
    for rel in order:
        if rel in syntax_errors:
            findings.append(syntax_errors[rel])
            continue
        # rules sharing a module (TT201/TT202) can duplicate; dedupe
        # exactly, then keep only the enabled ids
        fs = sorted({f for f in per_file[rel] if f.rule in enabled},
                    key=lambda f: (f.line, f.col, f.rule))
        kept = filter_suppressed(fs, srcs[rel])
        if config.warn_unused_ignores:
            kept += unused_suppressions(fs, srcs[rel], rel)
        findings.extend(kept)

    if timings is not None:
        timings["per_rule_s"] = per_rule_s
        timings["total_s"] = round(time.perf_counter() - t_total, 6)
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tt-analyze-torch",
        description="static analysis of the PyTorch port (implicit "
                    "syncs, cache keys, host copies, whole-program "
                    "device taint, generator discipline, pinned torch "
                    "surface, handler/ledger/actuator threads)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to scan (default: the "
                         "timetabling_ga_tpu_torch package)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 if any finding remains")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable JSON report on stdout "
                         "(includes per-rule wall time)")
    ap.add_argument("--sarif", action="store_true", dest="as_sarif",
                    help="SARIF 2.1.0 report on stdout (CI annotations)")
    ap.add_argument("--warn-unused-ignores", action="store_true",
                    help="report stale `# tt-analyze: ignore` markers "
                         "(TT901)")
    ap.add_argument("--root", default=".",
                    help="project root the scan paths and the compat "
                         "table are taken relative to")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to enable "
                         f"(default: all of {','.join(ALL_RULES)})")
    ap.add_argument("--list-rules", action="store_true",
                    help="print rule ids and one-line summaries")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in sorted(_rule_modules()):
            print(f"{rule}  {RULE_DOCS[rule]}")
        return 0

    config = load_config(args.root)
    if args.rules:
        config.rules = [r.strip() for r in args.rules.split(",")]
    if args.warn_unused_ignores:
        config.warn_unused_ignores = True
    timings: dict = {}
    findings = run_analysis(args.paths or None, config, timings=timings)

    if args.as_sarif:
        from timetabling_ga_tpu_torch.analysis.sarif import to_sarif
        print(json.dumps(to_sarif(findings, _rule_docs()), indent=2,
                         sort_keys=True))
    elif args.as_json:
        print(json.dumps({
            "findings": [f.to_json() for f in findings],
            "count": len(findings),
            "strict": args.strict,
            "timing": timings,
        }, indent=2))
    else:
        for f in findings:
            print(f.render())
        n = len(findings)
        print(f"tt-analyze: {n} finding{'s' if n != 1 else ''}",
              file=sys.stderr)
    return 1 if (args.strict and findings) else 0
