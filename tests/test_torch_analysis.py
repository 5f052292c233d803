"""tt-analyze for the port (timetabling_ga_tpu_torch/analysis) tests.

Every rule fires on its seeded fixture in tests/torch_analyzer_fixtures
exactly at the lines its `# EXPECT TTxxx` markers declare, the clean
fixture gives zero findings, the port's own tree is strict-clean, and
the analyzer runs with torch and JAX blocked from import. Held against
JAX's analyzer on JAX's own fixtures: the handler, ledger, actuator and
edit-solve rules (TT309, TT602, TT604-TT608) agree on (rule, line, col)
but for the lines named in JAX_ONLY, whose sink has no torch meaning;
the SARIF writer reproduces JAX's golden file but for the tool's name;
and the suppression parser agrees with JAX's on a table of comments.

Both analyzers are stdlib-only: no torch/JAX compile runs here.
"""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from timetabling_ga_tpu_torch.analysis import (
    RULE_DOCS, _rule_modules, run_analysis)
from timetabling_ga_tpu_torch.analysis.config import (
    ALL_RULES, AnalyzerConfig, load_compat_table,
    load_config, load_phases)
from timetabling_ga_tpu_torch.analysis.core import Finding, suppressions
from timetabling_ga_tpu_torch.analysis.sarif import to_sarif

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_analyzer_fixtures")
JAX_FIXTURES = os.path.join(REPO, "tests", "analyzer_fixtures")

_EXPECT_RE = re.compile(r"#\s*EXPECT\s+(TT\d{3})")

# the fixture additions JAX's tests make to its config
# (tests/test_analysis.py fixture_config), applied to either config
_DISPATCH = ["viol_sync.py", "viol_cost.py", "viol_quality.py",
             "viol_flight.py", "viol_edit.py", "interproc/loop.py"]
_SHARDED = ["viol_collective.py", "viol_quality.py"]
_FLEET = ["viol_fleet.py", "viol_gw_api.py", "viol_scale.py"]
_ACCORD = ["viol_accord.py"]


def expected_findings(path: str) -> set:
    """(rule, line) pairs the fixture's `# EXPECT TTxxx` markers declare."""
    out = set()
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            for rule in _EXPECT_RE.findall(line):
                out.add((rule, lineno))
    return out


def _with_fixtures(cfg):
    cfg.root = REPO
    cfg.dispatch_modules = list(cfg.dispatch_modules) + _DISPATCH
    cfg.sharded_modules = list(cfg.sharded_modules) + _SHARDED
    cfg.fleet_modules = list(cfg.fleet_modules) + _FLEET
    cfg.accord_modules = list(cfg.accord_modules) + _ACCORD
    return cfg


def fixture_config() -> AnalyzerConfig:
    cfg = _with_fixtures(load_config(REPO))
    # the port's fixtures whose every function is a device program, as
    # every function of ops/ is
    cfg.program_modules = list(cfg.program_modules) + ["viol_obs_clock.py"]
    return cfg


def analyze_fixture(fixture: str):
    return run_analysis([os.path.join(FIXTURES, fixture)], fixture_config())


PORT_FIXTURES = [
    "viol_trace.py",       # TT101 implicit bool() in device programs
    "viol_boolop.py",      # TT102 and/or on tensors
    "viol_recompile.py",   # TT201/TT202 lru_cache and cache keys
    "viol_donate.py",      # TT203 non-blocking copy read before its event
    "viol_sync.py",        # TT301 hidden syncs in dispatch loops
    "viol_collective.py",  # TT302 torch.distributed outside comm
    "viol_accord.py",      # TT307 collectives in the accord channel
    "viol_supervisor.py",  # TT307 collectives in *Supervisor bodies
    "viol_edit.py",        # TT309 edit-solve in loops / programs
    "viol_prof.py",        # TT310 profiler ranges vs PHASES
    "viol_rng.py",         # TT401 draws without generator=, shared seeds
    "viol_loopseed.py",    # TT402 loop-carried seeds
    "viol_api.py",         # TT501 no JAX; pinned torch imports
    "viol_attr_api.py",    # TT502 pinned torch attribute chains
    "viol_obs_clock.py",   # TT601 clocks/spans in device programs
    "viol_obs_http.py",    # TT602 handler-path I/O and registry writes
    "viol_cost.py",        # TT603 allocator introspection on hot paths
    "viol_quality.py",     # TT604 quality off the card
    "viol_fleet.py",       # TT605 device work on fleet handler paths
    "viol_gw_api.py",      # TT602/TT605 on *Api roots
    "viol_flight.py",      # TT606 bundle serialization off its thread
    "viol_usage.py",       # TT607 usage-ledger mutation off its threads
    "viol_scale.py",       # TT608 fleet actuation off the scaler
]


@pytest.mark.parametrize("fixture", PORT_FIXTURES)
def test_rule_fires_at_expected_lines(fixture):
    """Each rule family fires exactly at the marked (rule, line) pairs —
    no misses, no extras; and a strict run over it would exit 1."""
    expected = expected_findings(os.path.join(FIXTURES, fixture))
    assert expected, f"fixture {fixture} declares no EXPECT markers"
    got = {(f.rule, f.line) for f in analyze_fixture(fixture)}
    assert got == expected


def test_clean_fixture_has_zero_findings():
    assert analyze_fixture("clean.py") == []


def test_interproc_rules_fire_across_module_boundary():
    """TT303/TT304/TT305/TT306 localize each seeded CROSS-MODULE
    violation (factory, device program, fetch and host copy declared in
    interproc/core.py, broken in interproc/loop.py) and stay silent on
    core.py and on loop.py's clean idioms."""
    pkg = os.path.join(FIXTURES, "interproc")
    expected = set()
    for name in sorted(os.listdir(pkg)):
        if name.endswith(".py"):
            for rule, line in expected_findings(os.path.join(pkg, name)):
                expected.add((rule, name, line))
    got = {(f.rule, os.path.basename(f.path), f.line)
           for f in run_analysis([pkg], fixture_config())}
    assert got == expected
    assert {"TT303", "TT304", "TT305", "TT306"} <= {r for r, _, _ in got}
    assert all(name == "loop.py" for _, name, _ in got)


def test_every_rule_has_a_fixture():
    """The 26 ids of JAX's registry, none dropped: each fires somewhere
    in the port's fixtures."""
    fired = set()
    for fixture in PORT_FIXTURES:
        fired |= {r for r, _ in expected_findings(
            os.path.join(FIXTURES, fixture))}
    fired |= {r for r, _ in expected_findings(
        os.path.join(FIXTURES, "interproc", "loop.py"))}
    assert fired == set(ALL_RULES)


# ---------------------------------------------------------------- vs JAX

# lines of JAX's fixtures whose sink has no torch meaning, so the port's
# rule does not fire there: (fixture, rule, line) -> why
JAX_ONLY = {
    ("viol_edit.py", "TT309", 37): "inside @jax.jit: no torch "
                                   "counterpart of the trace wrapper",
    ("viol_edit.py", "TT309", 43): "inside @partial(jax.jit): as above",
    ("viol_flight.py", "TT606", 27): "inside @jax.jit: as above",
    ("viol_usage.py", "TT607", 18): "inside @jax.jit: as above",
    ("viol_fleet.py", "TT605", 24): "jax.block_until_ready: the port's "
                                    "waits are torch.cuda/.synchronize()",
    ("viol_quality.py", "TT604", 34): "lax.ppermute: a JAX collective",
    ("viol_quality.py", "TT604", 39): "lax psum: a JAX collective",
}
_COMPARED = {"TT309", "TT602", "TT604", "TT605", "TT606", "TT607",
             "TT608"}


def _jax_config():
    from timetabling_ga_tpu.analysis.config import load_config as jax_load
    return _with_fixtures(jax_load(REPO))


@pytest.mark.parametrize("fixture", [
    "viol_edit.py", "viol_obs_http.py", "viol_quality.py",
    "viol_fleet.py", "viol_gw_api.py", "viol_flight.py", "viol_usage.py",
    "viol_scale.py", "clean.py"])
def test_handler_rules_agree_with_jax(fixture):
    """On JAX's fixtures, the port's TT309/TT602/TT604-TT608 findings
    equal JAX's (rule, line, col), but for the JAX_ONLY lines."""
    from timetabling_ga_tpu.analysis import run_analysis as jax_run
    path = os.path.join(JAX_FIXTURES, fixture)
    jax = {(f.rule, f.line, f.col) for f in jax_run([path], _jax_config())
           if f.rule in _COMPARED}
    port = {(f.rule, f.line, f.col)
            for f in run_analysis([path], _with_fixtures(load_config(REPO)))
            if f.rule in _COMPARED}
    only = {(r, ln, c) for r, ln, c in jax
            if (fixture, r, ln) in JAX_ONLY}
    assert len(only) == sum(1 for k in JAX_ONLY if k[0] == fixture)
    assert port == jax - only
    if fixture != "clean.py":
        assert port


def test_sarif_matches_jax_golden():
    """The port's SARIF writer, given JAX's findings and rule docs for
    viol_api.py, reproduces JAX's golden file but for the tool's name."""
    from timetabling_ga_tpu.analysis import _rule_docs as jax_docs
    from timetabling_ga_tpu.analysis import run_analysis as jax_run
    from timetabling_ga_tpu.analysis.config import load_config as jax_load
    cfg = jax_load(REPO)
    cfg.root = REPO
    findings = [Finding(f.rule, f.path, f.line, f.col, f.message)
                for f in jax_run([os.path.join(JAX_FIXTURES, "viol_api.py")],
                                 cfg)]
    assert findings
    got = to_sarif(findings, jax_docs())
    assert got["runs"][0]["tool"]["driver"]["name"] == "tt-analyze-torch"
    got["runs"][0]["tool"]["driver"]["name"] = "tt-analyze"
    with open(os.path.join(JAX_FIXTURES, "sarif_golden.json"),
              encoding="utf-8") as f:
        assert json.dumps(got, indent=2, sort_keys=True) + "\n" == f.read()


@pytest.mark.parametrize("src", [
    "x = 1  # tt-analyze: ignore[TT301]\n",
    "# tt-analyze: ignore\ny = 2\nz = 3\n",
    "x = 1  # tt-analyze: ignore[TT301, TT401]\n",
    "# tt-analyze: ignore[TT202] the key is the name\nx = load(n, p)\n",
    "# a comment\n# tt-analyze: ignore[TT303]\nt.cpu()\n",
    "x = 1  #tt-analyze:ignore[TT501]\n",
    '"""prose mentioning # tt-analyze: ignore is not a marker"""\n',
    "x = 1  # tt-analyze: ignored\n",
    "y = f(x)  # noqa  # tt-analyze: ignore[TT101]\n",
    "def f(:\n  # tt-analyze: ignore\n",
])
def test_suppression_parser_agrees_with_jax(src):
    from timetabling_ga_tpu.analysis.core import suppressions as jax_supp
    assert suppressions(src) == jax_supp(src)


# ------------------------------------------------------------ the tree

def test_port_tree_is_strict_clean():
    """`--strict --warn-unused-ignores` over the port's package stays at
    zero findings (every deliberate site suppressed with its reason)."""
    cfg = load_config(REPO)
    cfg.root = REPO
    cfg.warn_unused_ignores = True
    findings = run_analysis(["timetabling_ga_tpu_torch"], cfg)
    assert findings == [], "\n".join(f.render() for f in findings)


def _own_nodes(fn):
    """The nodes of `fn`'s body, not those of the defs nested in it."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
            todo.extend(ast.iter_child_nodes(node))


def _ops_programs():
    """(rel path, function node, TT101's checker after its run) of every
    device program of ops/ (lambdas aside)."""
    from timetabling_ga_tpu_torch.analysis import _Context
    from timetabling_ga_tpu_torch.analysis import rules_trace
    from timetabling_ga_tpu_torch.analysis.project import (
        project_of, torch_aliases)

    cfg = load_config(REPO)
    ctx = _Context(cfg)
    pkg = os.path.join(REPO, "timetabling_ga_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in sorted(files):
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path, encoding="utf-8") as f:
                    src = f.read()
                rel = os.path.relpath(path, REPO)
                ctx.sources.append((path, rel, ast.parse(src), src))
    for _, rel, tree, src in ctx.sources:
        if "/ops/" not in rel:
            continue
        proj = project_of(ctx, tree, src, rel)
        names = torch_aliases(tree)
        for fn in rules_trace._collect_targets(tree, rel, ctx):
            if isinstance(fn, ast.Lambda):
                continue
            checker = rules_trace._TaintChecker(fn, rel, [], names, proj)
            checker.run()
            yield rel, fn, checker


# the device programs of ops/ with an if/while/assert/for/and/or in
# which TT101 knows no tensor: host helpers of launch shapes and draws
_OPS_HOST_ONLY = {
    "ga.py:draws", "ga.py:ls_draws_fn", "moves.py:relocate_stage",
    "rooms.py:check_packing", "fitness.py:penalty_cluster_size",
    "sweep.py:sweep_shape", "sweep.py:_coprimes_on",
    "sweep.py:cluster_size", "nsga.py:_check_rows",
}
# explicit reads (`.item()`/`.tolist()`/`bool(t)`...) in the loops of
# ops/: TT101 exempts them and TT301 audits dispatch modules only
_OPS_LOOP_READS = {"nsga.py:nondominated_ranks",
                   "sweep.py:sweep_local_search"}


def test_tt101_sees_the_tensors_of_ops():
    """ops/ annotates few parameters; TT101 still knows a tensor in
    every device program of ops/ that makes a Python decision, but for
    the named host helpers. The explicit reads in ops/ loops, which no
    rule judges, are the two named."""
    judged, blind, reads = 0, set(), set()
    for rel, fn, checker in _ops_programs():
        nodes = list(_own_nodes(fn))
        where = f"{os.path.basename(rel)}:{fn.name}"
        if any(isinstance(n, (ast.If, ast.While, ast.Assert, ast.For,
                              ast.BoolOp)) for n in nodes):
            if any(isinstance(n, ast.expr) and checker.is_tainted(n)
                   for n in nodes):
                judged += 1
            else:
                blind.add(where)
        for loop in nodes:
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for n in ast.walk(loop):
                if not isinstance(n, ast.Call):
                    continue
                f = n.func
                if ((isinstance(f, ast.Attribute)
                     and f.attr in ("item", "tolist", "cpu", "numpy")
                     and checker.is_tainted(f.value))
                        or (isinstance(f, ast.Name)
                            and f.id in ("int", "float", "bool")
                            and n.args and checker.is_tainted(n.args[0]))):
                    reads.add(where)
    assert blind <= _OPS_HOST_ONLY, sorted(blind - _OPS_HOST_ONLY)
    assert judged >= 69
    assert reads == _OPS_LOOP_READS


@pytest.mark.parametrize("src, tensors", [
    ("def f(x):\n    return x.sum()", {"x"}),
    ("def f(x, k=3):\n    return x[..., None] * k", {"x"}),
    ("def f(x, y):\n    return torch.where(x, y, 0)", {"x"}),
    ("def f(pa):\n    return pa.n_slots + pa.conflict.sum()", set()),
    ("def f(n, x):\n    return [x.view(-1) for _ in range(n)]", {"x"}),
    ("def f(x):\n    return x.shape[0] + len(range(x))", set()),
])
def test_param_evidence(src, tensors):
    """An unannotated parameter is a tensor by its own use, and a host
    value once used as one (another attribute, a `range` bound)."""
    from timetabling_ga_tpu_torch.analysis.project import param_evidence

    fn = ast.parse(src).body[0]
    _, pos, neg = param_evidence(fn, {"torch"})
    assert pos - neg == tensors


_BLOCKED_RUN = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "jaxlib",
                                  "timetabling_ga_tpu", "triton"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
from timetabling_ga_tpu_torch.analysis import main
rc = main(["--strict", "--warn-unused-ignores", "--root", sys.argv[1],
           "timetabling_ga_tpu_torch"])
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "timetabling_ga_tpu"))
print("LEAKED", leaked)
sys.exit(rc if not leaked else 3)
"""


def test_strict_run_with_torch_and_jax_blocked():
    """The analyzer imports none of torch, JAX or the JAX package: with
    all three blocked the strict run over the port exits 0, and the JAX
    package never enters sys.modules."""
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, REPO],
                       capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


def test_cli_exit_codes_json_and_list_rules():
    base = [sys.executable, "-m", "timetabling_ga_tpu_torch.analysis",
            "--root", REPO]
    r = subprocess.run(base + ["--list-rules"], capture_output=True,
                       text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0
    ids = [line.split()[0] for line in r.stdout.splitlines()]
    from timetabling_ga_tpu.analysis import _rule_modules as jax_rules
    assert ids == sorted(jax_rules()) == sorted(ALL_RULES)

    viol = os.path.join(FIXTURES, "viol_api.py")
    r = subprocess.run(base + ["--strict", "--json", viol],
                       capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert r.returncode == 1
    report = json.loads(r.stdout)
    assert report["count"] == len(report["findings"]) > 0
    assert {f["rule"] for f in report["findings"]} == {"TT501"}
    assert report["timing"]["per_rule_s"]

    r = subprocess.run(base + [viol], capture_output=True, text=True,
                       cwd=REPO, timeout=120)
    assert r.returncode == 0 and "TT501" in r.stdout

    r = subprocess.run(base + ["--strict", "--sarif", viol],
                       capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert r.returncode == 1
    assert json.loads(r.stdout)["runs"][0]["results"]


def test_each_violation_fixture_fails_strict():
    """Every viol_*.py fixture carries at least one finding under the
    default config too (no fixture scopes added), so `--strict` over it
    exits 1."""
    cfg = load_config(REPO)
    cfg.root = REPO
    for fixture in sorted(os.listdir(FIXTURES)):
        if fixture.startswith("viol_"):
            assert run_analysis([os.path.join(FIXTURES, fixture)], cfg), \
                fixture


def test_rules_filter_and_registry():
    assert set(_rule_modules()) == set(ALL_RULES) == set(RULE_DOCS)
    cfg = fixture_config()
    cfg.rules = ["TT401"]
    assert run_analysis([os.path.join(FIXTURES, "viol_api.py")], cfg) == []


def test_warn_unused_ignores(tmp_path):
    """A marker that suppresses nothing is TT901; the used marker in
    viol_api.py stays silent."""
    cfg = fixture_config()
    cfg.warn_unused_ignores = True
    findings = run_analysis([os.path.join(FIXTURES, "viol_api.py")], cfg)
    assert not any(f.rule == "TT901" for f in findings)
    stale = tmp_path / "stale.py"
    stale.write_text("x = 1  # tt-analyze: ignore[TT301]\n",
                     encoding="utf-8")
    assert [(f.rule, f.line) for f in run_analysis([str(stale)], cfg)] \
        == [("TT901", 1)]


# ------------------------------------------------------------ config

def test_config_reads_only_its_own_section(tmp_path):
    """The settings are the port's own: neither JAX's
    `[tool.tt-analyze]` nor any other pyproject.toml section changes
    them."""
    assert load_config(REPO).paths == ["timetabling_ga_tpu_torch"]
    (tmp_path / "pyproject.toml").write_text(
        '[tool.tt-analyze]\npaths = ["timetabling_ga_tpu"]\n'
        '[tool.tt-analyze-torch]\npaths = ["pkg"]\n', encoding="utf-8")
    cfg = load_config(str(tmp_path))
    assert cfg == AnalyzerConfig(root=str(tmp_path))
    assert cfg.paths == ["timetabling_ga_tpu_torch"]


def test_compat_table_and_phases_load_by_ast():
    cfg = load_config(REPO)
    cfg.root = REPO
    table = load_compat_table(cfg)
    assert table["torch"] == ["*"]
    assert "TCPStore" in table["torch.distributed"]
    assert "tt.fitness" in load_phases(cfg)


def test_compat_table_resolves_on_installed_torch():
    """Every TORCH_COMPAT_TABLE entry resolves on this PyTorch (the
    card's is checked by chip_smoke.py's analyze phase)."""
    import importlib
    from timetabling_ga_tpu_torch.compat import TORCH_COMPAT_TABLE

    def resolve(path):
        parts = path.split(".")
        for i in range(len(parts), 0, -1):
            try:
                obj = importlib.import_module(".".join(parts[:i]))
                break
            except ImportError:
                continue
        for p in parts[i:]:
            obj = getattr(obj, p)
        return obj

    for key, names in TORCH_COMPAT_TABLE.items():
        obj = resolve(key)
        for name in names:
            if name != "*":
                assert hasattr(obj, name), f"{key}.{name}"
