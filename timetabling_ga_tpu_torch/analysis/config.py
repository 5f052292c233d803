"""Analyzer configuration of the port's tt-analyze: the settings for
the port's tree, and the two literals the rules read from the port's
own sources by AST: the pinned torch surface (`TORCH_COMPAT_TABLE`,
compat.py) and the phase-scope registry (`PHASES`, obs/prof.py).
Nothing is imported from the scanned package.

The settings are JAX's `[tool.tt-analyze]` (pyproject.toml), mapped to
the port's names. That section configures JAX's scan of
timetabling_ga_tpu and is not read here; no file overrides these
settings (a caller sets fields on the object).
"""

from __future__ import annotations

import ast
import dataclasses
import os

ALL_RULES = ("TT101", "TT102", "TT201", "TT202", "TT203", "TT301",
             "TT302", "TT303", "TT304", "TT305", "TT306", "TT307",
             "TT309", "TT310", "TT401", "TT402", "TT501", "TT502",
             "TT601", "TT602", "TT603", "TT604", "TT605", "TT606",
             "TT607", "TT608")

# the directory holding the timetabling_ga_tpu_torch package
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass
class AnalyzerConfig:
    # default scan roots when the CLI gives no paths
    paths: list[str] = dataclasses.field(
        default_factory=lambda: ["timetabling_ga_tpu_torch"])
    rules: list[str] = dataclasses.field(
        default_factory=lambda: list(ALL_RULES))
    # module (file) holding the TORCH_COMPAT_TABLE literal (TT501/TT502)
    compat_table: str = "timetabling_ga_tpu_torch/compat.py"
    # module (file) holding the PHASES registry literal (TT310)
    prof_module: str = "timetabling_ga_tpu_torch/obs/prof.py"
    # files whose host loops the sync rules audit for hidden device syncs
    # and fence-discipline breaks: TT301 locally, TT303/TT305
    # whole-program (path suffix match)
    dispatch_modules: list[str] = dataclasses.field(
        default_factory=lambda: ["runtime/engine.py",
                                 "parallel/islands.py",
                                 "runtime/dispatch_core.py",
                                 "serve/scheduler.py",
                                 "fleet/replicas.py"])
    # sanctioned device->host readback helpers: calling one is THE sync
    # point (and clears device taint), and their bodies are exempt
    # (runtime/dispatch_core.py fetch*, HostCopy.wait, _to_host)
    sync_helpers: list[str] = dataclasses.field(
        default_factory=lambda: ["fetch", "fetch_leaf", "fetch_state",
                                 "fetch_final", "wait", "_to_host"])
    # paths (substring match) whose code runs inside an island program
    # on a local shard: TT302 bans torch.distributed calls there
    sharded_modules: list[str] = dataclasses.field(
        default_factory=lambda: ["ops/", "parallel/"])
    # the one module of the sharded paths whose ProcessGroup carries
    # every collective the port makes (exempt from TT302)
    comm_modules: list[str] = dataclasses.field(
        default_factory=lambda: ["parallel/comm.py"])
    # paths (substring match) whose functions are device programs
    # (TT101/TT102/TT601/TT603/TT606/TT607 program scope), beside
    # the functions handed to a program factory and to torch's
    # transforms
    program_modules: list[str] = dataclasses.field(
        default_factory=lambda: ["ops/"])
    # factory-name patterns seeding the whole-program taint pass
    # (TT303/TT305, analysis/project.py): a function matching one
    # returns a dispatch program (runtime/dispatch_core.py program), and
    # calling its product in ANY module yields device values
    taint_sources: list[str] = dataclasses.field(
        default_factory=lambda: [r"^program$"])
    # function-name patterns of the device programs themselves
    # (parallel/islands.py mesh_*): their results are device values
    # (TT301's local seeds; summarized device-returning for TT303)
    device_programs: list[str] = dataclasses.field(
        default_factory=lambda: [r"^mesh_\w+$"])
    # host-forcing sinks TT301/TT303/TT306 flag on device values inside
    # dispatch loops: bare conversion calls, dotted calls (tail-matched)
    # and methods (`.x()`); `.to("cpu")` is a sink as well
    taint_sinks: list[str] = dataclasses.field(
        default_factory=lambda: ["float", "int", "bool", "np.asarray",
                                 "np.array", "item", "tolist", "cpu",
                                 "numpy"])
    # callables whose result is a non-blocking device->host copy whose
    # destination (`.host`) is valid only after its event (TT304)
    copy_factories: list[str] = dataclasses.field(
        default_factory=lambda: ["HostCopy", "host_copies"])
    # files (path suffix match) forming the tt-accord control side
    # channel: TT307 bans torch.distributed collectives and the comm
    # group's collectives there wholesale, alongside *Supervisor bodies
    accord_modules: list[str] = dataclasses.field(
        default_factory=lambda: ["runtime/control_channel.py"])
    # attribute names holding device-RESIDENT group state (TT306,
    # serve/scheduler.py `_resident`)
    resident_stores: list[str] = dataclasses.field(
        default_factory=lambda: ["_resident"])
    # park-fence helper function names: the sanctioned host-fetch sites
    # for resident-group state (exempt from TT306)
    fence_helpers: list[str] = dataclasses.field(
        default_factory=lambda: ["_flush_bucket", "_flush_job",
                                 "flush_resident"])
    # report stale `# tt-analyze: ignore[...]` markers (CLI
    # --warn-unused-ignores sets this)
    warn_unused_ignores: bool = False
    # module-level build/program cache dict names for TT202
    cache_name_pattern: str = r"^_?[A-Z0-9_]*(CACHES?|LIBS|PROGRAMS)$"
    # factory callees whose results get cached (TT202 key completeness):
    # kernel library loads, program proxies, make_* builders
    factory_pattern: str = r"^(make_\w+|load|instrument|build_\w+)$"
    # population-evaluation callees TT604 flags inside dispatch-loop
    # bodies (host-side per-generation quality recompute)
    quality_recompute_callees: list[str] = dataclasses.field(
        default_factory=lambda: ["batch_penalty", "evaluate",
                                 "event_heat"])
    # function-name pattern marking quality-reduction helpers (TT604
    # bans collectives and random draws inside them)
    quality_path_pattern: str = r"quality|hamming|div_stats|div_rows"
    # modules whose handler-reachable code TT605 audits for inline
    # device work and unbounded socket reads. serve/snapshot.py packs on
    # replica handler threads (the ?snapshot=1 export)
    fleet_modules: list[str] = dataclasses.field(
        default_factory=lambda: ["fleet/", "serve/snapshot.py"])
    # class-name suffixes the TT602/TT605 reachability walk treats as
    # handler-path roots beside handler classes (GatewayApi, ReplicaApi)
    handler_api_suffixes: list[str] = dataclasses.field(
        default_factory=lambda: ["Api"])
    # function-name pattern marking dispatcher-tick bodies (TT608)
    scale_tick_pattern: str = (r"^_dispatch_loop$|^_handle$|^_poll"
                               r"|^_tick|^_drain_tick$")

    root: str = "."


def load_config(root: str = ".") -> AnalyzerConfig:
    """The port's settings, with paths taken relative to `root`."""
    return AnalyzerConfig(root=root)


def _literal(path: str, root: str, name: str):
    """The literal value assigned to `name` in the module at `path`
    (relative to `root`, else to the checkout holding this package),
    read by AST; None when absent."""
    if not os.path.isabs(path):
        cands = [os.path.join(root, path), os.path.join(_CHECKOUT, path)]
        path = next((p for p in cands if os.path.exists(p)), cands[0])
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   and node.value is not None else [])
        for tgt in targets:
            if isinstance(tgt, ast.Name) and tgt.id == name:
                try:
                    return ast.literal_eval(node.value)
                except ValueError:
                    return None
    return None


def load_compat_table(cfg: AnalyzerConfig) -> dict[str, list[str]]:
    """TORCH_COMPAT_TABLE from the configured module, by AST."""
    return _literal(cfg.compat_table, cfg.root, "TORCH_COMPAT_TABLE") or {}


def load_phases(cfg: AnalyzerConfig) -> frozenset:
    """The PHASES registry from the configured module, by AST."""
    return frozenset(_literal(cfg.prof_module, cfg.root, "PHASES") or ())
