"""TT602 — blocking I/O / registry mutation in HTTP handler paths.

The tt-obs pull front (obs/http.py) has one contract: a scrape is a
PURE OBSERVER of the run it lands on. Its handlers only read registry
snapshots/expositions and only write their own response socket. Two
classes of code break that:

  - MetricsRegistry mutation — counter bumps, gauge writes, histogram
    observes, and the get-or-create accessors themselves (`counter()` /
    `gauge()` / `gauge_fn()` / `histogram()` CREATE an instrument when
    the name is new). A scrape that mutates the registry changes the
    numbers every other consumer (metricsEntry snapshots, `tt serve`
    stats, the next scrape) reads, and a scrape storm contends the one
    registry lock the dispatch path takes for its own updates.
  - blocking I/O beyond the response socket — `open()`, `time.sleep`,
    subprocess spawns, outbound sockets/HTTP. Handler threads are
    daemons the server never joins; a handler that blocks on foreign
    I/O turns "the listener can never stall the run" from a design
    rule into a hope.

Scope: classes that look like HTTP handlers — a base named
`*HTTPRequestHandler`, or any `do_*` method (the `http.server` routing
convention, so duck-typed handlers are covered too) — plus everything
reachable from their methods within the module (`self.helper()` calls
and bare-name calls to module functions), PLUS classes whose name ends
with a configured `handler-api-suffixes` entry (default `Api`): the
fleet fronts route every request into an enqueue-or-read-only `api`
object (`self.server.api.accept_solve(...)` — fleet/gateway.py
GatewayApi, fleet/replicas.py ReplicaApi), whose methods run ON the
handler thread but in a class the do_* heuristic cannot see, often in
a different module from the handler. Cross-module calls are otherwise
out of scope: the rule guards the handler modules themselves, and the
registry's own module is exempt (it IS the lock-holding implementation
the rule keeps handlers out of).

Reads stay allowed: `snapshot()`, `to_prometheus()`,
`to_openmetrics()`, and `self.wfile.write(...)` are exactly what a
handler is for.
"""

from __future__ import annotations

import ast
import re

from timetabling_ga_tpu_torch.analysis.core import Finding, qual_matches, qualname

RULE = "TT602"

# receiver shapes that mean "the metrics registry": REGISTRY,
# obs_metrics.REGISTRY, self.server.registry, self._metrics, ...
_REGISTRY_RECV = re.compile(r"(^|\.)_?(registry|metrics)$", re.IGNORECASE)

# get-or-create accessors and direct registry mutators: every one of
# these writes registry state (accessors create instruments)
_REGISTRY_MUTATORS = {"counter", "gauge", "gauge_fn", "histogram",
                      "freeze", "reset"}

# blocking calls a handler thread must not make (tail-matched)
_BLOCKING_CALLEES = {
    "time.sleep", "sleep",
    "subprocess.run", "subprocess.Popen", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
    "os.system", "os.popen", "os.wait", "os.waitpid",
    "socket.create_connection",
    "urllib.request.urlopen", "urlopen",
    "requests.get", "requests.post", "requests.request",
}

# modules exempt from the scan: the registry implementation itself
# (its methods legitimately touch instruments under the lock)
_EXEMPT_SUFFIXES = ("obs/metrics.py",)


def _is_handler_class(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        qn = qualname(base)
        if qn is not None and qn.split(".")[-1].endswith(
                "HTTPRequestHandler"):
            return True
    return any(isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
               and n.name.startswith("do_") for n in cls.body)


def _reachable(tree: ast.Module, api_suffixes: tuple = ()
               ) -> list[tuple[str, ast.AST]]:
    """Handler-reachable function bodies: every method of a handler
    class — and of any class named `*<api_suffix>` (the fleet fronts'
    enqueue-or-read-only api objects, called as `self.server.api.x()`
    from handler threads) — plus (transitively, intra-module)
    same-class methods called as `self.x(...)` and module functions
    called by bare name."""
    mod_funcs = {n.name: n for n in tree.body
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    work: list[tuple[str, str, ast.AST]] = []   # (owner, name, node)
    classes: dict[str, dict[str, ast.AST]] = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        methods = {n.name: n for n in node.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        classes[node.name] = methods
        if _is_handler_class(node) or any(
                node.name.endswith(sfx) for sfx in api_suffixes
                if sfx):
            for name, fn in methods.items():
                work.append((node.name, name, fn))
    seen: set[tuple[str, str]] = {(o, n) for o, n, _ in work}
    out: list[tuple[str, ast.AST]] = []
    while work:
        owner, name, fn = work.pop()
        out.append((f"{owner}.{name}" if owner else name, fn))
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self" and owner
                    and f.attr in classes.get(owner, {})):
                key = (owner, f.attr)
                if key not in seen:
                    seen.add(key)
                    work.append((owner, f.attr,
                                 classes[owner][f.attr]))
            elif isinstance(f, ast.Name) and f.id in mod_funcs:
                key = ("", f.id)
                if key not in seen:
                    seen.add(key)
                    work.append(("", f.id, mod_funcs[f.id]))
    return out


def check(tree: ast.Module, src: str, path: str, ctx) -> list[Finding]:
    if path.replace("\\", "/").endswith(_EXEMPT_SUFFIXES):
        return []
    suffixes = tuple(getattr(ctx.config, "handler_api_suffixes",
                             ("Api",)))
    findings: list[Finding] = []
    for where, fn in _reachable(tree, suffixes):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and f.attr in _REGISTRY_MUTATORS
                    and (qn_recv := qualname(f.value)) is not None
                    and _REGISTRY_RECV.search(qn_recv)):
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"registry write `{qn_recv}.{f.attr}(...)` on the "
                    f"HTTP handler path `{where}` — handlers must only "
                    f"READ snapshots/expositions: get-or-create and "
                    f"mutation change the numbers every other consumer "
                    f"reads and contend the dispatch path's registry "
                    f"lock (obs/http.py design rules)"))
                continue
            qn = qualname(f)
            if qual_matches(qn, _BLOCKING_CALLEES) or (
                    isinstance(f, ast.Name) and f.id == "open"):
                findings.append(Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"blocking call `{qn or 'open'}` on the HTTP "
                    f"handler path `{where}` — handlers may only block "
                    f"on their own response socket; foreign I/O on a "
                    f"scrape thread is how a listener learns to stall "
                    f"the run it observes (obs/http.py design rules)"))
    return findings
