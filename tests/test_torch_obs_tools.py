"""The port's offline readers of a record stream — `trace`, `stats`,
`quality` and `usage` (timetabling_ga_tpu_torch/obs/trace_export.py,
logstats.py, quality.py, usage.py) — against the JAX package's.

On the same logs both packages' readers print the same bytes (and
`trace` writes the same Chrome JSON): a JAX --obs engine log and serve
log, the port's of each (the engine with --quality, the serve path
metered, with tenants), and one of them with a torn tail line. `usage`
also reads a live front's /v1/usage (a local HTTP server here). The
port's readers run with torch and JAX blocked from import, as the JAX
package's run without JAX (tests/test_obs.py
test_tt_trace_and_stats_work_without_jax), and `python -m
timetabling_ga_tpu_torch <reader>` reaches them.
"""

import contextlib
import http.server
import io
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from timetabling_ga_tpu import cli as jcli
from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.runtime.config import RunConfig as JRunConfig
from timetabling_ga_tpu.runtime.config import ServeConfig as JServeConfig
from timetabling_ga_tpu_torch import cli as tcli
from timetabling_ga_tpu_torch.runtime.config import RunConfig as TRunConfig
from timetabling_ga_tpu_torch.runtime.config import (
    ServeConfig as TServeConfig)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_usage.py's 12-event problem
_PA = random_instance(71, n_events=12, n_rooms=3, n_features=2,
                      n_students=8, attend_prob=0.2)
_ENGINE = dict(seed=3, pop_size=8, islands=2, generations=20,
               migration_period=10, max_steps=8, time_limit=300,
               backend="cpu", auto_tune=False, trace=True, obs=True,
               metrics_every=1, quality=True)
_SERVE = dict(backend="cpu", lanes=2, quantum=5, pop_size=4, max_steps=8,
              obs=True, metrics_every=1, quality=True)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """{name: path}: each package's --obs engine and serve logs, and the
    port's serve log with its last line torn in half."""
    from timetabling_ga_tpu.runtime import engine as jengine
    from timetabling_ga_tpu.serve.service import serve_stream as jserve
    from timetabling_ga_tpu_torch.runtime import engine as tengine
    from timetabling_ga_tpu_torch.serve.service import (
        serve_stream as tserve)
    tmp = tmp_path_factory.mktemp("obs_tools")
    tim = tmp / "pa.tim"
    tim.write_text(dump_tim(_PA))
    reqs = [{"submit": {"id": "a", "instance": str(tim), "seed": 3,
                        "generations": 10, "tenant": "acme"}},
            {"submit": {"id": "b", "instance": str(tim), "seed": 4,
                        "generations": 5, "tenant": "zeta"}},
            {"drain": True}, {"stats": True}]
    text = "\n".join(json.dumps(r) for r in reqs) + "\n"
    out = {}
    for name, eng, cls in (("jax-engine", jengine, JRunConfig),
                           ("port-engine", tengine, TRunConfig)):
        path = tmp / f"{name}.jsonl"
        with open(path, "w") as fh:
            eng.run(cls(**dict(_ENGINE, input=str(tim))), out=fh)
        out[name] = str(path)
    for name, serve, cfg in (
            ("jax-serve", jserve, JServeConfig(**_SERVE, mesh_devices=1)),
            ("port-serve", tserve, TServeConfig(**_SERVE))):
        path = tmp / f"{name}.jsonl"
        with open(path, "w") as fh:
            serve(cfg, io.StringIO(text), fh)
        out[name] = str(path)
    data = open(out["port-serve"]).read()
    torn = tmp / "torn.jsonl"
    torn.write_text(data + data.splitlines()[-1][:17])
    out["torn"] = str(torn)
    return out


def _run(main, argv):
    """(return code, stdout, stderr) of a reader's entry point."""
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = main(argv)
    return rc, so.getvalue(), se.getvalue()


_LOGS = ["jax-engine", "port-engine", "jax-serve", "port-serve", "torn"]


@pytest.mark.parametrize("log", _LOGS)
@pytest.mark.parametrize("reader", ["stats", "quality", "usage",
                                    "usage-json"])
def test_reader_prints_jax_bytes(reader, log, logs):
    """stats, quality and usage (text, and --json for one tenant) print
    what JAX's print."""
    argv = [logs[log]]
    if reader == "usage-json":
        reader, argv = "usage", argv + ["--json", "--tenant", "acme"]
    got = _run(tcli.main, [reader] + argv)
    want = _run(jcli.main, [reader] + argv)
    assert got == want
    assert got[0] == 0 and got[1]


@pytest.mark.parametrize("log", _LOGS)
@pytest.mark.parametrize("job", [None, "a"])
def test_trace_writes_jax_bytes(job, log, logs, tmp_path):
    """trace writes the same Chrome trace-event JSON as JAX's (and says
    the same on stderr); --job filters one job's timeline."""
    dest = str(tmp_path / "trace.json")
    argv = ["trace", logs[log], "-o", dest] + (
        ["--job", job] if job else [])
    got = _run(tcli.main, argv)
    with open(dest, "rb") as fh:
        got_doc = fh.read()
    want = _run(jcli.main, argv)
    with open(dest, "rb") as fh:
        want_doc = fh.read()
    assert got == want and got[0] == 0
    assert got_doc == want_doc
    doc = json.loads(got_doc)
    spans = sum(1 for line in open(logs[log])
                if line.startswith('{"spanEntry"'))
    # one complete event a span (the phase and compile lanes aside)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"
          and e["cat"] not in ("phase", "compile")]
    if job is None and log != "torn":
        assert len(xs) == spans


def test_stitched_trace_and_stats_equal_jax(logs, tmp_path):
    """Several logs at once: one process lane each (trace), one report
    (stats)."""
    dest = str(tmp_path / "all.json")
    inputs = [logs["jax-serve"], logs["port-serve"], logs["port-engine"]]
    got = _run(tcli.main, ["trace", *inputs, "-o", dest])
    got_doc = open(dest).read()
    want = _run(jcli.main, ["trace", *inputs, "-o", dest])
    assert got == want and got_doc == open(dest).read()
    assert _run(tcli.main, ["stats", *inputs]) == _run(
        jcli.main, ["stats", *inputs])


@pytest.mark.parametrize("sub", ["trace", "stats", "quality", "usage",
                                 "incident", "scale"])
def test_reader_help_and_refusals_equal_jax(sub):
    """The reader subcommands are served (no longer refused): -h prints
    JAX's help, no input stops with JAX's message."""
    assert _run(tcli.main, [sub, "-h"]) == _run(jcli.main, [sub, "-h"])
    with pytest.raises(SystemExit) as got:
        tcli.main([sub])
    with pytest.raises(SystemExit) as want:
        jcli.main([sub])
    assert str(got.value) == str(want.value)
    assert sub not in tcli.NOT_PORTED_SUBCOMMANDS


@contextlib.contextmanager
def _usage_front(payload):
    """A local HTTP server answering GET /v1/usage with `payload`."""
    body = json.dumps(payload).encode()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            code = 200 if self.path == "/v1/usage" else 404
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            if code == 200:
                self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


def test_usage_reads_a_live_front_like_jax(logs):
    """`usage <URL>` reads <URL>/v1/usage with the standard library and
    renders it as JAX's does; --json passes it through."""
    from timetabling_ga_tpu_torch.obs import usage as tusage
    from timetabling_ga_tpu_torch.obs.trace_export import read_jsonl
    report = tusage.fold_entries(read_jsonl(logs["port-serve"]))
    report["replicas"] = {"r0": {"dead": False, "scraped": True,
                                 "tenants": ["acme"]}}
    with _usage_front(report) as url:
        for extra in ([], ["--tenant", "zeta"], ["--json"]):
            got = _run(tcli.main, ["usage", url + "/"] + extra)
            want = _run(jcli.main, ["usage", url + "/"] + extra)
            assert got == want and got[0] == 0
        assert "== replicas (1)" in got[1] or extra == ["--json"]


_BLOCKER = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        for mod in ("torch", "jax", "numpy", "timetabling_ga_tpu."):
            if name == mod.rstrip(".") or name.startswith(mod.rstrip(".")
                                                          + "."):
                raise ImportError("BLOCKED import of " + name)
sys.meta_path.insert(0, _Block())
from timetabling_ga_tpu_torch.cli import main
log, out = sys.argv[1], sys.argv[2]
assert main(["trace", log, "-o", out]) == 0
assert main(["stats", log]) == 0
assert main(["quality", log]) == 0
assert main(["usage", log]) == 0
assert "torch" not in sys.modules
"""


def test_readers_load_no_torch(logs, tmp_path):
    """The four readers run with torch, numpy, JAX and the JAX package
    blocked from import: nothing above cli.main's dispatch loads them."""
    out = str(tmp_path / "t.json")
    r = subprocess.run([sys.executable, "-c", _BLOCKER, logs["port-serve"],
                        out], capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "== usage by tenant" in r.stdout
    with open(out) as fh:
        assert json.load(fh)["traceEvents"]


def test_module_entry_point_runs_a_reader(logs):
    """`python -m timetabling_ga_tpu_torch stats <log>`."""
    r = subprocess.run([sys.executable, "-m", "timetabling_ga_tpu_torch",
                        "stats", logs["port-engine"]], capture_output=True,
                       text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "== record stream" in r.stdout
