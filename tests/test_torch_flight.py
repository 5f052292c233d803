"""The port's flight recorder and the readers `incident`, `trace` (on
bundles) and `scale` (timetabling_ga_tpu_torch/obs/flight.py,
obs/trace_export.py, fleet/autoscaler.py) against the JAX package's.

  recorder  the same records through each package's tee and the same
            triggers at the same injected times give the same bundle
            files, by name, and the same bundle cores, every section
            compared (BUNDLE_CORE_EXEMPT lists the three that are not:
            `pid`, the wall-clock `unix_time` and `config`), in the
            scenarios of tests/test_flight.py: the rate limit and
            retention, the tee's rings and faultEntry trigger, a
            readiness flip, failed and refused dumps, and a peer
            stitch (a stub peers_fn: no port process has peers yet)
  config    config_fingerprint's values equal JAX's on every field both
            configs hold, but for FINGERPRINT_DIFFER
  readers   `incident` prints and writes what JAX's does on a bundle of
            each package's recorder, `trace` on a log and a bundle
            writes JAX's JSON, `scale` prints JAX's text; all of them,
            run as `python -m timetabling_ga_tpu_torch`, import no torch
"""

import contextlib
import io
import itertools
import json
import os
import subprocess
import sys
import time

import pytest

from timetabling_ga_tpu import cli as jcli
from timetabling_ga_tpu.fleet import autoscaler as jscaler
from timetabling_ga_tpu.obs import flight as jflight
from timetabling_ga_tpu.obs import history as jhistory
from timetabling_ga_tpu.obs import metrics as jmetrics
from timetabling_ga_tpu.runtime import config as jconfig
from timetabling_ga_tpu.runtime import faults as jfaults
from timetabling_ga_tpu_torch import cli as tcli
from timetabling_ga_tpu_torch.fleet import autoscaler as tscaler
from timetabling_ga_tpu_torch.obs import flight as tflight
from timetabling_ga_tpu_torch.obs import history as thistory
from timetabling_ga_tpu_torch.obs import metrics as tmetrics
from timetabling_ga_tpu_torch.runtime import config as tconfig
from timetabling_ga_tpu_torch.runtime import faults as tfaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PKGS = {"jax": (jflight, jhistory, jmetrics, jfaults, jconfig),
         "port": (tflight, thistory, tmetrics, tfaults, tconfig)}

# the bundle sections not compared between the packages: the process id
# (the same here, both recorders run in this process, but not a property
# of the recorder), the wall clock, and the config fingerprint (each
# package's own RunConfig; test_config_fingerprint_values_equal_jax
# compares its values)
BUNDLE_CORE_EXEMPT = ("pid", "unix_time", "config")

# config fields whose values differ by design: the default backend is
# JAX's "tpu" and the port's "gpu"
FINGERPRINT_DIFFER = ("backend",)


@pytest.fixture(autouse=True)
def _no_fault_plans():
    jfaults.install(None)
    tfaults.install(None)
    yield
    jfaults.install(None)
    tfaults.install(None)


def _run(main, argv):
    """(return code, stdout, stderr) of a reader's entry point."""
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = main(argv)
    return rc, so.getvalue(), se.getvalue()


# ------------------------------------------------------------- recorder

_SPAN = ('{"spanEntry":{"name":"%s","cat":"engine","ts":%s,"dur":0.1,'
         '"depth":0,"tid":0,"flow":7}}')
_LOG = '{"logEntry":{"procID":0,"threadID":0,"best":%d,"time":%s}}'
_FAULT = ('{"faultEntry":{"site":"%s","action":"recover","error":"x",'
          '"trial":0,"recovery":1,"level":0,"time":4.5}}')


def _scenario(pkg, name, tmp):
    """Drive package `pkg`'s recorder through scenario `name` on an
    injected clock in directory `tmp`; returns (the stream the tee
    passed on, [(poll result, latest core), ...] after each step)."""
    flight_mod, hist_mod, metrics_mod, faults_mod, config_mod = _PKGS[pkg]
    t = [100.0]
    reg = metrics_mod.MetricsRegistry()
    reg.gauge("g").set(1.0)
    ring = hist_mod.HistoryRing(registry=reg, every_s=1.0,
                                now=lambda: t[0])
    kw = dict(registry=reg, history=ring, min_interval_s=0.0,
              process="engine", now=lambda: t[0],
              config=config_mod.parse_args(["-i", "x.tim", "-s", "3"]))
    if name == "rate_limit_retention":
        kw.update(keep=2, min_interval_s=5.0)
    elif name == "tee_rings":
        kw.update(span_bytes=400, records_cap=3)
    elif name == "peers":
        kw.update(min_interval_s=60.0, peers_fn=lambda peers: [
            (p, {"process": "serve", "spans": [json.loads(
                _SPAN % ("quantum", 0.5))["spanEntry"]],
                 "records": [json.loads(_LOG % (3, 1.0))]}
             if p != "dead" else None,
             None if p != "dead" else "connection refused")
            for p in peers])
    rec = flight_mod.FlightRecorder(str(tmp), **kw)
    buf = io.StringIO()
    tee = rec.tee(buf)
    steps = []

    def step(flush=False):
        ring.sample_once()
        steps.append((rec.poll_once(flush=flush), rec.latest()))

    def feed(lines):
        for line in lines:
            tee.write(line + "\n")

    if name == "rate_limit_retention":
        rec.trigger("manual:one")
        step()
        t[0] += 1.0
        rec.trigger("manual:two")
        step()
        step()
        t[0] += 6.0
        step()
        for trig in ("manual:three", "manual:four"):
            t[0] += 6.0
            rec.trigger(trig)
            step()
        t[0] += 1.0
        rec.trigger("manual:five")
        step(flush=True)
    elif name == "tee_rings":
        feed([_LOG % (9, 1.0), _SPAN % ("dispatch", 0.1),
              _SPAN % ("fetch", 0.3), _SPAN % ("process", 0.4),
              _LOG % (8, 2.0), _LOG % (7, 3.0), "not json", "[1, 2]",
              _LOG % (6, 4.0)])
        tee.write(_FAULT % "dispatch")       # split across two writes
        t[0] += 0.5
        tee.write("\n" + _FAULT % "quantum" + "\n")
        step()
        t[0] += 1.0
        step()
    elif name == "readiness_flip":
        step()
        reg.gauge("serve.backlog").set(4.0)
        reg.gauge("serve.queue_depth").set(4.0)
        t[0] += 1.0
        step()
        t[0] += 1.0
        step()
        reg.gauge("serve.queue_depth").set(0.0)
        step()
        reg.gauge("serve.queue_depth").set(9.0)
        reg.gauge("engine.stalled").set(1.0)
        t[0] += 1.0
        step()
    elif name == "dump_faults":
        faults_mod.install("flight_dump:1:error,flight_dump:3:die")
        rec.trigger("manual:a")
        step()                       # the dump fails: requeued
        t[0] += 1.0
        step()                       # the retry dumps
        rec.trigger("manual:b")
        step()                       # died: no bundle, thread would exit
        faults_mod.install(None)
    elif name == "peers":
        feed([_SPAN % ("route", 0.2), _LOG % (5, 1.0)])
        rec.trigger("manual:first")
        step()
        t[0] += 1.0
        rec.trigger("failover:r0", peers=("r0", "dead"))
        rec.trigger("reason:slo_burn", peers=("r1", "r0"))
        step()
    return buf.getvalue(), steps


def _files(tmp):
    return sorted(os.listdir(tmp))


def _core(core):
    return (None if core is None else
            {k: v for k, v in core.items() if k not in BUNDLE_CORE_EXEMPT})


_SCENARIOS = ["rate_limit_retention", "tee_rings", "readiness_flip",
              "dump_faults", "peers"]


@pytest.mark.parametrize("name", _SCENARIOS)
def test_recorder_bundles_equal_jax(name, tmp_path, monkeypatch):
    """The same bundle files, by name, and the same cores (the exempt
    sections aside), step by step and on disk."""
    out = {}
    for pkg in ("jax", "port"):
        flight_mod = _PKGS[pkg][0]
        # the recorder ordinal in the file names: each package's first
        monkeypatch.setattr(flight_mod, "_RECORDER_IDS",
                            itertools.count(1))
        d = tmp_path / pkg
        stream, steps = _scenario(pkg, name, d)
        disk = {f: flight_mod.load_bundle(str(d / f)) for f in _files(d)}
        out[pkg] = (stream, [(ok, _core(c)) for ok, c in steps],
                    {f: _core(c) for f, c in disk.items()},
                    [os.path.basename(p)
                     for p in flight_mod.list_bundles(str(d))])
        for c in disk.values():
            assert set(BUNDLE_CORE_EXEMPT) <= set(c)
    assert out["port"] == out["jax"]
    stream, steps, disk, listed = out["port"]
    assert disk, name
    if name == "rate_limit_retention":
        assert len(disk) == 2                    # keep=2
        assert [c["trigger"] for c in disk.values()] == [
            "manual:four", "manual:five"]
    if name == "tee_rings":
        core = steps[0][1]
        assert core["trigger"] == "fault:dispatch/recover"
        assert len(core["records"]) == 3 and core["records_dropped"] == 3
        assert len(core["spans"]) + core["spans_dropped"] == 3
    if name == "peers":
        core = steps[-1][1]
        assert core["stitched"] and core["trigger"] == "failover:r0"
        assert [p["label"] for p in core["peers"]] == ["r0", "dead", "r1"]
        assert core["trace"]["traceEvents"]


def test_recorder_thread_dumps_and_closes(tmp_path):
    """start() polls on the recorder's own thread: a faultEntry through
    the tee dumps a bundle there; close() joins the thread, and a trigger
    left pending at close gets its bundle in the final flush."""
    reg = tmetrics.MetricsRegistry()
    rec = tflight.FlightRecorder(str(tmp_path), registry=reg,
                                 min_interval_s=60.0,
                                 poll_every=0.02).start()
    try:
        tee = rec.tee(io.StringIO())
        tee.write(_FAULT % "dispatch" + "\n")
        for _ in range(1000):
            if rec.latest() is not None:
                break
            time.sleep(0.02)
        assert rec.latest()["trigger"] == "fault:dispatch/recover"
        rec.trigger("manual:late")               # inside min_interval
    finally:
        rec.close()
    assert not rec.alive()
    assert rec.latest()["trigger"] == "manual:late"
    assert len(tflight.list_bundles(str(tmp_path))) == 2


def test_wire_builds_what_the_flags_ask(tmp_path):
    """wire(): no ring and no recorder with every surface off; the ring
    under --obs, --obs-listen or --incident-dir (and not with
    --history-every 0); the recorder and its tee under --incident-dir —
    as JAX's wire builds them."""
    cases = [[], ["--obs"], ["--obs-listen", "127.0.0.1:0"],
             ["--incident-dir", str(tmp_path / "i")],
             ["--obs", "--history-every", "0"],
             ["--incident-dir", str(tmp_path / "j"), "--history-every",
              "0"]]
    for argv in cases:
        shapes = []
        for flight_mod, _, _, _, config_mod in (_PKGS["jax"],
                                                _PKGS["port"]):
            cfg = config_mod.parse_args(["-i", "x.tim"] + argv)
            out = io.StringIO()
            hist, rec, sink = flight_mod.wire(cfg, out, process="engine")
            try:
                shapes.append((hist is not None, rec is not None,
                               sink is out))
            finally:
                if rec is not None:
                    rec.close()
                if hist is not None:
                    hist.close()
        assert shapes[0] == shapes[1], argv


def test_incident_response_equals_jax(tmp_path):
    assert tflight.incident_response(None) == jflight.incident_response(
        None)
    outs = []
    for pkg in ("jax", "port"):
        flight_mod = _PKGS[pkg][0]
        rec = flight_mod.FlightRecorder(
            str(tmp_path / pkg), registry=_PKGS[pkg][2].MetricsRegistry(),
            now=lambda: 5.0)
        empty = flight_mod.incident_response(rec)
        rec.trigger("manual:x")
        rec.poll_once()
        status, body = flight_mod.incident_response(rec)
        outs.append((empty, status, _core(body["incident"])))
    assert outs[0] == outs[1]
    assert outs[1][0] == (404, {"error": "no incident recorded yet"})


# ----------------------------------------------------------- fingerprint

_ARGVS = [["-i", "x.tim"],
          ["-i", "x.tim", "-s", "7", "--pop-size", "8", "--obs",
           "--obs-listen", "127.0.0.1:0", "--incident-dir", "inc",
           "--incident-min-interval", "0", "--history-every", "0.2",
           "--faults", "dispatch:2:unavailable", "--backend", "cpu"],
          ["-i", "y.tim", "--no-auto-tune", "-p", "2", "--ls-mode",
           "sweep", "--mem-poll-every", "0.5"]]


@pytest.mark.parametrize("argv", _ARGVS, ids=["defaults", "flags", "ls"])
def test_config_fingerprint_values_equal_jax(argv):
    """On the same argv the port's fingerprint `values` equal JAX's on
    every field both RunConfigs hold, FINGERPRINT_DIFFER aside (the md5
    is over each package's own fields, so it is not compared)."""
    want = jflight.config_fingerprint(jconfig.parse_args(argv))
    got = tflight.config_fingerprint(tconfig.parse_args(argv))
    assert got["kind"] == want["kind"] == "RunConfig"
    shared = set(got["values"]) & set(want["values"])
    assert {"obs_listen", "history_every", "incident_dir",
            "incident_min_interval", "mem_poll_every"} <= shared
    differ = {k for k in shared if got["values"][k] != want["values"][k]}
    if "--backend" in argv:
        assert differ == set()
    else:
        assert differ == set(FINGERPRINT_DIFFER)
    # the fingerprint is stable for equal flags, and dict configs work
    assert tflight.config_fingerprint(tconfig.parse_args(argv)) == got
    assert (tflight.config_fingerprint({"a": 1, "b": [2]})
            == jflight.config_fingerprint({"a": 1, "b": [2]}))


def test_approx_bytes_equals_jax():
    for obj in ({"name": "x", "flow": [1, 2], "n": {"a": "bc"}}, "abc",
                [1, "x", (2, 3)], 7, None, 2.5):
        assert tflight._approx_bytes(obj) == jflight._approx_bytes(obj)


# --------------------------------------------------------------- readers


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """{package: bundle path}: one bundle each package's recorder wrote
    from the same records (the span and fault of a recovery)."""
    tmp = tmp_path_factory.mktemp("bundles")
    out = {}
    for pkg in ("jax", "port"):
        flight_mod, _, metrics_mod, _, config_mod = _PKGS[pkg]
        d = tmp / pkg
        rec = flight_mod.FlightRecorder(
            str(d), registry=metrics_mod.MetricsRegistry(),
            now=lambda: 3.0, process="engine",
            config=config_mod.parse_args(["-i", "x.tim"]))
        tee = rec.tee(io.StringIO())
        for line in (_SPAN % ("dispatch", 0.1), _SPAN % ("fetch", 0.3),
                     _LOG % (9, 1.0), _FAULT % "dispatch"):
            tee.write(line + "\n")
        rec.poll_once()
        out[pkg] = rec.latest_path
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mode", ["dir", "file", "list", "job", "help"])
def test_incident_reader_equals_jax(writer, mode, bundles, tmp_path):
    path = bundles[writer]
    dest = str(tmp_path / "trace.json")
    argv = {"dir": [os.path.dirname(path), "-o", dest],
            "file": [path, "-o", dest], "list": [os.path.dirname(path),
                                                 "--list"],
            "job": [path, "--job", "j1", "-o", dest], "help": ["-h"]}[mode]
    got = _run(tcli.main, ["incident"] + argv)
    got_doc = open(dest).read() if os.path.exists(dest) else None
    want = _run(jcli.main, ["incident"] + argv)
    want_doc = open(dest).read() if os.path.exists(dest) else None
    assert got == want and got[0] == 0
    assert got_doc == want_doc
    if mode == "file":
        assert "last fault: dispatch/recover" in got[1]


@pytest.mark.parametrize("argv", [[], ["a", "b"], ["--bogus"], ["-o"]],
                         ids=["none", "two", "bogus", "no-value"])
def test_incident_refusals_equal_jax(argv, tmp_path):
    with pytest.raises(SystemExit) as want:
        jcli.main(["incident"] + argv)
    with pytest.raises(SystemExit) as got:
        tcli.main(["incident"] + argv)
    assert str(got.value) == str(want.value)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit) as want:
        jcli.main(["incident", str(empty)])
    with pytest.raises(SystemExit) as got:
        tcli.main(["incident", str(empty)])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trace_on_log_and_bundle_equals_jax(writer, bundles, tmp_path):
    """trace on a JSONL log next to a bundle: one process lane per input
    (the bundle's under `<file>:<process>`), JAX's bytes."""
    log = tmp_path / "run.jsonl"
    log.write_text(_SPAN % ("init", 0.0) + "\n" + _LOG % (3, 0.5) + "\n")
    dest = str(tmp_path / "t.json")
    argv = ["trace", str(log), bundles[writer], "-o", dest]
    got = _run(tcli.main, argv)
    got_doc = open(dest).read()
    want = _run(jcli.main, argv)
    assert got == want and got[0] == 0
    assert got_doc == open(dest).read()
    names = {e.get("args", {}).get("name") for e in
             json.loads(got_doc)["traceEvents"] if e.get("ph") == "M"}
    assert f"{os.path.basename(bundles[writer])}:engine" in names


# the evidence forms `_evidence_lines` renders, over three decisions
_SCALE_LOG = [
    {"scaleEntry": {"ts": 1.5, "action": "up", "reason": "backlog",
                    "replica": "r2", "live": 1, "target": 2,
                    "evidence": {"serve.queue_depth": {
                        "op": ">=", "threshold": 8.0, "for_s": 30.0,
                        "mean": 9.5},
                        "jobs_done": {"rate_per_s": 2.0, "threshold": 1.0,
                                      "window_s": 10.0},
                        "demand_flops_per_s": {"acme": 1e9},
                        "note": "x"}}},
    {"logEntry": {"best": 3}},
    {"scaleEntry": {"ts": 9.0, "action": "down", "reason": "idle",
                    "replica": "r1", "live": 2, "dry_run": True,
                    "evidence": {"replicas": {
                        "r1": {"inflight": 0, "backlog_mean": 0.0,
                               "idle": True, "resident_groups": 0},
                        "r2": {"inflight": 1, "backlog_mean": None,
                               "resident_groups": 2,
                               "resident_bytes": 4096}},
                        "warmth_skipped": {"r3": "b0"}}}},
    {"scaleEntry": {"action": "hold", "reason": "cooldown",
                    "blocked": "cooldown"}},
]


@pytest.mark.parametrize("argv", [[], ["--json"], ["empty"], ["-h"]],
                         ids=["text", "json", "no-entries", "help"])
def test_scale_reader_equals_jax(argv, tmp_path):
    log = tmp_path / "gw.jsonl"
    if argv == ["empty"]:
        log.write_text('{"logEntry": {"best": 1}}\n')
        argv = []
    else:
        log.write_text("\n".join(json.dumps(r) for r in _SCALE_LOG)
                       + '\n\n{"scaleEntry": {"ts"')  # a torn tail
    got = _run(tcli.main, ["scale", str(log)] + argv)
    want = _run(jcli.main, ["scale", str(log)] + argv)
    assert got == want and got[0] == 0
    assert _run(tscaler.main_scale, [str(log)] + argv) == _run(
        jscaler.main_scale, [str(log)] + argv)
    for bad in ([], ["--bogus"]):
        with pytest.raises(SystemExit) as w:
            jcli.main(["scale"] + bad)
        with pytest.raises(SystemExit) as g:
            tcli.main(["scale"] + bad)
        assert str(g.value) == str(w.value)


_NO_TORCH = r"""
import builtins, runpy, sys
real = builtins.__import__
def guard(name, *a, **k):
    if name.split(".")[0] in ("torch", "jax", "timetabling_ga_tpu"):
        raise ImportError("blocked: " + name)
    return real(name, *a, **k)
builtins.__import__ = guard
sys.argv = ["timetabling_ga_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("timetabling_ga_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
assert "torch" not in sys.modules
"""


def test_readers_run_without_torch(bundles, tmp_path):
    """`python -m timetabling_ga_tpu_torch incident|trace|scale` with
    torch, JAX and the JAX package blocked from import."""
    log = tmp_path / "gw.jsonl"
    log.write_text("\n".join(json.dumps(r) for r in _SCALE_LOG) + "\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    for argv in (["incident", os.path.dirname(bundles["port"]), "-o",
                  str(tmp_path / "i.json")],
                 ["incident", bundles["jax"], "--list"],
                 ["trace", str(log), bundles["port"], "-o",
                  str(tmp_path / "t.json")],
                 ["scale", str(log)], ["scale", str(log), "--json"]):
        proc = subprocess.run([sys.executable, "-c", _NO_TORCH, *argv],
                              cwd=str(tmp_path), env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, (argv, proc.stderr)
