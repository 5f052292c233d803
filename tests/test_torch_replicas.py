"""The port's fleet replica (fleet/replicas.py, fleet/gateway.py's
protocol half, `serve --http`) against the JAX package on the CPU:

  - the fleet flags parse as JAX's parse_serve_args does, refusals
    included; `--mesh-devices 2` parses for a replica as for JAX, and the
    `fleet` and `submit` subcommands are served (JAX's flags under -h,
    JAX's exits and messages without their input);
  - parse_solve_body, payload_counts, edit_payload_counts and JobTail
    (its cap and eviction) equal JAX's on a table of cases;
  - JAX's replica lifecycle script (tests/test_fleet.py
    test_replica_http_lifecycle) against a JAX in-process replica and a
    port one: the same HTTP statuses, states, body keys and jobEntry
    events a job;
  - the residency stay rule with ship_hot and request_flush: the same
    serve.resident_hits, flushes and park/resume bytes after every step
    of one schedule as JAX's scheduler;
  - the preempt drain: fetched means a prompt exit, unfetched an exit at
    --preempt-grace (a patched clock), a bad mode a 400,
    serve.jobs_preempted counted, the `preempted` jobEntry `shipped`;
  - `snapshot_ship:1:hang` and `:die` park or drop one handler while the
    drive loop advances;
  - no handler thread calls into torch.cuda;
  - importing the port's fleet modules, and the CLI's `fleet` and
    `submit` dispatch, load no torch;
  - a `serve --http --preempt-on-term --backend cpu` process sent
    SIGTERM exits 0 with the `preempted` record.

Instances of 12 events, lanes 2, quantum 5, pop 4, -m 8 (JAX
tests/test_fleet.py:58-65); JAX's services serve one device
(--mesh-devices 1) so their lanes are the port's.
"""

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from timetabling_ga_tpu.fleet import gateway as jgateway
from timetabling_ga_tpu.fleet import replicas as jreplicas
from timetabling_ga_tpu.obs.metrics import MetricsRegistry as JRegistry
from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.runtime import config as jconfig
from timetabling_ga_tpu.serve.service import SolveService as JSolveService
from timetabling_ga_tpu_torch import cli as tcli
from timetabling_ga_tpu_torch.fleet import gateway as tgateway
from timetabling_ga_tpu_torch.fleet import replicas as treplicas
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime import config as tconfig
from timetabling_ga_tpu_torch.runtime import faults as tfaults
from timetabling_ga_tpu_torch.serve.service import SolveService

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SHAPE_A = dict(n_events=12, n_rooms=3, n_features=2, n_students=8,
                attend_prob=0.2)
_TIM = dump_tim(random_instance(71, **_SHAPE_A))
_TIM2 = dump_tim(random_instance(73, **_SHAPE_A))

# polls wait at most this long for a state; no assertion reads a wall
# time tighter than it
_DEADLINE_S = 120.0


@pytest.fixture(autouse=True)
def _no_fault_plan():
    tfaults.install(None)
    yield
    tfaults.install(None)


def _cfg(mod, **kw):
    """JAX tests/test_fleet.py's serve config for either package."""
    kw.setdefault("backend", "cpu")
    kw.setdefault("lanes", 2)
    kw.setdefault("quantum", 5)
    kw.setdefault("pop_size", 4)
    kw.setdefault("max_steps", 8)
    if mod is jconfig:
        kw.setdefault("mesh_devices", 1)
    return mod.ServeConfig(**kw)


def _until(fn, what, timeout=_DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _shipped(rep, jid):
    def f():
        try:
            return rep.svc.queue.get(jid).ship is not None
        except KeyError:
            return False
    _until(f, f"{jid}'s first ship unit")


# ------------------------------------------------------------------ flags

_FLAG_CASES = {
    "http": ["--http", "127.0.0.1:8080"],
    "http-any-host": ["--http", "0.0.0.0:0"],
    "http-no-port": ["--http", "localhost"],
    "http-bad-port": ["--http", "127.0.0.1:http"],
    "http-port-range": ["--http", "127.0.0.1:70000"],
    "http-no-host": ["--http", ":8080"],
    "grace": ["--preempt-grace", "2.5"],
    "grace-zero": ["--preempt-grace", "0"],
    "grace-negative": ["--preempt-grace", "-1"],
    "grace-not-a-number": ["--preempt-grace", "soon"],
    "on-term": ["--preempt-on-term"],
    "all-three": ["--http", "127.0.0.1:0", "--preempt-grace", "30",
                  "--preempt-on-term"],
    "http-needs-value": ["--http"],
}


@pytest.mark.parametrize("case", sorted(_FLAG_CASES))
def test_fleet_flags_parse_as_jax(case):
    argv = _FLAG_CASES[case]

    def outcome(mod):
        try:
            cfg = mod.parse_serve_args(argv)
        except (SystemExit, ValueError) as e:
            return type(e).__name__, str(e)
        return "ok", (cfg.http, cfg.preempt_grace, cfg.preempt_on_term)
    assert outcome(tconfig) == outcome(jconfig)


def test_fleet_flag_defaults_equal_jax():
    t, j = tconfig.ServeConfig(), jconfig.ServeConfig()
    assert (t.http, t.preempt_grace, t.preempt_on_term) == (
        j.http, j.preempt_grace, j.preempt_on_term) == (None, 10.0, False)
    assert not hasattr(tconfig, "SERVE_NOT_PORTED")


@pytest.mark.parametrize("argv", [
    ["--mesh-devices", "2"],
    ["--http", "127.0.0.1:0", "--mesh-devices", "2"]])
def test_mesh_devices_parse_for_a_replica(argv):
    """`serve [--http] --mesh-devices 2` parses as JAX's: the replica's
    lanes spread over two cards (serve/scheduler.py)."""
    t, j = tconfig.parse_serve_args(argv), jconfig.parse_serve_args(argv)
    assert (t.mesh_devices, t.http) == (j.mesh_devices, j.http)
    assert t.mesh_devices == 2


def _cli(main, argv):
    """(exit, stdout, stderr) of one CLI call; a SystemExit is its
    message."""
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = ("SystemExit", str(e))
    return rc, so.getvalue(), se.getvalue()


def _flags(usage):
    return sorted(line.split()[0] for line in usage.splitlines()
                  if line.startswith("  -"))


@pytest.mark.parametrize("sub,bad", [
    ("fleet", [[], ["--replica"], ["--spawn", "1", "--", "-o", "x"]]),
    ("submit", [["http://127.0.0.1:1"],
                ["http://127.0.0.1:1", "/nonexistent/x.tim"],
                ["http://127.0.0.1:1", "x.tim", "-s", "one"]])])
def test_fleet_and_submit_are_served(sub, bad):
    """The fleet subcommands are no longer refused: -h gives JAX's flags,
    and a call without its input stops with JAX's exit and message."""
    from timetabling_ga_tpu import cli as jcli
    got, want = _cli(tcli.main, [sub, "-h"]), _cli(jcli.main, [sub, "-h"])
    assert got[0] == want[0] and _flags(got[1]) == _flags(want[1])
    assert len(_flags(got[1])) > 10
    for argv in bad:
        got, want = _cli(tcli.main, [sub, *argv]), _cli(jcli.main,
                                                         [sub, *argv])
        assert got[0] == want[0] != 0, argv
        if got[2].startswith("usage:"):
            assert _flags(got[2]) == _flags(want[2])
        else:
            assert got[2] == want[2]
    assert sub in tcli.TORCH_FREE


# --------------------------------------------------------------- protocol

_BODIES = {
    "json": b'{"tim": "1 2 3 4", "seed": 7}',
    "raw-tim": b"4 2 2 5\n10\n",
    "unknown-keys": b'{"tim": "1 1 1 1", "x": 2, "tenant": "acme"}',
    "empty": b"",
    "blank": b"  \n ",
    "no-instance": b'{"seed": 1}',
    "bad-json": b'{"tim": ',
    "not-utf8": b"\xff\xfe",
    "edit-only": b'{"edit": {"base": "j1", "ops": []}}',
    "problem": b'{"problem": {"n_events": 3}, "priority": 2}',
    "every-key": json.dumps({k: 1 for k in jgateway._PAYLOAD_KEYS}
                            ).encode(),
}

_PAYLOADS = {
    "tim": {"tim": "12 3 2 8\nrest ignored"},
    "grid": {"tim": "1 1 1 1", "n_days": 3, "slots_per_day": 4},
    "problem": {"problem": {"n_events": 9, "n_rooms": 2,
                            "n_features": 1, "n_students": 5}},
    "problem-grid": {"problem": {"n_events": 9, "n_rooms": 2,
                                 "n_features": 1, "n_students": 5,
                                 "n_days": 2, "slots_per_day": 3}},
    "short-header": {"tim": "1 2 3"},
    "not-ints": {"tim": "a b c d"},
    "negative": {"tim": "1 -2 3 4"},
    "bad-problem": {"problem": {"n_events": 1}},
    "edit-id-base": {"edit": {"base": "j1", "ops": []}},
    "edit-inline": {"edit": {"base": {"tim": "10 2 2 4"},
                             "ops": [{"op": "add_event"},
                                     {"op": "remove_event"},
                                     {"op": "add_event"}]}},
    "edit-edited": {"edit": {"base": "j1",
                             "edited": {"tim": "7 2 2 4"}},
                    "n_days": 4},
    "edit-empties": {"edit": {"base": {"tim": "1 2 2 4"},
                              "ops": [{"op": "remove_event"}]}},
    "edit-both": {"edit": {"base": "j1", "ops": [], "edited": {}}},
    "edit-neither": {"edit": {"base": "j1"}},
    "edit-no-base": {"edit": {"ops": []}},
    "edit-not-object": {"edit": [1]},
    "edit-ops-not-list": {"edit": {"base": {"tim": "1 1 1 1"},
                                   "ops": "x"}},
    "edit-bad-base": {"edit": {"base": 3, "ops": []}},
    "edit-bad-edited": {"edit": {"base": "j1", "edited": {"x": 1}}},
}


def _outcome(fn, *a):
    try:
        return "ok", fn(*a)
    except (ValueError, KeyError, TypeError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", sorted(_BODIES))
def test_parse_solve_body_equals_jax(case):
    body = _BODIES[case]
    assert _outcome(tgateway.parse_solve_body, body) == _outcome(
        jgateway.parse_solve_body, body)


@pytest.mark.parametrize("case", sorted(_PAYLOADS))
def test_payload_counts_equal_jax(case):
    p = _PAYLOADS[case]
    assert _outcome(tgateway.payload_counts, p) == _outcome(
        jgateway.payload_counts, p)
    if "edit" in p:
        assert _outcome(tgateway.edit_payload_counts, p) == _outcome(
            jgateway.edit_payload_counts, p)


def test_protocol_constants_equal_jax():
    assert (tgateway.MAX_BODY, tgateway.TERMINAL, tgateway._PAYLOAD_KEYS,
            treplicas.TAIL_CAP, treplicas.TAIL_JOBS) == (
        jgateway.MAX_BODY, jgateway.TERMINAL, jgateway._PAYLOAD_KEYS,
        jreplicas.TAIL_CAP, jreplicas.TAIL_JOBS)
    assert (tgateway.DAYS_DEFAULT, tgateway.SLOTS_PER_DAY_DEFAULT) == (
        5, 9)


def _tail_lines():
    lines = ['{"jobEntry": {"job": "a", "ev', 'ent": "admitted"}}\n'
             '{"logEntry": {"best": 1}}\n',
             '{"logEntry": {"best": 2, "job": "a"}}\n', "not json\n",
             "[1, 2]\n", "{}\n", '{"x": 3}\n']
    for i in range(5):
        lines.append(json.dumps({"logEntry": {"best": i, "job": "b"}})
                     + "\n")
    for j in ("c", "d", "e"):
        lines.append(json.dumps({"jobEntry": {"job": j, "event": "x"}})
                     + "\n")
    lines.append(json.dumps({"jobEntry": {"job": 7, "event": "y"}})
                 + "\n")
    lines.append('{"logEntry": {"best": 9, "job": "e"}}')   # no newline
    return lines


@pytest.mark.parametrize("cap,max_jobs", [(3, 16), (5, 3), (1, 1),
                                          (4096, 4096)])
def test_job_tail_equals_jax(cap, max_jobs):
    """The tee's stream bytes, each job's tail, its truncation and the
    eviction of the oldest jobs' tails equal JAX's."""
    outs = []
    for mod in (jreplicas, treplicas):
        base = io.StringIO()
        tail = mod.JobTail(base, cap=cap, max_jobs=max_jobs)
        for s in _tail_lines():
            tail.write(s)
        tail.flush()
        outs.append((base.getvalue(),
                     {j: (tail.tail(j), tail.truncated(j))
                      for j in ("a", "b", "c", "d", "e", "7", "zzz")}))
    assert outs[0] == outs[1]


def test_tail_bounds_read_the_environment():
    code = ("from timetabling_ga_tpu_torch.fleet import replicas; "
            "print(replicas.TAIL_CAP, replicas.TAIL_JOBS)")
    out = subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=REPO,
        capture_output=True, text=True,
        env={"PATH": os.defpath, "PYTHONPATH": REPO,
             "TT_FLEET_TAIL_CAP": "17",
             "TT_FLEET_TAIL_JOBS": "5"}).stdout
    assert out.split() == ["17", "5"]


def test_fleet_modules_import_no_torch():
    """The fleet's control plane (gateway, router, replica set and
    spawners, autoscaler, submit client) and the CLI's `fleet` and
    `submit` dispatch load no torch and no numpy."""
    code = """if True:
        import contextlib, io, sys
        import timetabling_ga_tpu_torch.fleet.autoscaler
        import timetabling_ga_tpu_torch.fleet.client
        import timetabling_ga_tpu_torch.fleet.gateway
        import timetabling_ga_tpu_torch.fleet.replicas
        import timetabling_ga_tpu_torch.fleet.router
        from timetabling_ga_tpu_torch import cli
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["submit", "-h"])
            try:
                cli.main(["fleet", "-h"])
            except SystemExit:
                pass
        print("torch" in sys.modules, "numpy" in sys.modules,
              any(m == "jax" or m.startswith("timetabling_ga_tpu.")
                  for m in sys.modules))
    """
    out = subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=REPO,
        capture_output=True, text=True,
        env={"PATH": os.defpath, "PYTHONPATH": REPO}).stdout
    assert out.split() == ["False", "False", "False"]


# ------------------------------------------------------------ lifecycle


def _call(method, url, obj=None):
    """(status, parsed body) of one request, whatever the status."""
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    try:
        return status, (json.loads(body) if body else {})
    except ValueError:
        return status, {"text": body.decode()}


def _lifecycle(replicas_mod, config_mod):
    """JAX's replica lifecycle script (tests/test_fleet.py:349-410) on
    one in-process replica of `replicas_mod`: the transcript of
    statuses and bodies, the settled views and each job's jobEntry
    events."""
    rep, _ = replicas_mod.in_process_replica(
        _cfg(config_mod, http="127.0.0.1:0"), "rx")
    url = rep.url
    steps = []

    def step(name, method, path, obj=None):
        status, body = _call(method, url + path, obj)
        steps.append((name, status, sorted(body)))
        return status, body
    try:
        _, acc = step("solve", "POST", "/v1/solve",
                      {"tim": _TIM, "id": "ok1", "seed": 1,
                       "generations": 10})
        _, dup = step("duplicate", "POST", "/v1/solve",
                      {"tim": _TIM, "id": "ok1"})
        _, bad = step("garbage", "POST", "/v1/solve",
                      {"tim": "9 9 9 9\nnot numbers at all"})
        step("unknown", "GET", "/v1/jobs/nope")
        step("solve-long", "POST", "/v1/solve",
             {"tim": _TIM, "id": "long1", "seed": 2, "generations": 500})
        _, cancel = step("cancel", "DELETE", "/v1/jobs/long1")
        step("cancel-unknown", "DELETE", "/v1/jobs/nope")
        step("solve-quoted", "POST", "/v1/solve",
             {"tim": _TIM, "id": "sp 1", "seed": 6, "generations": 5})
        step("no-instance", "POST", "/v1/solve", {"seed": 1})
        step("no-route", "POST", "/v1/nothing", {})
        ids = ["ok1", "long1", "sp 1", bad["id"]]

        def views():
            vs = {j: _call("GET", url + "/v1/jobs/"
                           + urllib.parse.quote(j))[1] for j in ids}
            return vs if all(v["state"] in tgateway.TERMINAL
                             for v in vs.values()) else None
        settled = _until(views, "every job settled")
        step("view", "GET", "/v1/jobs/ok1")
        step("view-no-records", "GET", "/v1/jobs/ok1?records=0")
        _, listing = step("list", "GET", "/v1/jobs")
        step("fleet", "GET", "/v1/fleet")
        step("incident", "GET", "/v1/incident")
        _, usage = step("usage", "GET", "/v1/usage")
        step("drain-bad-mode", "POST", "/v1/drain?mode=bogus", {})
        _, drain = step("drain", "POST", "/v1/drain", {})
        assert rep.drained.wait(_DEADLINE_S)
        _, readyz = step("readyz", "GET", "/readyz")
        _, refused = step("refused", "POST", "/v1/solve", {"tim": _TIM})
        assert not rep.svc.writer.alive()
        events = {}
        for line in rep.tail._stream.getvalue().splitlines():
            rec = json.loads(line)
            if "jobEntry" in rec:
                e = rec["jobEntry"]
                events.setdefault(e["job"], []).append(e["event"])
        # whether the long job started before its cancel landed depends
        # on the host's timing, not on the replica
        events["long1"] = [e for e in events["long1"] if e != "started"]
        return dict(
            steps=steps, acc=acc, dup=dup, bad_id=bad["id"],
            cancel=cancel, drain=drain, refused=refused,
            readyz_reasons=readyz["reasons"],
            states={j: v["state"] for j, v in settled.items()},
            view_keys={j: sorted(v) for j, v in settled.items()},
            result_keys={j: sorted(v["result"] or {})
                         for j, v in settled.items()},
            ok1_gens=settled["ok1"]["result"]["gens"],
            ok1_kinds=sorted({next(iter(r))
                              for r in settled["ok1"]["records"]}),
            listing={j: v["state"] for j, v in listing["jobs"].items()},
            usage_keys=sorted(usage), events=events)
    finally:
        rep.kill()


@pytest.fixture(scope="module")
def lifecycles():
    return _lifecycle(jreplicas, jconfig), _lifecycle(treplicas, tconfig)


def test_lifecycle_statuses_and_body_keys_equal_jax(lifecycles):
    want, got = lifecycles
    assert got["steps"] == want["steps"]
    for k in ("acc", "dup", "bad_id", "cancel", "refused",
              "readyz_reasons"):
        assert got[k] == want[k], k
    assert sorted(got["drain"]) == sorted(want["drain"])


def test_lifecycle_states_equal_jax(lifecycles):
    want, got = lifecycles
    assert got["states"] == want["states"] == {
        "ok1": "done", "long1": "cancelled", "sp 1": "done",
        "rx-1": "rejected"}
    assert got["listing"] == want["listing"]
    assert got["ok1_gens"] == want["ok1_gens"] == 10


def test_lifecycle_views_equal_jax(lifecycles):
    want, got = lifecycles
    for k in ("view_keys", "result_keys", "ok1_kinds", "usage_keys"):
        assert got[k] == want[k], k


def test_lifecycle_job_entries_equal_jax(lifecycles):
    want, got = lifecycles
    assert got["events"] == want["events"]
    assert got["events"]["ok1"] == ["admitted", "started", "done"]
    assert got["events"]["rx-1"] == ["rejected"]


# -------------------------------------------------------- the stay rule

# (before the step: "flush" = request_flush(), "hot"/"cold" = job a's
# ship_hot on/off), one entry a step, None = a plain step
_SCHEDULE = [None, None, None, "flush", "hot", None, None, "cold", None,
             "flush", None, "hot", "cold", None, None, None]
_STAY_COUNTERS = ("serve.resident_hits", "serve.resident_flushes",
                  "serve.park_bytes", "serve.resume_bytes",
                  "serve.dispatches")


def _stay_schedule(service_cls, config_mod, registry_cls, problems):
    svc = service_cls(_cfg(config_mod), out=io.StringIO(),
                      registry=registry_cls())
    try:
        for jid, p, seed in problems:
            svc.submit(p, job_id=jid, seed=seed, generations=60)
        seen = []
        for action in _SCHEDULE:
            if action == "flush":
                svc.scheduler.request_flush()
            elif action in ("hot", "cold"):
                svc.queue.get("a").ship_hot = action == "hot"
            svc.step()
            counters = svc.registry.snapshot()["counters"]
            seen.append((tuple(counters.get(c, 0)
                               for c in _STAY_COUNTERS),
                         len(svc.scheduler._resident),
                         tuple(svc.queue.get(j).gens_done
                               for j, *_ in problems)))
        return seen
    finally:
        svc.close()


def test_stay_rule_with_ship_hot_and_request_flush_equals_jax():
    """One schedule of two same-bucket jobs with ship requests and a
    ship_hot job: after every step the resident hits, the flushes, the
    park and resume bytes and the resident groups equal JAX's."""
    from timetabling_ga_tpu.problem import load_tim as jload_tim
    want = _stay_schedule(JSolveService, jconfig, JRegistry,
                          [("a", jload_tim(_TIM), 3),
                           ("b", jload_tim(_TIM2), 4)])
    got = _stay_schedule(SolveService, tconfig, MetricsRegistry,
                         [("a", load_tim(_TIM), 3),
                          ("b", load_tim(_TIM2), 4)])
    assert got == want
    hits = [s[0][0] for s in got]
    assert hits[-1] > 0 and got[-1][0][1] > 0


# -------------------------------------------------------- preempt drain


def _post(rep, jid, gens=5000, seed=3):
    treplicas.http_json("POST", rep.url + "/v1/solve",
                        {"tim": _TIM, "id": jid, "seed": seed,
                         "generations": gens})


def _stream(rep):
    return [json.loads(x) for x in rep.tail._stream.getvalue().splitlines()]


def test_preempt_drain_fetched_exits_promptly():
    """Preempted and fetched: the view reads `preempted` with the
    snapshot and its records, and the replica exits long before its
    grace (an hour)."""
    rep, handle = treplicas.in_process_replica(
        _cfg(tconfig, http="127.0.0.1:0", preempt_grace=3600.0), "pf")
    try:
        _post(rep, "p2")
        _shipped(rep, "p2")
        ack = treplicas.http_json("POST", rep.url + "/v1/drain?mode=preempt",
                                  {}, ok=(200,))
        assert ack["mode"] == "preempt" and ack["draining"] is True

        def preempted():
            v = handle.get_job("p2", timeout=30.0, with_records=False,
                               snapshot=True)
            return v if v["state"] == "preempted" else None
        view = _until(preempted, "p2 preempted")
        assert view["snapshot"]["gens_done"] == view["gens"] > 0
        assert any("jobEntry" in r for r in view["snapshot_records"])
        assert view["snapshot_records_bytes"] == sum(
            len(json.dumps(r)) for r in view["snapshot_records"])
        assert view["snapshot_truncated"] is False
        assert rep.drained.wait(_DEADLINE_S)
        assert rep.svc.registry.counter(
            "serve.jobs_preempted").value == 1
        last = [r["jobEntry"] for r in _stream(rep) if "jobEntry" in r][-1]
        assert last == {"job": "p2", "event": "preempted",
                        "gens": view["gens"], "shipped": True}
    finally:
        rep.kill()


class _Clock:
    """The replica module's `time`, its monotonic clock moved on by
    hand."""

    def __init__(self):
        self.offset = 0.0

    def monotonic(self):
        return time.monotonic() + self.offset

    def __getattr__(self, name):
        return getattr(time, name)


def test_preempt_drain_unfetched_exits_at_the_grace(monkeypatch):
    """Nobody fetches: the replica stays up, serving, until its grace
    has passed on its clock, then exits."""
    clock = _Clock()
    monkeypatch.setattr(treplicas, "time", clock)
    rep, handle = treplicas.in_process_replica(
        _cfg(tconfig, http="127.0.0.1:0", preempt_grace=100.0), "pu")
    try:
        _post(rep, "p1")
        _shipped(rep, "p1")
        treplicas.http_json("POST", rep.url + "/v1/drain?mode=preempt", {},
                            ok=(200,))
        _until(lambda: rep.svc.queue.get("p1").state == "preempted",
               "p1 preempted")
        assert not rep.drained.wait(1.0)       # the clock stands still
        assert handle.list_jobs()["p1"]["state"] == "preempted"
        clock.offset += 101.0
        assert rep.drained.wait(_DEADLINE_S)
        assert rep.svc.queue.get("p1").ship.served is False
        entries = [r["jobEntry"] for r in _stream(rep) if "jobEntry" in r]
        assert entries[-1]["event"] == "preempted"
        assert entries[-1]["shipped"] is True
    finally:
        rep.kill()


def test_preempt_drain_bad_mode_is_a_400():
    rep, handle = treplicas.in_process_replica(
        _cfg(tconfig, http="127.0.0.1:0"), "pb")
    try:
        with pytest.raises(treplicas.FleetHTTPError) as e:
            handle.drain(mode="bogus")
        assert e.value.status == 400
        assert "bogus" in e.value.detail["error"]
        assert rep.driving() and not rep.draining
    finally:
        rep.kill()


def test_preempt_drain_of_an_idle_replica_exits():
    """No job to ship: the preempt drain exits without waiting for its
    grace (an hour), and counts no preemption."""
    rep, handle = treplicas.in_process_replica(
        _cfg(tconfig, http="127.0.0.1:0", preempt_grace=3600.0), "pi")
    try:
        handle.drain(mode="preempt")
        assert rep.drained.wait(_DEADLINE_S)
        assert rep.svc.registry.counter(
            "serve.jobs_preempted").value == 0
    finally:
        rep.kill()


# ------------------------------------------------------ snapshot_ship site


@pytest.mark.parametrize("action", ["hang", "die"])
def test_snapshot_ship_fault_parks_one_handler(monkeypatch, action):
    """`snapshot_ship:1:hang` parks, `:die` drops, the one handler that
    packs: its client gets no answer, the drive loop keeps solving, the
    next export works and the writer drains on stop (JAX
    tests/test_resume.py:301-346)."""
    monkeypatch.setattr(tfaults, "HANG_S", 30.0)
    rep, handle = treplicas.in_process_replica(
        _cfg(tconfig, http="127.0.0.1:0"), "h" + action)
    try:
        _post(rep, "h", gens=400)
        _shipped(rep, "h")
        tfaults.install(f"snapshot_ship:1:{action}")
        with pytest.raises(Exception):
            handle.get_job("h", timeout=0.5, with_records=False,
                           snapshot=True)
        g0 = rep.svc.queue.get("h").gens_done
        _until(lambda: rep.svc.queue.get("h").gens_done > g0,
               "the drive loop's progress")
        view = handle.get_job("h", timeout=30.0, with_records=False,
                              snapshot=True)
        assert view.get("snapshot") is not None
        tfaults.install(None)
        rep.svc.cancel("h")
        rep.stop(timeout=_DEADLINE_S)
        assert rep.drained.wait(5)
        assert not rep.svc.writer.alive()
    finally:
        tfaults.install(None)
        rep.kill()


# ------------------------------------------------------------ the reap


def test_settled_jobs_release_their_problem_tensors(monkeypatch):
    """Once a job settles, the drive loop drops its padded problem's
    tensors and every pack holding them: nothing keeps them alive (on
    the card, memory does not grow with the jobs served)."""
    import gc
    import weakref
    from timetabling_ga_tpu_torch.serve import scheduler as tscheduler
    refs = []
    real = tscheduler.Scheduler.prepare

    def prepare(self, job):
        real(self, job)
        refs.append(weakref.ref(job.pa_dev))
    monkeypatch.setattr(tscheduler.Scheduler, "prepare", prepare)
    rep, handle = treplicas.in_process_replica(
        _cfg(tconfig, http="127.0.0.1:0"), "reap")
    try:
        tim_b = dump_tim(random_instance(72, n_events=40, n_rooms=4,
                                         n_features=2, n_students=30,
                                         attend_prob=0.1))
        for jid, tim, gens in (("r1", _TIM, 10), ("r2", _TIM2, 15),
                               ("r3", tim_b, 10), ("r4", _TIM, 400)):
            treplicas.http_json("POST", rep.url + "/v1/solve",
                                {"tim": tim, "id": jid, "seed": 1,
                                 "generations": gens})
        _until(lambda: len(refs) == 4, "four admissions")
        treplicas.http_json("DELETE", rep.url + "/v1/jobs/r4",
                            ok=(202,))
        _until(lambda: all(v["state"] in tgateway.TERMINAL
                           for v in handle.list_jobs().values()),
               "every job settled")
        _until(lambda: all(rep.svc.queue.get(j).pa_dev is None
                           for j in ("r1", "r2", "r3", "r4")),
               "every job reaped")
        assert not rep.svc.scheduler._packs
        gc.collect()
        assert [r() is None for r in refs] == [True] * 4
        # the views still answer from the result and the tail
        view = handle.get_job("r1")
        assert view["state"] == "done" and view["result"]["gens"] == 10
    finally:
        rep.kill()


# --------------------------------------------- handlers and the card


def _cuda_watch():
    """A profile function for new threads that records a handler
    thread's call into torch.cuda (its Python modules or a `_cuda*`
    binding)."""
    seen = []

    def prof(frame, event, arg):
        if "process_request_thread" not in threading.current_thread().name:
            return
        if event == "call":
            name = frame.f_code.co_filename.replace(os.sep, "/")
            if "/torch/cuda/" in name:
                seen.append(name)
        elif event == "c_call":
            fn = getattr(arg, "__name__", "") or ""
            mod = getattr(arg, "__module__", "") or ""
            if fn.startswith("_cuda") or mod.startswith("torch.cuda"):
                seen.append(f"{mod}.{fn}")
    return prof, seen


def test_no_handler_thread_touches_torch_cuda(monkeypatch):
    """Every `/v1` and pull-front route a replica answers, with a job
    resident and polled for its snapshot, runs on handler threads that
    make no call into torch.cuda; the watch itself sees a handler that
    does."""
    rep, handle = treplicas.in_process_replica(
        _cfg(tconfig, http="127.0.0.1:0", obs_listen=None), "cuda")
    prof, seen = _cuda_watch()
    threading.setprofile(prof)
    try:
        # the watch's own check: a handler made to ask torch.cuda
        real = treplicas.ReplicaApi.fleet_view

        def fleet_view(self):
            torch.cuda.is_available()
            return real(self)
        monkeypatch.setattr(treplicas.ReplicaApi, "fleet_view", fleet_view)
        _call("GET", rep.url + "/v1/fleet")
        assert seen, "the watch saw no torch.cuda call"
        seen.clear()
        monkeypatch.setattr(treplicas.ReplicaApi, "fleet_view", real)

        _post(rep, "c1", gens=400)
        _post(rep, "c2", gens=10, seed=5)
        _until(lambda: rep.svc.registry.counter(
            "serve.resident_hits").value > 0, "a resident hit")
        for path in ("/v1/jobs/c1?snapshot=1", "/v1/jobs/c1",
                     "/v1/jobs/c1?records=0&snapshot=1", "/v1/jobs",
                     "/v1/usage", "/v1/incident", "/v1/fleet", "/readyz",
                     "/healthz", "/metrics", "/metrics/history",
                     "/profile?last=1", "/v1/jobs/nope?snapshot=1"):
            _call("GET", rep.url + path)
        _call("DELETE", rep.url + "/v1/jobs/c1")
        _call("POST", rep.url + "/v1/drain?mode=preempt", {})
        assert rep.drained.wait(_DEADLINE_S)
    finally:
        threading.setprofile(None)
        rep.kill()
    assert seen == []


# ------------------------------------------------------ the real process


def _free_port():
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def test_serve_http_sigterm_preempts_and_exits_zero(tmp_path):
    """`python -m timetabling_ga_tpu_torch serve --http ...
    --preempt-on-term --backend cpu`: a job past its first park fence,
    then SIGTERM; the process exits 0 (nobody fetched: at its grace) and
    its log ends with the job's `preempted` jobEntry."""
    port = _free_port()
    log = tmp_path / "replica.jsonl"
    grace = 5.0
    proc = subprocess.Popen(
        [sys.executable, "-m", "timetabling_ga_tpu_torch", "serve",
         "--http", f"127.0.0.1:{port}", "--preempt-on-term",
         "--preempt-grace", str(grace), "--backend", "cpu",
         "--lanes", "2", "--quantum", "5", "--pop-size", "4", "-m", "8",
         "-o", str(log)],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=REPO))
    url = f"http://127.0.0.1:{port}"
    try:
        def up():
            try:
                return treplicas.http_json("GET", url + "/readyz",
                                           ok=(200, 503))
            except OSError:
                return None
        _until(up, "the replica's front")
        treplicas.http_json("POST", url + "/v1/solve",
                            {"tim": _TIM, "id": "t1", "seed": 3,
                             "generations": 100000})
        _until(lambda: treplicas.http_json(
            "GET", url + "/v1/jobs/t1?records=0", ok=(200,)
        ).get("gens", 0) > 0, "t1's first park fence")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=max(60.0, 4 * grace))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err = proc.stderr.read().decode()
        proc.stderr.close()
    assert rc == 0, err
    assert f"replica on {url}" in err
    records = [json.loads(x) for x in log.read_text().splitlines()]
    last = records[-1]["jobEntry"]
    assert last["job"] == "t1" and last["event"] == "preempted"
    assert last["shipped"] is True and last["gens"] > 0
    assert [r["jobEntry"]["event"] for r in records
            if "jobEntry" in r][:2] == ["admitted", "started"]
