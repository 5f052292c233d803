"""In-run fault recovery in the port (runtime/retry.py, runtime/
faults.py, jsonl.AsyncWriter, checkpoint's `ckpt` site, dispatch_core's
Supervisor and fetch watchdog, the engine's supervised loop) against
the JAX package.

The contract held here, scenario by scenario of JAX tests/test_faults.py
:222-431 and tests/test_obs.py:424, on one 15-event instance and one
generation budget: the port's recovered stream equals its own clean
stream under strip_timing (the streams of the two packages differ: their
random streams do), and the port's faultEntry sequence — (site, action,
recovery, level, mode, lostGens) — equals the JAX engine's under the
same plan. The JAX runs skip its program purge after a fault (a no-op
for what is compared: it only drops compiled programs), so that each
recovery does not recompile.
"""

import io
import json
import threading
import time

import numpy as np
import pytest
import torch

from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.runtime import checkpoint as jckpt
from timetabling_ga_tpu.runtime import faults as jfaults
from timetabling_ga_tpu.runtime import retry as jretry
from timetabling_ga_tpu.runtime.config import RunConfig as JRunConfig
from timetabling_ga_tpu_torch.obs.metrics import REGISTRY
from timetabling_ga_tpu_torch.runtime import checkpoint as tckpt
from timetabling_ga_tpu_torch.runtime import dispatch_core as tdcore
from timetabling_ga_tpu_torch.runtime import faults as tfaults
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl
from timetabling_ga_tpu_torch.runtime import retry as tretry
from timetabling_ga_tpu_torch.runtime.config import RunConfig as TRunConfig

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_plans():
    tfaults.install(None)
    jfaults.install(None)
    yield
    tfaults.install(None)
    jfaults.install(None)


# ------------------------------------------------------------ retry


def _chains():
    """Exceptions of each shape the classifier walks."""
    out = [RuntimeError("boom"), RuntimeError("UNAVAILABLE: device"),
           TimeoutError("fetch watchdog: read exceeded 2s"),
           RuntimeError("CUDA error: an illegal memory access was "
                         "encountered"),
           RuntimeError("CUDA error: unspecified launch failure")]
    try:
        try:
            raise ValueError("UNAVAILABLE: device error")
        except ValueError as inner:
            raise RuntimeError("dispatch failed") from inner
    except RuntimeError as e:
        out.append(e)
    try:
        try:
            raise OSError("remote_compile: response body closed")
        except OSError:
            raise KeyError("wrapped")
    except KeyError as e:
        out.append(e)
    a, b = RuntimeError("a"), RuntimeError("b")
    a.__cause__, b.__cause__ = b, a
    out.append(a)
    deep = RuntimeError("UNAVAILABLE at the bottom")
    for i in range(20):
        top = RuntimeError(f"level {i}")
        top.__cause__ = deep
        deep = top
    out.append(deep)
    return out


def test_is_transient_equals_jax():
    """The marker set and the cause-chain walk (its limit included) are
    JAX's; a sticky CUDA error is not transient."""
    assert tretry.TRANSIENT_MARKERS == jretry.TRANSIENT_MARKERS
    assert tretry._CHAIN_LIMIT == jretry._CHAIN_LIMIT
    got = [tretry.is_transient(e) for e in _chains()]
    assert got == [jretry.is_transient(e) for e in _chains()]
    assert got[:5] == [False, True, True, False, False]


@pytest.mark.parametrize("args", [(4, 10.0, 2.0, 35.0), (1, 5.0, 2.0, 1.0),
                                  (6, 1.0, 3.0, 100.0), (0, 1.0, 2.0, 9.0)])
def test_backoff_schedule_equals_jax(args):
    assert tretry.backoff_schedule(*args) == jretry.backoff_schedule(*args)


def test_retry_transient_sleeps_the_schedule(monkeypatch):
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("UNAVAILABLE: window")
        return "ok"

    assert tretry.retry_transient(flaky, attempts=4, wait_s=5.0,
                                  backoff=3.0, max_wait_s=10.0) == ("ok", 3)
    assert slept == [5.0, 10.0]
    slept.clear()
    with pytest.raises(ValueError) as e:
        tretry.retry_transient(lambda: (_ for _ in ()).throw(
            ValueError("real bug")), attempts=3, wait_s=1.0)
    assert slept == [] and e.value.tt_attempts == 1


# ------------------------------------------------------------ the plan


@pytest.mark.parametrize("spec", [
    "dispatch:3:unavailable, fetch:5:hang,writer:1:die,ckpt:2:truncate",
    "quantum:2:unavailable,quantum:2:error", "init:1:unavailable",
    "dispatch@0:2:die,dispatch@1:3:die", "scrape:1:hang,history:4:die",
    "", " , "])
def test_plans_parse_as_jax(spec):
    assert tfaults.SITES == jfaults.SITES
    assert tfaults.ACTIONS == jfaults.ACTIONS
    assert (tfaults.FaultPlan.parse(spec)._entries
            == jfaults.FaultPlan.parse(spec)._entries)


@pytest.mark.parametrize("spec", [
    "dispatch:x:unavailable", "dispatch:0:unavailable",
    "dispatch:1:explode", "dispatch:1", "dispath:1:unavailable",
    "dispatch@x:1:die", "dispatch@-1:1:die"])
def test_bad_plans_are_refused_as_jax(spec):
    with pytest.raises(jfaults.FaultPlanError) as want:
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(tfaults.FaultPlanError) as got:
        tfaults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_actions_and_counters():
    """One-shot entries at their index; `unavailable` raises a clean top
    error over a transient cause; the counters reset on install and the
    injected total carries over; `faults.injected` counts."""
    before = REGISTRY.counter("faults.injected").value
    total = tfaults.injected_total()
    plan = tfaults.install("dispatch:2:unavailable,ckpt:1:error,"
                           "writer:1:die")
    tfaults.maybe_fail("dispatch")
    with pytest.raises(RuntimeError) as e:
        tfaults.maybe_fail("dispatch")
    assert "UNAVAILABLE" not in str(e.value) and tretry.is_transient(e.value)
    tfaults.maybe_fail("dispatch")                    # one-shot
    with pytest.raises(tfaults.FaultInjected):
        tfaults.maybe_fail("ckpt")
    with pytest.raises(SystemExit):
        tfaults.maybe_fail("writer")
    assert plan.injected == 3
    tfaults.install("dispatch:1:error")
    assert tfaults.injected_total() == total + 3
    with pytest.raises(tfaults.FaultInjected):
        tfaults.maybe_fail("dispatch")
    assert REGISTRY.counter("faults.injected").value - before == 4
    assert tfaults.active_spec("x:1:y") == "x:1:y"


def test_run_flags_parse_as_jax():
    """The served flags take JAX's fields, defaults and refusals."""
    from timetabling_ga_tpu.runtime import config as jconfig
    from timetabling_ga_tpu_torch.runtime import config as tconfig
    fields = ("precompile", "pipeline", "donate", "max_recoveries",
              "fetch_timeout", "faults")
    for argv in ([], ["--no-pipeline", "--no-precompile", "--no-donate",
                      "--max-recoveries", "5", "--fetch-timeout", "2.5",
                      "--faults", "dispatch:2:unavailable"]):
        j = jconfig.parse_args(["-i", "x.tim"] + argv)
        t = tconfig.parse_args(["-i", "x.tim"] + argv)
        assert [getattr(t, f) for f in fields] == [getattr(j, f)
                                                   for f in fields]
    for bad in (["--max-recoveries", "-1"], ["--fetch-timeout", "-0.5"]):
        with pytest.raises(SystemExit) as want:
            jconfig.parse_args(["-i", "x.tim"] + bad)
        with pytest.raises(SystemExit) as got:
            tconfig.parse_args(["-i", "x.tim"] + bad)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------ the writer


def test_async_writer_keeps_order_with_jobs():
    buf = io.StringIO()
    w = tjsonl.AsyncWriter(buf, maxsize=4)
    for i in range(50):
        if i % 7 == 0:
            w.submit(lambda i=i: buf.write(f"job {i}\n"))
        w.write(f"rec {i}\n")
    w.drain()
    want = []
    for i in range(50):
        if i % 7 == 0:
            want.append(f"job {i}")
        want.append(f"rec {i}")
    assert buf.getvalue().splitlines() == want
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.write("late\n")


def test_async_writer_death_aware_enqueue_and_close():
    """A worker killed at `writer:1:die` with a full queue: write,
    submit, drain and close raise instead of blocking (JAX
    tests/test_faults.py:113)."""
    tfaults.install("writer:1:die")
    buf = io.StringIO()
    w = tjsonl.AsyncWriter(buf, maxsize=2)
    w.write('{"a":1}\n')
    deadline = time.monotonic() + 30
    with pytest.raises(RuntimeError, match="worker thread died"):
        while time.monotonic() < deadline:
            w.write('{"b":2}\n')
    with pytest.raises(RuntimeError, match="worker thread died"):
        w.submit(lambda: None)
    with pytest.raises(RuntimeError, match="worker thread died"):
        w.drain()
    with pytest.raises(RuntimeError, match="worker thread died"):
        w.close()
    w.close(raise_error=False)
    assert buf.getvalue() == ""


def test_async_writer_surfaces_a_stream_error():
    class Broken(io.StringIO):
        def write(self, s):
            raise OSError("disk full")

    w = tjsonl.AsyncWriter(Broken())
    w.write("x\n")
    with pytest.raises(OSError, match="disk full"):
        w.drain()
    w.close(raise_error=False)


# ------------------------------------------------- the fetch watchdog


def test_fetch_watchdog_times_out_and_tags_the_site():
    """A hang inside the read becomes a transient FetchTimeout at the
    deadline; an error inside it is re-raised tagged `fetch`."""
    tdcore.set_fetch_timeout(0.3)
    try:
        tfaults.HANG_S, hang = 5.0, tfaults.HANG_S
        tfaults.install("fetch:1:hang,fetch:2:error")
        t0 = time.monotonic()
        with pytest.raises(tdcore.FetchTimeout) as e:
            tdcore.fetch(torch.arange(3))
        assert time.monotonic() - t0 < 3.0
        assert e.value.tt_site == "fetch" and tretry.is_transient(e.value)
        with pytest.raises(tfaults.FaultInjected) as e2:
            tdcore.fetch(torch.arange(3))
        assert e2.value.tt_site == "fetch"
        np.testing.assert_array_equal(tdcore.fetch(torch.arange(3)),
                                      [0, 1, 2])
    finally:
        tfaults.HANG_S = hang
        tdcore.set_fetch_timeout(None)
    tfaults.install("fetch:1:error")
    with pytest.raises(tfaults.FaultInjected):
        tdcore.fetch(np.arange(2))              # no deadline: in line
    assert threading.active_count() >= 1


# ------------------------------------------------------------ checkpoint


def test_ckpt_truncate_falls_back_to_prev(tmp_path, capsys):
    """`ckpt:2:truncate` tears the second save after its rename; the
    load falls back to the rotated first save, as JAX's does."""
    from timetabling_ga_tpu_torch.ops.ga import PopState
    path = str(tmp_path / "ck.npz")
    state = PopState(*([np.arange(12, dtype=np.int32).reshape(3, 4)] * 2
                       + [np.arange(3, dtype=np.int32)] * 3))
    tfaults.install("ckpt:2:truncate")
    tckpt.save(path, state, np.zeros(2, np.uint32), 5, "fp", [7], 3)
    tckpt.save(path, state, np.zeros(2, np.uint32), 9, "fp", [6], 3)
    tfaults.install(None)
    loaded = tckpt.load(path, "fp")
    assert loaded.generation == 5 and loaded.best_seen == [7]
    assert "previous checkpoint" in capsys.readouterr().err
    # the JAX loader takes the same torn pair the same way
    st, _key, gen, best, _seed = jckpt.load(path, "fp")
    assert gen == 5 and list(best) == [7]


# ------------------------------------------------ the engine scenarios

# JAX tests/test_faults.py's run at a migration period of 5: six
# dispatches, the second of which still improves the best (so a replay
# that lost the in-flight chunk's records would show)
_RUN = dict(seed=3, pop_size=8, islands=1, generations=30,
            migration_period=5, max_steps=8, time_limit=300,
            backend="cpu", auto_tune=False, trace=True)

# id -> (run kwargs, the exception the run ends with or None); JAX
# tests/test_faults.py:222-431 and tests/test_obs.py:424
SCENARIOS = {
    "dispatch-serial": (dict(pipeline=False,
                             faults="dispatch:2:unavailable"), None),
    "dispatch-pipelined": (dict(pipeline=True,
                                faults="dispatch:2:unavailable"), None),
    "pipelined-checkpoint": (dict(pipeline=True, checkpoint="ck",
                                  checkpoint_every=1,
                                  faults="dispatch:3:unavailable"), None),
    # the last chunk's read fails after the checkpoint that covered it:
    # nothing is replayed, so its improvements reach the stream only
    # from the snapshot's in-flight trace (fetch 6: the init fence, the
    # first snapshot, chunk 1's trace, the checkpoint's state and its
    # in-flight trace, then chunk 2's trace)
    "last-chunk-read": (dict(pipeline=True, generations=10,
                             checkpoint="ck", checkpoint_every=1,
                             faults="fetch:6:unavailable"), None),
    "fetch-hang-serial": (dict(pipeline=False, fetch_timeout=1.0,
                               faults="fetch:3:hang"), None),
    "fetch-hang-pipelined": (dict(pipeline=True, fetch_timeout=1.0,
                                  faults="fetch:3:hang"), None),
    "degrade": (dict(pipeline=True, max_recoveries=5,
                     faults="dispatch:1:unavailable,"
                            "dispatch:2:unavailable"), None),
    "ladder-2": (dict(pipeline=False, max_recoveries=6,
                      faults="dispatch:1:unavailable,dispatch:2:unavailable,"
                             "dispatch:3:unavailable"), None),
    "exhausted": (dict(pipeline=False, checkpoint="ck", checkpoint_every=1,
                       max_recoveries=1,
                       faults="dispatch:1:unavailable,"
                              "dispatch:2:unavailable"), "transient"),
    "init": (dict(pipeline=False, faults="init:1:unavailable"), None),
    "init-bounded": (dict(pipeline=False,
                          faults="init:1:unavailable,init:2:unavailable,"
                                 "init:3:unavailable"), "transient"),
    "init-off": (dict(pipeline=False, max_recoveries=0,
                      faults="init:1:unavailable"), "transient"),
    "non-transient": (dict(pipeline=False, faults="dispatch:1:error"),
                      "injected"),
    "stats": (dict(trace_mode="stats", faults="dispatch:2:unavailable"),
              None),
}
# the init-polish window (JAX's is marked slow the same way; "init" is
# its tier-1 twin) and JAX tests/test_obs.py:424's deltas run ("stats",
# the same recovery on the other packed leaf, its twin)
SLOW_SCENARIOS = {
    "deltas": (dict(trace_mode="deltas", faults="dispatch:2:unavailable"),
               None),
    "init-polish": (dict(pipeline=False, init_sweeps=3,
                         faults="dispatch:1:unavailable"), None),
}


@pytest.fixture(scope="module")
def tim_file(tmp_path_factory):
    """JAX tests/test_faults.py's instance."""
    problem = random_instance(55, n_events=15, n_rooms=5, n_features=2,
                              n_students=10, attend_prob=0.1)
    path = tmp_path_factory.mktemp("faults") / "tiny.tim"
    path.write_text(dump_tim(problem))
    return str(path)


def _fault_seq(lines):
    return [(f["site"], f["action"], f["recovery"], f["level"],
             f.get("mode"), f.get("lostGens"), f.get("init"))
            for f in (x["faultEntry"] for x in lines if "faultEntry" in x)]


def _run(engine, config, tim_file, kw, tmp, tag):
    kw = dict(kw)
    if kw.get("checkpoint"):
        kw["checkpoint"] = str(tmp / f"{tag}.npz")
    buf = io.StringIO()
    err = None
    try:
        best = engine.run(config(**dict(_RUN, input=tim_file, **kw)),
                          out=buf)
    except Exception as e:        # the scenario's own end
        best, err = None, e
    return best, [json.loads(x) for x in buf.getvalue().splitlines()], err


@pytest.fixture(scope="module")
def jax_runs(tim_file, tmp_path_factory):
    """The JAX engine's run of each scenario, computed once when first
    asked for: (best, records, exception). A clean run first warms the
    JAX engine's sec/gen estimate, as the port's probe seeds its own."""
    from timetabling_ga_tpu.runtime import engine as jengine
    tmp = tmp_path_factory.mktemp("jax_faults")
    cache = {}
    saved = jengine._purge_programs
    jengine._purge_programs = lambda mesh: None
    _run(jengine, JRunConfig, tim_file, dict(pipeline=False), tmp, "warm")

    def get(name, kw):
        if name not in cache:
            cache[name] = _run(jengine, JRunConfig, tim_file, kw, tmp, name)
        return cache[name]
    yield get
    jengine._purge_programs = saved


@pytest.fixture(scope="module")
def port_clean(tim_file, tmp_path_factory):
    """The port's clean runs, by generation budget."""
    from timetabling_ga_tpu_torch.runtime import engine as tengine
    tmp = tmp_path_factory.mktemp("port_clean")
    cache = {}

    def get(generations):
        if generations not in cache:
            cache[generations] = _run(
                tengine, TRunConfig, tim_file,
                dict(pipeline=False, generations=generations), tmp,
                f"clean{generations}")
        return cache[generations]
    return get


def _check_scenario(name, kw, end, tim_file, tmp_path, jax_runs,
                    port_clean):
    from timetabling_ga_tpu_torch.runtime import engine as tengine
    t0 = time.monotonic()
    best, lines, err = _run(tengine, TRunConfig, tim_file, kw, tmp_path,
                            name)
    wall = time.monotonic() - t0
    jbest, jlines, jerr = jax_runs(name, kw)
    assert _fault_seq(lines) == _fault_seq(jlines), name
    if end is None:
        assert err is None and jerr is None, (err, jerr)
        cbest, clean, _ = port_clean(kw.get("generations", 30))
        assert best == cbest
        if name != "ladder-2":
            # level 2 halves the dispatches, and migration then closes
            # the shortened epochs: another trajectory (JAX asserts only
            # the budget there)
            assert tjsonl.strip_timing(lines) == tjsonl.strip_timing(clean)
    elif end == "transient":
        assert tretry.is_transient(err) and jretry.is_transient(jerr)
    else:
        assert isinstance(err, tfaults.FaultInjected)
        assert isinstance(jerr, jfaults.FaultInjected)
    return lines, wall


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_fault_scenario_equals_jax(name, tim_file, tmp_path,
                                          jax_runs, port_clean):
    kw, end = SCENARIOS[name]
    lines, wall = _check_scenario(name, kw, end, tim_file, tmp_path,
                                  jax_runs, port_clean)
    fe = [x["faultEntry"] for x in lines if "faultEntry" in x]
    if name.startswith("fetch-hang"):
        assert "fetch watchdog" in fe[0]["error"]
        assert wall < tfaults.HANG_S
    if name == "degrade":
        loops = [x["phase"] for x in lines
                 if "phase" in x and x["phase"]["name"] == "gen-loop"]
        assert loops[0]["pipelined"] is False
    if name == "ladder-2":
        gens = [x["phase"]["gens"] for x in lines
                if "phase" in x and x["phase"]["name"] == "dispatch"]
        assert sum(gens) == 30 and 2 in gens
    if "checkpoint" in kw:
        with np.load(str(tmp_path / f"{name}.npz")) as z:
            assert int(z["generation"]) == (
                kw.get("generations", 30) if end is None else 0)
    if name == "exhausted":
        assert fe[-1]["site"] == "dispatch" and fe[-1]["action"] == "abort"
    if name in ("init-off", "non-transient"):
        assert fe == []


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SLOW_SCENARIOS))
def test_engine_fault_scenario_equals_jax_slow(name, tim_file, tmp_path,
                                               jax_runs, port_clean):
    kw, end = SLOW_SCENARIOS[name]
    from timetabling_ga_tpu_torch.runtime import engine as tengine
    best, lines, err = _run(tengine, TRunConfig, tim_file, kw, tmp_path,
                            name)
    jbest, jlines, jerr = jax_runs(name, kw)
    assert err is None and jerr is None
    assert _fault_seq(lines) == _fault_seq(jlines)
    clean = _run(tengine, TRunConfig, tim_file,
                 dict(kw, faults=None, trace_mode="full"), tmp_path,
                 name + "-clean")[1]
    assert tjsonl.strip_timing(lines) == tjsonl.strip_timing(clean)


def test_recovery_gauges_and_counters(tim_file, tmp_path):
    """The supervisor's registry state after a run with two recoveries
    and a ladder step, and the rehydrates' walls as `recover` spans (the
    run under --obs)."""
    from timetabling_ga_tpu_torch.runtime import engine as tengine
    rec0 = REGISTRY.counter("engine.recoveries").value
    inj0 = REGISTRY.counter("faults.injected").value
    _, lines, _ = _run(tengine, TRunConfig, tim_file,
                       dict(SCENARIOS["degrade"][0], obs=True), tmp_path,
                       "gauges")
    assert REGISTRY.counter("engine.recoveries").value - rec0 == 2
    assert REGISTRY.counter("faults.injected").value - inj0 == 2
    snap = REGISTRY.snapshot()["gauges"]
    assert snap["engine.degrade_level"] == 1
    assert snap["engine.recovery_budget_configured"] == 5
    assert snap["engine.recovery_budget_remaining"] == 3
    assert "engine.recovery_seconds" not in snap
    recover = [x["spanEntry"] for x in lines if "spanEntry" in x
               and x["spanEntry"]["name"] == "recover"]
    assert len(recover) == 2
    for span in recover:
        assert span["cat"] == "engine" and span["dur"] >= 0
        assert span["site"] == "dispatch" and span["level"] in (0, 1)
    assert snap["writer.queue_depth"] == 0


def test_supervisor_ladder_and_relax():
    """The ladder's steps inside the window and its steps back up, as
    JAX's Supervisor takes them."""
    from timetabling_ga_tpu.runtime import dispatch_core as jdcore
    cfg = TRunConfig(max_recoveries=3)
    jcfg = JRunConfig(max_recoveries=3)
    t, j = tdcore.Supervisor(cfg), jdcore.Supervisor(jcfg)
    assert t.WINDOW_S == j.WINDOW_S and t.MAX_LEVEL == j.MAX_LEVEL
    for now in (0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 400.0, 800.0, 1300.0,
                1301.0, 2000.0):
        for sup in (t, j):
            sup.escalate(now) if now < 500 or now == 1300.0 else None
        assert (t.level, t.dispatch_scale()) == (j.level, j.dispatch_scale())
        assert t.maybe_relax(now + 1.0) == j.maybe_relax(now + 1.0)
        assert t.level == j.level
    assert not tdcore.Supervisor(TRunConfig(max_recoveries=0)).enabled
    s = tdcore.Supervisor(cfg)
    assert s.classify(RuntimeError("UNAVAILABLE")) is None   # no snapshot
