"""Fault recovery and load shedding on the port's serve path (serve/
scheduler.py `_recover_quantum`, `_shed`, the `quantum`, `resume` and
`edit` fault sites; serve/service.py's AsyncWriter and fault plan)
against the JAX package, mirroring JAX tests/test_resume.py:238, :261
and tests/test_obs.py:926, :949:

  - a transient fault in a stacked quantum requeues only that
    dispatch's jobs from their park snapshots (a resident group's
    cursors rolled back): every stream, the faulted jobs' and their
    co-tenants', equals an uninjected run's under strip_timing;
  - a non-transient fault, or a job past --max-job-recoveries, fails
    that dispatch's jobs alone with a terminal jobEntry; the other
    bucket's job runs on unchanged;
  - --shed-queue-hwm sheds the lowest-priority runnable jobs with a
    `shed` jobEntry, as the JAX scheduler's `_shed` picks them, and the
    job left runs as it would alone; shedding is off by default; a
    writer mark sheds one job a fence;
  - a warm start whose admission fails at the `resume` site (an
    injected death included) replays from scratch with the plain
    stream, and an edit whose transplant fails at the `edit` site runs
    cold, each with its faultEntry.
"""

import io
import json

import pytest
import torch

from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.problem import load_tim as jload_tim
from timetabling_ga_tpu.runtime import faults as jfaults
from timetabling_ga_tpu.runtime.config import ServeConfig as JServeConfig
from timetabling_ga_tpu.serve.service import SolveService as JSolveService
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime import config as tconfig
from timetabling_ga_tpu_torch.runtime import faults as tfaults
from timetabling_ga_tpu_torch.runtime.config import ServeConfig
from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
from timetabling_ga_tpu_torch.serve.queue import JobState
from timetabling_ga_tpu_torch.serve.service import SolveService, serve_stream

torch.set_num_threads(1)

# JAX tests/test_resume.py's two shapes: two buckets
_TIM_A = dump_tim(random_instance(71, n_events=12, n_rooms=3, n_features=2,
                                  n_students=8, attend_prob=0.2))
_TIM_B = dump_tim(random_instance(72, n_events=40, n_rooms=4, n_features=2,
                                  n_students=30, attend_prob=0.1))


@pytest.fixture(autouse=True)
def _no_plans():
    tfaults.install(None)
    jfaults.install(None)
    yield
    tfaults.install(None)
    jfaults.install(None)


def _cfg(**kw):
    """JAX tests/test_resume.py's serve config, on the CPU."""
    kw.setdefault("backend", "cpu")
    kw.setdefault("lanes", 2)
    kw.setdefault("quantum", 5)
    kw.setdefault("pop_size", 4)
    kw.setdefault("max_steps", 8)
    return ServeConfig(**kw)


def _job_records(text, job_id):
    out = []
    for line in text.splitlines():
        rec = json.loads(line)
        body = rec[next(iter(rec))]
        if isinstance(body, dict) and body.get("job") == str(job_id):
            out.append(rec)
    return out


def _serve(jobs, plan=None, **kw):
    """Submit `jobs` ((id, tim, seed, generations[, priority])), drive,
    close; returns (service, record text)."""
    buf = io.StringIO()
    svc = SolveService(_cfg(**kw), out=buf, registry=MetricsRegistry())
    if plan:
        tfaults.install(plan)
    try:
        for jid, tim, seed, gens, *prio in jobs:
            svc.submit(load_tim(tim), job_id=jid, seed=seed,
                       generations=gens, priority=(prio or [0])[0])
        svc.drive()
    finally:
        tfaults.install(None)
        svc.close()
    return svc, buf.getvalue()


_BASE = {}


def _baseline(jobs):
    """{id: strip_timing(records)} of `jobs` on a bare service."""
    key = tuple(jobs)
    if key not in _BASE:
        _, text = _serve(jobs)
        _BASE[key] = {jid: strip_timing(_job_records(text, jid))
                      for jid, *_ in jobs}
    return _BASE[key]


def _faults(text, jid=None):
    return [(r["faultEntry"]["site"], r["faultEntry"]["action"],
             r["faultEntry"]["recovery"])
            for r in (json.loads(x) for x in text.splitlines())
            if "faultEntry" in r
            and (jid is None or r["faultEntry"].get("job") == jid)]


_JOBS = (("qa", _TIM_A, 3, 15), ("qb", _TIM_B, 4, 15))


@pytest.mark.parametrize("plan,resident", [
    ("quantum:2:unavailable", True), ("quantum:3:unavailable", True),
    ("quantum:4:unavailable", True), ("quantum:2:unavailable", False),
    ("quantum:1:unavailable,quantum:2:unavailable", True)])
def test_quantum_fault_requeues_from_snapshots(plan, resident):
    """JAX tests/test_resume.py:238: a transient quantum fault requeues
    only its dispatch's jobs; every job completes and every stream
    equals the uninjected run's. Quantum 3 and 4 fall on a resident
    group (a cursor rollback), two faults on one job use two of its
    recoveries."""
    base = _baseline(_JOBS)
    svc, text = _serve(_JOBS, plan, resident=resident)
    n_faults = plan.count(",") + 1
    assert svc.registry.counter("serve.job_recoveries").value == n_faults
    for jid, *_ in _JOBS:
        assert svc.queue.get(jid).state == JobState.DONE
        assert strip_timing(_job_records(text, jid)) == base[jid], jid
    assert [a for _, a, _ in _faults(text)] == ["requeue"] * n_faults


def test_quantum_fault_budget_exhausted_fails_alone():
    """JAX tests/test_resume.py:261: a non-transient quantum fault fails
    that dispatch's job with a terminal jobEntry; the other bucket's job
    runs on unchanged. Past --max-job-recoveries a transient one fails
    the job too, after its requeues."""
    base = _baseline(_JOBS)
    svc, text = _serve(_JOBS, "quantum:1:error")
    states = {jid: svc.queue.get(jid).state for jid, *_ in _JOBS}
    assert sorted(states.values()) == ["done", "failed"]
    failed = next(j for j, s in states.items() if s == "failed")
    survivor = next(j for j, s in states.items() if s == "done")
    assert strip_timing(_job_records(text, survivor)) == base[survivor]
    recs = _job_records(text, failed)
    assert any(r["jobEntry"]["event"] == "failed"
               and "quantum fault" in r["jobEntry"].get("reason", "")
               for r in recs if "jobEntry" in r)
    assert _faults(text, failed) == [("quantum", "abort", 1)]
    assert svc.result(failed) is None
    svc2, text2 = _serve([("fx", _TIM_A, 3, 15)],
                         "quantum:1:unavailable,quantum:2:unavailable",
                         max_job_recoveries=1)
    job = svc2.queue.get("fx")
    assert job.state == JobState.FAILED and job.recoveries == 2
    assert _faults(text2) == [("quantum", "requeue", 1),
                              ("quantum", "abort", 2)]
    assert svc2.registry.counter("serve.jobs_failed").value == 1


def test_max_job_recoveries_zero_fails_a_transient_at_once():
    base = _baseline(_JOBS)
    svc, text = _serve(_JOBS, "quantum:2:unavailable",
                       max_job_recoveries=0)
    states = {jid: svc.queue.get(jid).state for jid, *_ in _JOBS}
    assert sorted(states.values()) == ["done", "failed"]
    for jid, st in states.items():
        if st == "done":
            assert strip_timing(_job_records(text, jid)) == base[jid]


def _shed_jobs(n):
    return [(f"sj{i}", _TIM_A, i + 1, 10, n - i) for i in range(n)]


def test_shed_picks_what_jax_sheds():
    """JAX tests/test_obs.py:926: with three jobs and
    --shed-queue-hwm 2, the scheduler sheds the lowest-priority sj2,
    then sj1 — the JAX scheduler's `_shed` releases the same jobs in the
    same order — and sj0 runs as it would alone."""
    jsvc = JSolveService(JServeConfig(backend="cpu", lanes=2, quantum=5,
                                      pop_size=4, max_steps=8,
                                      mesh_devices=1, usage=False,
                                      shed_queue_hwm=2),
                         out=(jout := io.StringIO()))
    for jid, tim, seed, gens, prio in _shed_jobs(3):
        jsvc.submit(jload_tim(tim), job_id=jid, seed=seed,
                    generations=gens, priority=prio)
    jsvc.scheduler._shed()
    jsvc.close()
    want = [json.loads(x)["jobEntry"] for x in jout.getvalue().splitlines()
            if '"shed"' in x]
    svc, text = _serve(_shed_jobs(3), shed_queue_hwm=2)
    got = [json.loads(x)["jobEntry"] for x in text.splitlines()
           if '"shed"' in x]
    assert got == want
    assert [g["job"] for g in got] == ["sj2", "sj1"]
    assert all(g["reason"] == "queue_hwm" for g in got)
    assert svc.state("sj2") == JobState.SHED and svc.result("sj2") is None
    assert svc.registry.counter("serve.jobs_shed").value == 2
    alone = _baseline((_shed_jobs(3)[0],))
    assert strip_timing(_job_records(text, "sj0")) == alone["sj0"]


def test_shed_disabled_by_default():
    """JAX tests/test_obs.py:949."""
    _, text = _serve(_shed_jobs(2))
    assert '"shed"' not in text


def test_writer_mark_sheds_one_job_a_fence():
    """--shed-writer-hwm reads writer.queue_depth: a writer queue held at
    the mark sheds one job at each control fence (shedding does not
    drain the writer)."""
    svc = SolveService(_cfg(shed_writer_hwm=1), out=io.StringIO(),
                       registry=(reg := MetricsRegistry()))
    try:
        for jid, tim, seed, gens, prio in _shed_jobs(3):
            svc.submit(load_tim(tim), job_id=jid, seed=seed,
                       generations=gens, priority=prio)
        reg.gauge_fn("writer.queue_depth", lambda: 5)
        svc.scheduler._shed()
        assert [j.state for j in map(svc.queue.get, ("sj0", "sj1",
                                                     "sj2"))] == [
            JobState.PENDING, JobState.PENDING, JobState.SHED]
        svc.scheduler._shed()
        assert svc.state("sj1") == JobState.SHED
    finally:
        svc.close()


def test_serve_flags_parse_as_jax():
    """--faults, --max-job-recoveries and the shed marks are served with
    JAX's defaults and refusals."""
    from timetabling_ga_tpu.runtime import config as jconfig
    argv = ["--faults", "quantum:1:error", "--max-job-recoveries", "0",
            "--shed-queue-hwm", "3", "--shed-writer-hwm", "9"]
    j, t = jconfig.parse_serve_args(argv), tconfig.parse_serve_args(argv)
    d, dt = JServeConfig(), ServeConfig()
    for f in ("faults", "max_job_recoveries", "shed_queue_hwm",
              "shed_writer_hwm"):
        assert getattr(j, f) == getattr(t, f) and getattr(d, f) == \
            getattr(dt, f), f
    for bad in (["--shed-queue-hwm", "-1"], ["--shed-writer-hwm", "-2"],
                ["--max-job-recoveries", "-1"]):
        with pytest.raises(SystemExit) as want:
            jconfig.parse_serve_args(bad)
        with pytest.raises(SystemExit) as got:
            tconfig.parse_serve_args(bad)
        assert str(got.value) == str(want.value)


def test_the_serve_plan_installs_from_the_flag_and_records_drain():
    """serve_stream installs --faults (a requeue on the stream) and the
    records are all written when it returns."""
    reqs = "".join(json.dumps({"submit": {"id": jid, "tim": tim,
                                          "seed": seed,
                                          "generations": gens}}) + "\n"
                   for jid, tim, seed, gens in _JOBS)
    out = io.StringIO()
    try:
        svc = serve_stream(_cfg(faults="quantum:2:unavailable"),
                           io.StringIO(reqs), out,
                           registry=MetricsRegistry())
    finally:
        tfaults.install(None)
    assert _faults(out.getvalue()) == [("quantum", "requeue", 1)]
    base = _baseline(_JOBS)
    for jid, *_ in _JOBS:
        assert svc.state(jid) == JobState.DONE
        assert strip_timing(_job_records(out.getvalue(), jid)) == base[jid]


@pytest.mark.parametrize("action", ["unavailable", "die", "error"])
def test_resume_site_fault_replays(action):
    """A warm start whose admission fails at the `resume` site, an
    injected thread death included, replays from scratch: faultEntry
    resume / replay, serve.jobs_resume_rejected, the plain stream."""
    base = _baseline((("d", _TIM_A, 3, 10),))
    buf1 = io.StringIO()
    svc1 = SolveService(_cfg(), out=buf1, registry=MetricsRegistry())
    svc1.submit(load_tim(_TIM_A), job_id="w", seed=3, generations=10)
    svc1.step()
    wire = svc1.queue.get("w").ship.pack()
    svc1.close()
    buf = io.StringIO()
    svc = SolveService(_cfg(), out=buf, registry=MetricsRegistry())
    tfaults.install(f"resume:1:{action}")
    try:
        svc.submit(load_tim(_TIM_A), job_id="d", seed=3, generations=10,
                   snapshot=wire)
        svc.drive()
    finally:
        tfaults.install(None)
        svc.close()
    recs = _job_records(buf.getvalue(), "d")
    assert strip_timing(recs) == base["d"]
    assert _faults(buf.getvalue(), "d") == [("resume", "replay", 0)]
    assert svc.registry.counter("serve.jobs_resume_rejected").value == 1


def test_edit_site_fault_runs_cold():
    """An edit whose transplant fails at the `edit` site runs cold: one
    faultEntry edit / demote, demoted on its admitted and done records
    and in its result, its whole budget run."""
    base_tim = dump_tim(random_instance(93, n_events=10, n_rooms=3,
                                        n_features=2, n_students=8,
                                        attend_prob=0.2))
    cfg = dict(quantum=10, pop_size=6)
    b = SolveService(_cfg(**cfg), out=io.StringIO(),
                     registry=MetricsRegistry())
    b.submit(load_tim(base_tim), job_id="base", seed=5, generations=20)
    b.drive()
    b.close()
    wire = json.loads(json.dumps(b.queue.get("base").ship.pack()))
    spec = {"base": {"tim": base_tim}, "base_id": "base", "w_anchor": 1,
            "snapshot": wire,
            "ops": [{"op": "add_event", "students": [2], "features": []},
                    {"op": "remove_event", "event": 4}]}
    buf = io.StringIO()
    svc = SolveService(_cfg(**cfg), out=buf,
                       registry=(reg := MetricsRegistry()))
    # JAX's SITES (kept as it is) holds no `edit`: no parsed plan reaches
    # the site, in either package, so its entry is installed directly
    tfaults._PLAN = tfaults.FaultPlan({"edit": {1: "unavailable"}})
    try:
        svc.submit(None, job_id="ed", seed=6, generations=10, edit=spec)
        svc.drive()
    finally:
        tfaults.install(None)
        svc.close()
    assert _faults(buf.getvalue(), "ed") == [("edit", "demote", 0)]
    ev = {r["jobEntry"]["event"]: r["jobEntry"]
          for r in _job_records(buf.getvalue(), "ed") if "jobEntry" in r}
    assert sorted(ev) == ["admitted", "done", "started"]   # a cold solve
    assert ev["admitted"]["demoted"] is True and ev["done"]["demoted"]
    res = svc.result("ed")
    assert res["edit_demoted"] is True and res["gens"] == 10
    c = reg.snapshot()["counters"]
    assert c["serve.jobs_edit_demoted"] == 1
    assert c.get("serve.jobs_resumed", 0) == 0
