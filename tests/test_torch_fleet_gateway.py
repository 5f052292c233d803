"""The port's fleet Gateway (timetabling_ga_tpu_torch/fleet/gateway.py)
over in-process port replicas on the CPU, held to the properties JAX's
fleet tests hold its own gateway to:

  - tests/test_fleet.py:416: a two-bucket stream keeps each bucket on
    one replica (affinity >= 0.9 after warm-up); a replica killed while
    it holds jobs in flight loses none; every job's records equal the
    unrouted service's under strip_timing, failed-over jobs included;
  - :502 a cancel survives the failover, :534 a drain finishes parked
    jobs and drains an owned replica, :571 / :598 the `gateway` and
    `route` fault sites park or end the gateway's own threads only,
    :636 `submit` round-trips a file with the unrouted records;
  - tests/test_resume.py:420: with --snapshot-hwm 1 every wire is
    evicted and a killed replica's job replays from generation 0;
    :521: a killed replica's job resumes from the gateway's cached wire,
    re-running at most one quantum (and the failover writes one
    stitched incident bundle); :600: a targeted
    `?mode=preempt&replica=NAME` moves the job with 0 generations
    re-run and the replica exits;
  - tests/test_fleet_obs.py:330: the gateway's and the replica's spans
    share the job's cross-process flow; /metrics families, the SLO burn
    on /readyz and on the log, routeEntry records, the stitched trace,
    `stats`; /v1/usage is the sum of the replicas';
  - tests/test_scale.py:486: a dead scaler does not stall settlement;
    an autoscaler over an in-process spawn pool scales up under a burst
    and down through the preempt drain, losing no job.

Every wait has its own deadline, and a kill or a preemption is placed by
holding the owner's drive loop before a scheduler step (no sleeps).
Instances of 12 and 40 events, lanes 2, quantum 5, pop 4, -m 8.
"""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu_torch.fleet.client import main_submit
from timetabling_ga_tpu_torch.fleet.gateway import Gateway
from timetabling_ga_tpu_torch.fleet.replicas import (
    http_json, http_text, in_process_replica)
from timetabling_ga_tpu_torch.obs import flight
from timetabling_ga_tpu_torch.obs import scrape as obs_scrape
from timetabling_ga_tpu_torch.obs import usage as obs_usage
from timetabling_ga_tpu_torch.obs.logstats import summarize
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
from timetabling_ga_tpu_torch.obs.spans import XFLOW_BASE
from timetabling_ga_tpu_torch.obs.trace_export import export_stitched
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime import faults, jsonl
from timetabling_ga_tpu_torch.runtime.config import (
    FleetConfig, ServeConfig)
from timetabling_ga_tpu_torch.serve.service import SolveService

torch.set_num_threads(1)

_SHAPE_A = dict(n_events=12, n_rooms=3, n_features=2, n_students=8,
                attend_prob=0.2)
_SHAPE_B = dict(n_events=40, n_rooms=4, n_features=2, n_students=30,
                attend_prob=0.1)
_TIM_A = dump_tim(random_instance(71, **_SHAPE_A))
_TIM_B = dump_tim(random_instance(72, **_SHAPE_B))
_DEADLINE_S = 120.0
_TERMINAL = ("done", "failed", "cancelled", "shed", "rejected")


@pytest.fixture(autouse=True)
def _no_plan():
    faults.install(None)
    yield
    faults.install(None)


def _tim(seed, shape):
    return dump_tim(random_instance(seed, **shape))


def _serve_cfg(**kw):
    for k, v in dict(backend="cpu", lanes=2, quantum=5, pop_size=4,
                     max_steps=8, http="127.0.0.1:0").items():
        kw.setdefault(k, v)
    return ServeConfig(**kw)


def _fleet_cfg(urls, **kw):
    for k, v in dict(listen="127.0.0.1:0", probe_every=0.1,
                     poll_every=0.05, dead_after=2).items():
        kw.setdefault(k, v)
    return FleetConfig(replicas=list(urls), **kw)


def _until(fn, what, timeout=_DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _job_records(text, jid):
    out = []
    for line in text.splitlines():
        rec = json.loads(line)
        body = rec[next(iter(rec))]
        if isinstance(body, dict) and body.get("job") == jid:
            out.append(rec)
    return out


def _baseline(jobs):
    """{id: strip_timing(records)} of `jobs` ((id, tim, seed, gens)) on
    a bare port service: the unrouted run."""
    buf = io.StringIO()
    svc = SolveService(_serve_cfg(http=None), out=buf,
                       registry=MetricsRegistry())
    for jid, tim, seed, gens in jobs:
        svc.submit(load_tim(tim), job_id=jid, seed=seed, generations=gens)
    svc.drive()
    svc.close()
    return {jid: jsonl.strip_timing(_job_records(buf.getvalue(), jid))
            for jid, *_ in jobs}


def _post(gw, jobs):
    for jid, tim, seed, gens in jobs:
        http_json("POST", gw.url + "/v1/solve",
                  {"tim": tim, "id": jid, "seed": seed,
                   "generations": gens})


def _settled(url, ids, timeout=_DEADLINE_S):
    """{id: view} once every id is terminal at the front `url`."""
    def views():
        vs = {j: http_json("GET", f"{url}/v1/jobs/{j}", ok=(200,))
              for j in ids}
        return vs if all(v["state"] in _TERMINAL
                         for v in vs.values()) else None
    return _until(views, f"{ids} settled", timeout)


class _Hold:
    """Holds the drive loop of the first of `reps` whose job table
    meets `pred` before its next scheduler step, once: `reached` is set
    with `rep` and `gens` (the held job's progress, stable while held),
    and the step waits for `release`. A replica killed while held
    steps no more."""

    def __init__(self, reps, pred):
        self.reached, self.release = threading.Event(), threading.Event()
        self.rep = self.gens = None
        lock = threading.Lock()
        for rep in reps:
            real = rep.svc.step

            def step(rep=rep, real=real):
                with lock:
                    hit = not self.reached.is_set() and pred(rep)
                    if hit:
                        self.rep, self.gens = rep, hit
                        self.reached.set()
                if hit:
                    self.release.wait(_DEADLINE_S)
                if rep._killed:
                    return False
                return real()
            rep.svc.step = step

    def wait(self):
        assert self.reached.wait(_DEADLINE_S), "hold never reached"
        return self.rep


def _progress(jid, at_least):
    """A _Hold predicate: `jid` active on the replica with at least
    `at_least` generations done; returns its progress."""
    def pred(rep):
        if jid not in rep.svc.queue:
            return 0
        job = rep.svc.queue.get(jid)
        ok = job in rep.svc.queue.active() and job.gens_done >= at_least
        return job.gens_done if ok else 0
    return pred


def _events(view):
    return [r["jobEntry"]["event"] for r in view["records"]
            if "jobEntry" in r]


def _close(gw, *reps):
    gw.close()
    for rep in reps:
        rep.kill()


# ------------------------------------------------------ tests/test_fleet.py


def test_affinity_failover_and_record_identity():
    rep0, h0 = in_process_replica(_serve_cfg(), "r0")
    rep1, h1 = in_process_replica(_serve_cfg(), "r1")
    gw = Gateway(_fleet_cfg([h0.url, h1.url]), [h0, h1]).start()
    phase1 = [(f"p1-{i}", _tim(100 + i, _SHAPE_A if i % 2 == 0
                               else _SHAPE_B), i, 10) for i in range(8)]
    phase2 = [(f"p2-{i}", _tim(200 + i, _SHAPE_A if i % 2 == 0
                               else _SHAPE_B), 50 + i, 40)
              for i in range(6)]
    try:
        _post(gw, phase1)
        views1 = _settled(gw.url, [j[0] for j in phase1])
        assert all(v["state"] == "done" for v in views1.values())
        stats = gw.router.stats()
        assert stats["affinity_hit_rate"] >= 0.9
        assert sorted(stats["pins"].values()) == ["r0", "r1"]
        # r0 is killed while it holds a phase-2 job in flight
        hold = _Hold([rep0], lambda rep: any(
            j.id.startswith("p2-") for j in rep.svc.queue.active()))
        _post(gw, phase2)
        hold.wait()
        rep0.kill()
        hold.release.set()
        views = _settled(gw.url, [j[0] for j in phase1 + phase2])
        base = _baseline(phase1 + phase2)
        for jid, v in views.items():
            assert v["state"] == "done", (jid, v["error"])
            assert _events(v).count("done") == 1, jid
            assert sum(1 for r in v["records"] if "solution" in r) == 1
            assert jsonl.strip_timing(v["records"]) == base[jid], jid
        assert gw.replicas.get("r0").dead
        assert gw.registry.counter("fleet.jobs_failed_over").value >= 1
    finally:
        _close(gw, rep0, rep1)


def test_cancel_survives_failover():
    rep0, h0 = in_process_replica(_serve_cfg(), "c0")
    rep1, h1 = in_process_replica(_serve_cfg(), "c1")
    gw = Gateway(_fleet_cfg([h0.url, h1.url]), [h0, h1]).start()
    try:
        hold = _Hold([rep0, rep1], _progress("cx", 5))
        _post(gw, [("cx", _TIM_A, 1, 5000)])
        victim = hold.wait()
        victim.kill()
        hold.release.set()
        http_json("DELETE", gw.url + "/v1/jobs/cx", ok=(202,))
        view = _settled(gw.url, ["cx"])["cx"]
        assert view["state"] == "cancelled", view
    finally:
        _close(gw, rep0, rep1)


def test_drain_finishes_parked_jobs():
    rep, handle = in_process_replica(_serve_cfg(), "rd")
    gw = Gateway(_fleet_cfg([handle.url]), [handle], owned=True).start()
    try:
        ids = [f"d{i}" for i in range(3)]
        _post(gw, [(jid, _tim(300 + i, _SHAPE_A), i, 15)
                   for i, jid in enumerate(ids)])
        http_json("POST", gw.url + "/v1/drain", {}, ok=(200,))
        refused = http_json("POST", gw.url + "/v1/solve",
                            {"tim": _TIM_A}, ok=(503,))
        assert "draining" in refused.get("reasons", [])
        assert gw.drained.wait(_DEADLINE_S), "the drain never completed"
        for jid in ids:
            v = http_json("GET", f"{gw.url}/v1/jobs/{jid}", ok=(200,))
            assert v["state"] == "done" and v["result"]["gens"] == 15
        assert rep.drained.wait(_DEADLINE_S)      # the owned replica too
    finally:
        _close(gw, rep)


def test_wedged_gateway_never_stalls_replica():
    rep, handle = in_process_replica(_serve_cfg(), "ri")
    try:
        gw = Gateway(_fleet_cfg([handle.url], faults="gateway:1:hang"),
                     [handle]).start()
        try:
            http_json("POST", rep.url + "/v1/solve",
                      {"tim": _TIM_A, "id": "iso1", "seed": 3,
                       "generations": 10})
            assert _settled(rep.url, ["iso1"])["iso1"]["state"] == "done"
        finally:
            gw.close()
            faults.install(None)
    finally:
        rep.stop(timeout=_DEADLINE_S)
        assert rep.drained.is_set() and not rep.svc.writer.alive()


def test_route_die_ends_the_dispatcher_only():
    rep, handle = in_process_replica(_serve_cfg(), "rj")
    gw = Gateway(_fleet_cfg([handle.url], faults="route:1:die"),
                 [handle]).start()
    try:
        _post(gw, [("dead1", _TIM_A, 4, 10)])
        _until(lambda: http_json("GET", gw.url + "/healthz",
                                 ok=(200, 503))["probes"].get(
            "dispatcher") is False, "the dispatcher's death on /healthz")
        view = http_json("GET", gw.url + "/v1/jobs/dead1", ok=(200,))
        assert view["state"] == "accepted"
        http_json("POST", rep.url + "/v1/solve",
                  {"tim": _TIM_A, "id": "alive1", "seed": 5,
                   "generations": 10})
        assert _settled(rep.url, ["alive1"])["alive1"]["state"] == "done"
    finally:
        faults.install(None)
        _close(gw, rep)


def test_submit_round_trip(tmp_path, capsys):
    tim_path = os.path.join(tmp_path, "instance.tim")
    with open(tim_path, "w") as fh:
        fh.write(_TIM_A)
    rep, handle = in_process_replica(_serve_cfg(), "rs")
    gw = Gateway(_fleet_cfg([handle.url]), [handle]).start()
    try:
        tail_path = os.path.join(tmp_path, "cli1.jsonl")
        rc = main_submit([gw.url, tim_path, "--id", "cli1", "-s", "9",
                          "--generations", "10", "--poll", "0.1",
                          "--records", "--records-out", tail_path])
        assert rc == 0
        out = json.loads(capsys.readouterr().out.strip())
        assert (out["state"], out["id"], out["replica"]) == (
            "done", "cli1", "rs")
        assert jsonl.strip_timing(out["records"]) == _baseline(
            [("cli1", _TIM_A, 9, 10)])["cli1"]
        with open(tail_path) as fh:
            assert [json.loads(x) for x in fh if x.strip()] \
                == out["records"]
    finally:
        gw.request_drain()
        gw.drained.wait(_DEADLINE_S)
        gw.close()
        rep.stop(timeout=_DEADLINE_S)


# ----------------------------------------------------- tests/test_resume.py


def test_evicted_wires_fail_over_by_replay():
    jobs = [("e0", _TIM_A, 3, 60)]
    rep0, h0 = in_process_replica(_serve_cfg(), "e0r")
    rep1, h1 = in_process_replica(_serve_cfg(), "e1r")
    gw = Gateway(_fleet_cfg([h0.url, h1.url], snapshot_hwm=1),
                 [h0, h1]).start()
    try:
        hold = _Hold([rep0, rep1], _progress("e0", 10))
        _post(gw, jobs)
        owner = hold.wait()
        _until(lambda: gw.registry.counter(
            "fleet.resume.evictions").value >= 1, "an eviction")
        with gw.jobs_lock:
            assert gw.jobs["e0"].snap is None
        owner.kill()
        hold.release.set()
        v = _settled(gw.url, ["e0"])["e0"]
        assert v["state"] == "done"
        assert gw.registry.counter("fleet.resume.replays").value >= 1
        assert gw.registry.counter("fleet.resume.hits").value == 0
        assert jsonl.strip_timing(v["records"]) == _baseline(jobs)["e0"]
    finally:
        _close(gw, rep0, rep1)


def test_kill_resumes_not_replays(tmp_path):
    """...and the failover writes one stitched incident bundle (the
    gateway's rings and the dead replica's entry)."""
    jobs = [("ra", _TIM_A, 3, 100), ("rb", _TIM_B, 4, 40)]
    rep0, h0 = in_process_replica(_serve_cfg(), "a0")
    rep1, h1 = in_process_replica(_serve_cfg(), "a1")
    inc = str(tmp_path / "inc")
    gw = Gateway(_fleet_cfg([h0.url, h1.url], incident_dir=inc,
                            incident_min_interval=0.0),
                 [h0, h1], out=io.StringIO()).start()
    try:
        hold = _Hold([rep0, rep1], _progress("ra", 20))
        _post(gw, jobs)
        owner = hold.wait()
        dead_gens = hold.gens

        def cached():
            with gw.jobs_lock:
                return gw.jobs["ra"].snap_gens >= max(5, dead_gens - 5)
        _until(cached, "ra's wire in the gateway's cache")
        owner.kill()
        hold.release.set()
        views = _settled(gw.url, ["ra", "rb"])
        assert all(v["state"] == "done" for v in views.values())
        res = views["ra"]["result"]
        assert 0 < res["resumed_at"] and dead_gens - res["resumed_at"] <= 5
        assert gw.registry.counter("fleet.resume.hits").value >= 1
        assert "tt_fleet_resume_hits_total 1" in http_text(
            gw.url + "/metrics")
        base = _baseline(jobs)
        for jid, v in views.items():
            assert _events(v).count("done") == 1, jid
            assert sum(1 for r in v["records"] if "solution" in r) == 1
            assert jsonl.strip_timing(v["records"]) == base[jid], jid
    finally:
        _close(gw, rep0, rep1)
    cores = [flight.load_bundle(p) for p in flight.list_bundles(inc)]
    failovers = [c for c in cores
                 if c["trigger"] == f"failover:{owner.name}"]
    assert len(failovers) == 1, [c["trigger"] for c in cores]
    core = failovers[0]
    assert core["process"] == "gateway" and core["stitched"] is True
    assert [p["label"] for p in core["peers"]] == [owner.name]
    assert core["trace"]["traceEvents"]


def test_targeted_preempt_moves_the_job_losslessly():
    jobs = [("px", _TIM_A, 3, 100)]
    rep0, h0 = in_process_replica(_serve_cfg(preempt_grace=30.0), "s0")
    rep1, h1 = in_process_replica(_serve_cfg(preempt_grace=30.0), "s1")
    reps = {"s0": rep0, "s1": rep1}
    gw = Gateway(_fleet_cfg([h0.url, h1.url]), [h0, h1]).start()
    try:
        hold = _Hold([rep0, rep1], _progress("px", 10))
        _post(gw, jobs)
        owner_rep = hold.wait()
        owner = next(n for n, r in reps.items() if r is owner_rep)
        sent = threading.Event()
        real_put = owner_rep.inbox.put

        def put(cmd):
            real_put(cmd)
            if cmd == ("drain", "preempt"):
                sent.set()
        owner_rep.inbox.put = put
        ack = http_json("POST",
                        f"{gw.url}/v1/drain?mode=preempt&replica={owner}",
                        {}, ok=(202,))
        assert ack == {"preempting": owner}
        assert sent.wait(_DEADLINE_S)
        hold.release.set()
        v = _settled(gw.url, ["px"])["px"]
        assert v["state"] == "done" and v["replica"] != owner
        assert owner_rep.drained.wait(_DEADLINE_S)
        assert gw.registry.counter("fleet.resume.hits").value >= 1
        # 0 generations re-run: resumed at the preempted fence
        assert v["result"]["resumed_at"] \
            == owner_rep.svc.queue.get("px").gens_done > 0
        assert jsonl.strip_timing(v["records"]) == _baseline(jobs)["px"]
    finally:
        _close(gw, rep0, rep1)


# --------------------------------------------------- tests/test_fleet_obs.py


def _spans(recs, **match):
    return [r["spanEntry"] for r in recs if "spanEntry" in r
            and all(r["spanEntry"].get(k) == v for k, v in match.items())]


def test_obs_flows_metrics_slo_usage_and_identity():
    rep, handle = in_process_replica(_serve_cfg(obs=True), "r0")
    gwbuf = io.StringIO()
    gw = Gateway(_fleet_cfg([handle.url], slo_p99=0.001,
                            metrics_every=10), [handle], out=gwbuf).start()
    jobs = [(f"fo-{i}", _tim(700 + i, _SHAPE_A), 40 + i, 8)
            for i in range(2)]
    try:
        _post(gw, jobs)
        views = _settled(gw.url, [j[0] for j in jobs])
        assert all(v["state"] == "done" for v in views.values())
        fams = obs_scrape.parse_exposition(http_text(gw.url + "/metrics"))
        assert obs_scrape.scalar(fams, "tt_fleet_jobs_done_total") == 2.0
        assert (obs_scrape.scalar(fams, "tt_fleet_route_warm_total", 0.0)
                + obs_scrape.scalar(fams, "tt_fleet_route_hit_total",
                                    0.0)) >= 2.0
        assert obs_scrape.scalar(fams, "tt_fleet_replica_r0_ready") == 1.0
        assert obs_scrape.scalar(fams, "tt_fleet_replica_r0_pins") >= 1.0
        assert obs_scrape.scalar(fams, "tt_fleet_tick_seconds_count") > 0
        assert obs_scrape.labeled(fams, "tt_fleet_job_seconds_bucket",
                                  le="+Inf") == 2.0
        assert '# {job="fo-' in http_text(gw.url + "/metrics")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(gw.url + "/readyz", timeout=5)
        assert e.value.code == 503
        assert "slo_burn" in json.loads(e.value.read())["reasons"]
        # /v1/usage: the replicas' ledgers summed, once probed

        def usage_agrees():
            fleet = http_json("GET", gw.url + "/v1/usage", ok=(200,))
            want = obs_usage.aggregate([("r0", False, http_json(
                "GET", rep.url + "/v1/usage", ok=(200,)))])
            return fleet if (fleet["tenants"], fleet["jobs"]) == (
                want["tenants"], want["jobs"]) else None
        fleet = _until(usage_agrees, "/v1/usage equal to the replica's")
        assert set(fleet["jobs"]) == {"fo-0", "fo-1"}
        assert sum(t["flops"] for t in fleet["tenants"].values()) > 0
    finally:
        gw.request_drain()
        gw.drained.wait(_DEADLINE_S)
        gw.close()
        rep.stop(timeout=_DEADLINE_S)
    gwrecs = [json.loads(x) for x in gwbuf.getvalue().splitlines()]
    reprecs = [json.loads(x) for x in rep.tail._stream.getvalue()
               .splitlines()]
    routed = _spans(gwrecs, name="routed", job="fo-0")
    assert routed and routed[0]["flow"] >= XFLOW_BASE
    flow = routed[0]["flow"]
    admit = _spans(reprecs, name="admit", job="fo-0")
    assert admit and admit[0]["flow"] == flow
    for name in ("route", "submit", "settle"):
        ss = _spans(gwrecs, name=name, job="fo-0")
        assert ss and all(s["flow"] == flow for s in ss)
    routes = [r["routeEntry"] for r in gwrecs if "routeEntry" in r]
    assert {r["job"] for r in routes} == {"fo-0", "fo-1"}
    assert all(r["replica"] == "r0" and r["outcome"] in (
        "hit", "warm", "miss") and "compile_hit_rate" in r
        for r in routes)
    assert any(r["faultEntry"]["site"] == "slo_burn"
               and r["faultEntry"]["action"] == "burn"
               for r in gwrecs if "faultEntry" in r)
    assert any("metricsEntry" in r for r in gwrecs)
    doc = export_stitched([("gateway.jsonl", gwrecs),
                           ("replica.jsonl", reprecs)], job="fo-0")
    chain = [e for e in doc["traceEvents"]
             if e.get("ph") in ("s", "t", "f") and e["id"] == flow]
    assert {e["pid"] for e in chain} == {0, 1}
    text = summarize(gwrecs + reprecs)
    assert "placements" in text and "r0: 2 placements" in text
    base = _baseline(jobs)
    for jid, v in views.items():
        assert jsonl.strip_timing(v["records"]) == base[jid], jid


# ------------------------------------------------------- tests/test_scale.py


def test_dead_scaler_never_stalls_settlement():
    rep, handle = in_process_replica(_serve_cfg(), "r0")
    cfg = _fleet_cfg([handle.url], history_every=0.2, scale_max=2,
                     scale_every=0.05, scale_dry_run=True,
                     faults="scaler:1:die")
    gw = Gateway(cfg, [handle]).start()
    try:
        _until(lambda: not gw.scaler.alive(), "the scaler's death")
        _post(gw, [("after-death", _TIM_A, 1, 6)])
        assert _settled(gw.url, ["after-death"])["after-death"][
            "state"] == "done"
    finally:
        faults.install(None)
        gw.request_drain()
        gw.drained.wait(_DEADLINE_S)
        _close(gw, rep)


def test_autoscaler_up_under_burst_down_through_preempt():
    """One replica, --scale-max 2: a sustained backlog spawns a second
    (an in-process replica through the spawn seam), which serves; once
    idle the policy retires one through the preempt drain; every job
    settles once with the unrouted records."""
    spawned = []

    def spawn(name):
        rep, handle = in_process_replica(
            _serve_cfg(preempt_grace=30.0), name)
        spawned.append(rep)
        return handle
    rep0, h0 = in_process_replica(_serve_cfg(preempt_grace=30.0), "r0")
    gwbuf = io.StringIO()
    cfg = _fleet_cfg([h0.url], history_every=0.05, scale_min=1,
                     scale_max=2, scale_up_queue=3.0, scale_up_for=0.3,
                     scale_down_queue=0.0, scale_down_for=0.3,
                     scale_idle_window=0.3, scale_cooldown=0.0,
                     scale_every=0.05, scale_warm_recent=0.0)
    gw = Gateway(cfg, [h0], spawn_fn=spawn, out=gwbuf).start()
    burst = [(f"b{i}", _tim(800 + i, _SHAPE_A if i % 2 else _SHAPE_B),
              i, 20) for i in range(6)]
    # a bucket of its own, sent once the new replica is up: the least
    # loaded, least pinned replica takes it
    fresh = [("c0", _tim(900, dict(_SHAPE_B, n_events=70)), 7, 10)]
    try:
        _post(gw, burst)
        _until(lambda: gw.registry.counter("fleet.scale.ups").value >= 1,
               "a scale-up")
        adopted = _until(lambda: next(
            (h for h in gw.replicas.all() if h.name != "r0" and h.ready),
            None), "the spawned replica ready")
        _settled(gw.url, [j[0] for j in burst])
        _post(gw, fresh)
        views = _settled(gw.url, [j[0] for j in burst + fresh])
        assert views["c0"]["replica"] == adopted.name
        _until(lambda: gw.registry.counter(
            "fleet.scale.downs").value >= 1, "a scale-down")
        retired = next(h for h in gw.replicas.all() if h.retired)
        victim = next(r for r in [rep0] + spawned
                      if r.name == retired.name)
        assert victim.drained.wait(_DEADLINE_S)
        base = _baseline(burst + fresh)
        for jid, v in views.items():
            assert v["state"] == "done" and _events(v).count("done") == 1
            assert jsonl.strip_timing(v["records"]) == base[jid], jid
        entries = [json.loads(x)["scaleEntry"]
                   for x in gwbuf.getvalue().splitlines()
                   if "scaleEntry" in x]
        acted = [(e["action"], e["reason"]) for e in entries
                 if not e.get("blocked")]
        assert acted[0] == ("up", "queue_depth")
        assert ("down", "idle") in acted
    finally:
        _close(gw, rep0, *spawned)
