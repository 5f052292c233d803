"""The port's fleet Gateway over one JAX replica and one port replica, in
process on the CPU, where wires cross the packages:

  - both replicas serve behind the port's gateway: a job of each bucket
    reaches `done`, each bucket on its own replica, with the records
    its replica's package gives unrouted;
  - a job running on the JAX replica, killed there, resumes on the port
    replica from the wire the port gateway cached (JAX's
    serve/snapshot.py format), and the other way round: the settled
    stream is the first package's shipped prefix, equal to that
    package's uninterrupted run's first records, followed by the other
    package's continuation from the wire, equal to that package's own
    resume of it; at most one quantum re-runs.

The gateway routes a fresh bucket to the lowest name at equal load, so
replica "a-..." takes the first job. JAX's replica serves one device
(--mesh-devices 1). The kill is placed by holding the source replica's
drive loop before a scheduler step.
"""

import io
import json
import threading
import time

import pytest
import torch

from timetabling_ga_tpu.fleet import replicas as jreplicas
from timetabling_ga_tpu.obs.metrics import MetricsRegistry as JRegistry
from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.problem import load_tim as jload_tim
from timetabling_ga_tpu.runtime import config as jconfig
from timetabling_ga_tpu.runtime import faults as jfaults
from timetabling_ga_tpu.serve.service import SolveService as JSolveService
from timetabling_ga_tpu_torch.fleet import replicas as treplicas
from timetabling_ga_tpu_torch.fleet.gateway import Gateway
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime import config as tconfig
from timetabling_ga_tpu_torch.runtime import faults as tfaults
from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
from timetabling_ga_tpu_torch.serve.service import SolveService

torch.set_num_threads(1)

_TIM_A = dump_tim(random_instance(71, n_events=12, n_rooms=3,
                                  n_features=2, n_students=8,
                                  attend_prob=0.2))
_TIM_B = dump_tim(random_instance(72, n_events=40, n_rooms=4,
                                  n_features=2, n_students=30,
                                  attend_prob=0.1))
_DEADLINE_S = 180.0
_TERMINAL = ("done", "failed", "cancelled", "shed", "rejected")


@pytest.fixture(autouse=True)
def _no_plans():
    tfaults.install(None)
    jfaults.install(None)
    yield
    tfaults.install(None)
    jfaults.install(None)


def _cfg(mod, **kw):
    for k, v in dict(backend="cpu", lanes=2, quantum=5, pop_size=4,
                     max_steps=8, http="127.0.0.1:0").items():
        kw.setdefault(k, v)
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


def _job_records(text, jid):
    out = []
    for line in text.splitlines():
        rec = json.loads(line)
        body = rec[next(iter(rec))]
        if isinstance(body, dict) and body.get("job") == jid:
            out.append(rec)
    return out


def _unrouted(jax, jobs, snapshot=None):
    """{id: strip_timing(records)} of `jobs` on a bare service of one
    package; `snapshot` warm-starts every job from that wire."""
    buf = io.StringIO()
    if jax:
        svc = JSolveService(_cfg(jconfig, http=None), out=buf,
                            registry=JRegistry())
    else:
        svc = SolveService(_cfg(tconfig, http=None), out=buf,
                           registry=MetricsRegistry())
    for jid, tim, seed, gens in jobs:
        problem = (jload_tim if jax else load_tim)(tim)
        kw = {} if snapshot is None else {"snapshot": snapshot}
        svc.submit(problem, job_id=jid, seed=seed, generations=gens, **kw)
    svc.drive()
    svc.close()
    return {jid: strip_timing(_job_records(buf.getvalue(), jid))
            for jid, *_ in jobs}


def _settled(url, ids):
    def views():
        vs = {j: treplicas.http_json("GET", f"{url}/v1/jobs/{j}",
                                     ok=(200,)) for j in ids}
        return vs if all(v["state"] in _TERMINAL
                         for v in vs.values()) else None
    return _until(views, f"{ids} settled")


def _gateway(urls, handles):
    return Gateway(tconfig.FleetConfig(
        replicas=list(urls), listen="127.0.0.1:0", probe_every=0.1,
        poll_every=0.05, dead_after=2), handles).start()


def test_gateway_routes_to_a_jax_and_a_port_replica():
    jobs = [("ga", _TIM_A, 1, 15), ("gb", _TIM_B, 2, 10)]
    jrep, _ = jreplicas.in_process_replica(_cfg(jconfig), "a-jax")
    trep, _ = treplicas.in_process_replica(_cfg(tconfig), "b-port")
    handles = [treplicas.ReplicaHandle("a-jax", jrep.url),
               treplicas.ReplicaHandle("b-port", trep.url)]
    gw = _gateway([jrep.url, trep.url], handles)
    try:
        for jid, tim, seed, gens in jobs[:1]:
            treplicas.http_json("POST", gw.url + "/v1/solve",
                                {"tim": tim, "id": jid, "seed": seed,
                                 "generations": gens})
        _settled(gw.url, ["ga"])
        # the second bucket goes to the replica with no pinned bucket
        for jid, tim, seed, gens in jobs[1:]:
            treplicas.http_json("POST", gw.url + "/v1/solve",
                                {"tim": tim, "id": jid, "seed": seed,
                                 "generations": gens})
        views = _settled(gw.url, ["ga", "gb"])
        assert views["ga"]["replica"] == "a-jax"
        assert views["gb"]["replica"] == "b-port"
        for jid, _, _, gens in jobs:
            assert views[jid]["state"] == "done"
            assert views[jid]["result"]["gens"] == gens
        assert strip_timing(views["ga"]["records"]) == _unrouted(
            True, jobs[:1])["ga"]
        assert strip_timing(views["gb"]["records"]) == _unrouted(
            False, jobs[1:])["gb"]
        assert gw.router.stats()["warmups"] == 2
    finally:
        gw.close()
        jrep.kill()
        trep.kill()


@pytest.mark.parametrize("src_jax", [True, False],
                         ids=["jax-to-port", "port-to-jax"])
def test_killed_job_resumes_across_the_packages(src_jax):
    """The job runs on replica "a-..." of one package, which is killed
    at a held fence; it resumes on replica "b-..." of the other package
    from the wire the port's gateway cached."""
    job = ("x", _TIM_A, 3, 60)
    src_mod, dst_mod = ((jreplicas, treplicas) if src_jax
                        else (treplicas, jreplicas))
    src, _ = src_mod.in_process_replica(
        _cfg(jconfig if src_jax else tconfig), "a-src")
    dst, _ = dst_mod.in_process_replica(
        _cfg(tconfig if src_jax else jconfig), "b-dst")
    sh = treplicas.ReplicaHandle("a-src", src.url)
    dh = treplicas.ReplicaHandle("b-dst", dst.url)
    # the payload the gateway sends the survivor: the cached wire
    sent = []
    real_post = dh.post_job

    def post_job(payload, **kw):
        sent.append(payload)
        return real_post(payload, **kw)
    dh.post_job = post_job
    # hold the source's drive loop once the job has 15 generations
    reached, release = threading.Event(), threading.Event()
    held = []
    real_step = src.svc.step

    def cached_gens():
        with gw.jobs_lock:
            return gw.jobs["x"].snap_gens if "x" in gw.jobs else -1

    def step():
        if not reached.is_set() and "x" in src.svc.queue:
            gens = src.svc.queue.get("x").gens_done
            # hold at a fence the gateway's cached wire is within a
            # quantum of: the flush a snapshot poll requests is taken by
            # this loop alone, so a hold before it would starve the cache
            if gens >= 15 and cached_gens() >= gens - 5:
                held.append(gens)
                reached.set()
                release.wait(_DEADLINE_S)
        if src._killed:
            return False
        return real_step()
    src.svc.step = step
    gw = _gateway([src.url, dst.url], [sh, dh])
    try:
        treplicas.http_json("POST", gw.url + "/v1/solve",
                            {"tim": job[1], "id": "x", "seed": job[2],
                             "generations": job[3]})
        assert reached.wait(_DEADLINE_S)

        def cached():
            with gw.jobs_lock:
                return gw.jobs["x"].snap_gens >= held[0] - 5
        _until(cached, "the source's wire in the gateway's cache")
        src.kill()
        release.set()
        view = _settled(gw.url, ["x"])["x"]
    finally:
        release.set()
        gw.close()
        src.kill()
        dst.kill()
    assert view["state"] == "done" and view["replica"] == "b-dst"
    wire = sent[-1]["snapshot"]
    fence = wire["gens_done"]
    assert view["result"]["resumed_at"] == fence > 0
    assert held[0] - fence <= 5                  # one quantum at most
    assert gw.registry.counter("fleet.resume.hits").value == 1
    # the seam: the source package's prefix, then the other's
    # continuation
    records = view["records"]
    seam = next(i for i, r in enumerate(records)
                if r.get("faultEntry", {}).get("site") == "fleet"
                and r["faultEntry"].get("action") == "resume")
    prefix, rest = strip_timing(records[:seam]), strip_timing(
        records[seam:])
    assert prefix and rest
    assert prefix == _unrouted(src_jax, [job])["x"][:len(prefix)]
    assert rest == _unrouted(not src_jax, [job], snapshot=wire)["x"]
    events = [r["jobEntry"]["event"] for r in records if "jobEntry" in r]
    assert events.count("admitted") == 1 and events.count("done") == 1
