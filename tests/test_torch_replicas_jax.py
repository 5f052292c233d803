"""The port's fleet replica beside JAX's fleet on the CPU:

  - a wire a port replica published for its preempted job warm-starts a
    JAX replica's job, and a JAX replica's wire a port replica's job;
    each continues at the wire's fence (its result's resumed_at, the
    seam's faultEntry fleet/resume at that generation, no init);
  - a job preempted on one port replica and resumed on another gives,
    shipped prefix plus continuation, the records of an uninterrupted
    port run under strip_timing;
  - JAX's Gateway (timetabling_ga_tpu.fleet.gateway, with JAX's
    ReplicaHandle, as in tests/test_fleet.py:68-73) routes two jobs to
    one port replica: both reach `done` with their results, and their
    record tails on the gateway's GET /v1/jobs/<id> are the port's
    unrouted records under strip_timing.

Instances of 12 events, lanes 2, quantum 5, pop 4, -m 8; JAX's replicas
serve one device (--mesh-devices 1). A preemption is placed at a known
fence by holding the port replica's drive loop before a step.
"""

import io
import json
import threading
import time

import pytest
import torch

from timetabling_ga_tpu.fleet import replicas as jreplicas
from timetabling_ga_tpu.fleet.gateway import Gateway
from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.runtime import config as jconfig
from timetabling_ga_tpu_torch.fleet import replicas as treplicas
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime import config as tconfig
from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
from timetabling_ga_tpu_torch.serve.service import SolveService

torch.set_num_threads(1)

_TIM = dump_tim(random_instance(71, n_events=12, n_rooms=3, n_features=2,
                                n_students=8, attend_prob=0.2))
_TIM_B = dump_tim(random_instance(72, n_events=40, n_rooms=4,
                                  n_features=2, n_students=30,
                                  attend_prob=0.1))
_DEADLINE_S = 120.0


def _cfg(mod, **kw):
    kw.setdefault("backend", "cpu")
    kw.setdefault("lanes", 2)
    kw.setdefault("quantum", 5)
    kw.setdefault("pop_size", 4)
    kw.setdefault("max_steps", 8)
    kw.setdefault("http", "127.0.0.1:0")
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


def _baseline(jobs):
    """{id: strip_timing(records)} of `jobs` on a bare port service."""
    buf = io.StringIO()
    svc = SolveService(_cfg(tconfig, http=None), out=buf,
                       registry=MetricsRegistry())
    for jid, tim, seed, gens in jobs:
        svc.submit(load_tim(tim), job_id=jid, seed=seed, generations=gens)
    svc.drive()
    svc.close()
    return {jid: strip_timing(_job_records(buf.getvalue(), jid))
            for jid, *_ in jobs}


def _hold_before_step(rep, n):
    """Hold `rep`'s drive loop before its `n`th scheduler step: returns
    (reached, release) events."""
    real = rep.svc.step
    calls = [0]
    reached, release = threading.Event(), threading.Event()

    def step():
        calls[0] += 1
        if calls[0] == n:
            reached.set()
            release.wait(_DEADLINE_S)
        return real()
    rep.svc.step = step
    return reached, release


def _preempted_wire(replicas_mod, rep, handle, jid):
    """Preempt `rep` and fetch `jid`'s view once it reads `preempted`:
    the view carries the wire and its record prefix."""
    replicas_mod.http_json("POST", rep.url + "/v1/drain?mode=preempt", {},
                           ok=(200,))

    def preempted():
        v = handle.get_job(jid, timeout=30.0, with_records=False,
                           snapshot=True)
        return v if v["state"] == "preempted" else None
    view = _until(preempted, f"{jid} preempted")
    assert view["snapshot"] is not None
    assert rep.drained.wait(_DEADLINE_S)
    return json.loads(json.dumps(view))


def _settled(handle, jid):
    def done():
        v = handle.get_job(jid, timeout=30.0)
        return v if v["state"] in ("done", "failed") else None
    return _until(done, f"{jid} settled")


def _check_continued(view, fence, total):
    assert view["state"] == "done", view.get("error")
    assert view["result"]["resumed_at"] == fence
    assert view["result"]["gens"] == total
    seams = [r["faultEntry"] for r in view["records"]
             if "faultEntry" in r]
    assert [(s["site"], s["action"], s.get("gens")) for s in seams] == [
        ("fleet", "resume", fence)]
    events = [r["jobEntry"]["event"] for r in view["records"]
              if "jobEntry" in r]
    assert events == ["done"]           # no admission, no init


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_preempted_wire_crosses_the_packages(direction):
    """A preempted job's wire from one package's replica warm-starts the
    other package's replica's job at its fence."""
    src_mod, dst_mod = ((treplicas, jreplicas) if direction == "port-to-jax"
                        else (jreplicas, treplicas))
    src_cfg, dst_cfg = ((tconfig, jconfig) if direction == "port-to-jax"
                        else (jconfig, tconfig))
    src, src_h = src_mod.in_process_replica(_cfg(src_cfg), "src")
    try:
        src_mod.http_json("POST", src.url + "/v1/solve",
                          {"tim": _TIM, "id": "x", "seed": 3,
                           "generations": 100000})
        _until(lambda: "x" in src.svc.queue
               and src.svc.queue.get("x").ship is not None, "x shipped")
        view = _preempted_wire(src_mod, src, src_h, "x")
    finally:
        src.kill()
    fence = view["snapshot"]["gens_done"]
    assert fence == view["gens"] > 0
    dst, dst_h = dst_mod.in_process_replica(_cfg(dst_cfg), "dst")
    try:
        dst_mod.http_json("POST", dst.url + "/v1/solve",
                          {"tim": _TIM, "id": "x", "seed": 3,
                           "generations": fence + 10,
                           "snapshot": view["snapshot"]})
        _check_continued(_settled(dst_h, "x"), fence, fence + 10)
        assert dst.svc.registry.counter("serve.jobs_resumed").value == 1
    finally:
        dst.kill()


def test_preempted_job_resumes_on_another_port_replica():
    """Preempted on one port replica at generation 25 (its drive loop
    held before its fifth step while the drain is posted, so the drain
    lands after that step), resumed on another: the shipped prefix plus
    the continuation equals the uninterrupted run."""
    base = _baseline([("u", _TIM, 3, 60)])["u"]
    rep_a, h_a = treplicas.in_process_replica(
        _cfg(tconfig, preempt_grace=3600.0), "a")
    try:
        reached, release = _hold_before_step(rep_a, 5)
        treplicas.http_json("POST", rep_a.url + "/v1/solve",
                            {"tim": _TIM, "id": "u", "seed": 3,
                             "generations": 60})
        assert reached.wait(_DEADLINE_S)
        treplicas.http_json("POST", rep_a.url + "/v1/drain?mode=preempt",
                            {}, ok=(200,))
        release.set()
        view = _preempted_wire(treplicas, rep_a, h_a, "u")
    finally:
        rep_a.kill()
    assert view["snapshot"]["gens_done"] == view["gens"] == 25
    prefix = view["snapshot_records"]
    rep_b, h_b = treplicas.in_process_replica(_cfg(tconfig), "b")
    try:
        treplicas.http_json("POST", rep_b.url + "/v1/solve",
                            {"tim": _TIM, "id": "u", "seed": 3,
                             "generations": 60,
                             "snapshot": view["snapshot"]})
        done = _settled(h_b, "u")
        _check_continued(done, 25, 60)
        assert strip_timing(prefix + done["records"]) == base
    finally:
        rep_b.kill()


def test_jax_gateway_routes_to_a_port_replica():
    """JAX's Gateway over one port replica: two jobs of two buckets
    reach `done` with their results, and the record tails on the
    gateway are the port's unrouted records."""
    jobs = [("g1", _TIM, 1, 20), ("g2", _TIM_B, 2, 15)]
    base = _baseline(jobs)
    rep, _ = treplicas.in_process_replica(_cfg(tconfig), "p0")
    handle = jreplicas.ReplicaHandle("p0", rep.url)
    gw = Gateway(jconfig.FleetConfig(
        replicas=[rep.url], listen="127.0.0.1:0", probe_every=0.1,
        poll_every=0.05, dead_after=2), [handle]).start()
    try:
        for jid, tim, seed, gens in jobs:
            jreplicas.http_json("POST", gw.url + "/v1/solve",
                                {"tim": tim, "id": jid, "seed": seed,
                                 "generations": gens})

        def views():
            vs = {jid: jreplicas.http_json(
                "GET", f"{gw.url}/v1/jobs/{jid}", ok=(200,))
                for jid, *_ in jobs}
            settled = all(v["state"] in ("done", "failed", "cancelled",
                                         "shed", "rejected")
                          and any("solution" in r for r in v["records"])
                          for v in vs.values())
            return vs if settled else None
        got = _until(views, "both jobs settled on the gateway")
        for jid, _, _, gens in jobs:
            v = got[jid]
            assert v["state"] == "done"
            assert v["result"]["gens"] == gens
            assert strip_timing(v["records"]) == base[jid], jid
        assert rep.svc.registry.counter("serve.jobs_done").value == 2
    finally:
        gw.request_drain()
        gw.drained.wait(30)
        gw.close()
        rep.kill()
