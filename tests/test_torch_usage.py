"""The port's usage metering (timetabling_ga_tpu_torch/obs/usage.py and
the serve path's meter) against the JAX package's.

  arithmetic  split, add, rounded, fold_entries, combine, aggregate,
              progress and render equal to JAX's on seeded inputs,
              exactly; the UsageLedger's totals, counters and records
              equal to JAX's on the same events
  serve       metering on vs --no-usage: the same record stream under
              strip_timing; every per-dispatch usageEntry's lanes sum
              exactly to its gens, device_seconds, compile_seconds and
              flops; a finished job's result carries its tenant and a
              meter whose gens are the generations it ran; the tenant
              ledgers and counters (tests/test_usage.py's A/B, on its
              _PA/_PB problems)
  warm start  a job shipped by one package and resumed by the other
              continues its meter in both directions (the wire's usage
              cursor), while the survivor's ledger counts only its own
              quanta
  isolation   a hung or dead ledger (the `usage` fault site) stalls no
              dispatch, settlement or writer drain

The port's meter has two counterparts of JAX's inputs: compile_seconds
is the kernel build's wall inside a quantum (0 on the host, where no
kernel is built), flops the quantum's counted work (obs/cost.py, the
kernels' work.py counts, tallied on the host as on the card);
conservation holds for both all the same.
"""

import io
import json
import random
import time

import pytest
import torch

from timetabling_ga_tpu.obs import usage as jusage
from timetabling_ga_tpu.obs.metrics import MetricsRegistry as JRegistry
from timetabling_ga_tpu.problem import random_instance
from timetabling_ga_tpu.runtime import faults as jfaults
from timetabling_ga_tpu.runtime.config import ServeConfig as JServeConfig
from timetabling_ga_tpu.serve.service import SolveService as JSolveService
from timetabling_ga_tpu_torch.obs import usage as tusage
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime import faults as tfaults
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl
from timetabling_ga_tpu_torch.runtime.config import (
    ServeConfig, parse_serve_args)
from timetabling_ga_tpu_torch.serve import queue as tqueue
from timetabling_ga_tpu_torch.serve.service import SolveService

torch.set_num_threads(1)

# tests/test_usage.py's problems
_PA = random_instance(71, n_events=12, n_rooms=3, n_features=2,
                      n_students=8, attend_prob=0.2)
_PB = random_instance(72, n_events=40, n_rooms=4, n_features=2,
                      n_students=30, attend_prob=0.1)


def _port(p):
    from timetabling_ga_tpu.problem import dump_tim
    return load_tim(dump_tim(p))


_TPA, _TPB = _port(_PA), _port(_PB)


@pytest.fixture(autouse=True)
def _no_fault_plan():
    tfaults.install(None)
    jfaults.install(None)
    yield
    tfaults.install(None)
    jfaults.install(None)


def _serve_cfg(cls=ServeConfig, **kw):
    kw.setdefault("backend", "cpu")
    kw.setdefault("lanes", 2)
    kw.setdefault("quantum", 5)
    kw.setdefault("pop_size", 4)
    kw.setdefault("max_steps", 8)
    if cls is JServeConfig:
        kw.setdefault("mesh_devices", 1)
    return cls(**kw)


def _records(buf):
    return [json.loads(x) for x in buf.getvalue().splitlines()]


def _dispatch_entries(recs):
    return [r["usageEntry"] for r in recs
            if "usageEntry" in r and "lanes" in r["usageEntry"]]


def _lane(mod, job, tenant, **kw):
    d = mod.new_usage()
    d.update(kw)
    return {"job": job, "tenant": tenant, **d}


# -------------------------------------------------------------- arithmetic


def _random_meter(rng):
    u = {f: (rng.randint(0, 50) if f in ("gens", "dispatches")
             else rng.choice([0.0, rng.uniform(0, 3), 1e-9]))
         for f in tusage.FIELDS}
    return u


def _random_log(rng, mod):
    """A usageEntry stream: dispatch entries with lanes, settle totals,
    and records of other kinds."""
    recs = [{"logEntry": {"best": 3}}, {"usageEntry": "torn"}]
    for d in range(6):
        lanes = [_lane(mod, f"j{rng.randint(0, 4)}",
                       rng.choice(["acme", "", None, "ze.ta"]),
                       **_random_meter(rng))
                 for _ in range(rng.randint(1, 3))]
        recs.append({"usageEntry": {"dispatch": d, "lanes": lanes}})
    for j in range(3):
        recs.append({"usageEntry": dict(
            {"event": "total", "job": f"j{j}", "tenant": "acme"},
            **_random_meter(rng))})
    return recs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_equals_jax(seed):
    """Shares and quantized totals bit for bit, on the default and the
    integer grid, with zero and all-zero weights and totals past the
    grid's 2**53 units."""
    rng = random.Random(seed)
    for _ in range(400):
        n = rng.randint(0, 8)
        total = rng.choice([rng.uniform(0, 1), rng.uniform(0, 1e9),
                            rng.uniform(0, 1e16),
                            float(rng.randint(0, 10 ** 12))])
        ws = [rng.choice([0, rng.randint(0, 100)]) for _ in range(n)]
        for q in (tusage.QUANTUM, 1.0):
            got = tusage.split(total, ws, quantum=q)
            assert got == jusage.split(total, ws, quantum=q)
            assert sum(got[1]) == got[0]
    assert tusage.QUANTUM == jusage.QUANTUM
    assert tusage.FIELDS == jusage.FIELDS


@pytest.mark.parametrize("seed", [0, 1])
def test_meter_arithmetic_equals_jax(seed):
    """new_usage, add, fold_into, rounded and progress."""
    rng = random.Random(seed)
    assert tusage.new_usage() == jusage.new_usage()
    acc_t = acc_j = None
    for _ in range(50):
        delta = _random_meter(rng)
        acc_t, acc_j = tusage.add(acc_t, delta), jusage.add(acc_j, delta)
        assert acc_t == acc_j
        assert tusage.rounded(acc_t, 3) == jusage.rounded(acc_j, 3)
    dst_t, dst_j = tusage.new_usage(), jusage.new_usage()
    assert tusage.fold_into(dst_t, acc_t) == jusage.fold_into(dst_j, acc_j)
    payload = {"tenants": {"a": dict(acc_t, jobs=2)}}
    assert tusage.progress(payload) == jusage.progress(payload)
    assert tusage.rounded(None) == jusage.rounded(None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_render_aggregate_equal_jax(seed):
    """fold_entries, render (all tenants and one), summarize_entries,
    combine and aggregate on a seeded log and seeded replica payloads."""
    rng = random.Random(seed)
    recs = _random_log(rng, tusage)
    rt, rj = tusage.fold_entries(recs), jusage.fold_entries(recs)
    assert rt == rj
    assert tusage.render(rt) == jusage.render(rj)
    assert tusage.render(rt, tenant="acme") == jusage.render(
        rj, tenant="acme")
    assert tusage.summarize_entries(recs) == jusage.summarize_entries(recs)
    payloads = [("r0", True, rt), ("r1", False, tusage.fold_entries(
        _random_log(rng, tusage))), ("r2", False, None)]
    at, aj = tusage.aggregate(payloads), jusage.aggregate(payloads)
    assert at == aj
    assert tusage.render(at) == jusage.render(aj)
    assert tusage.combine([p for _, _, p in payloads]) == jusage.combine(
        [p for _, _, p in payloads])


def test_ledger_equals_jax():
    """The same events to both ledgers: equal totals, counters and
    usageEntry lines; the tenant cap folds new labels into the overflow
    tenant alike."""
    out = {}
    for name, mod, reg_cls in (("port", tusage, MetricsRegistry),
                               ("jax", jusage, JRegistry)):
        reg, buf = reg_cls(), io.StringIO()
        led = mod.UsageLedger(registry=reg, out=buf, now=lambda: 1.5,
                              tenants_cap=3)
        for i, tenant in enumerate(("acme", "acme", "zeta", "t3", "t4")):
            led.job(f"j{i}", tenant)
            led.dispatch({"dispatch": i, "gens": 5,
                          "device_seconds": 0.625, "compile_seconds": 0.0,
                          "flops": 0.0,
                          "lanes": [_lane(mod, f"j{i}", tenant, gens=5,
                                          dispatches=1,
                                          device_seconds=0.625,
                                          park_seconds=0.25)]})
        led.final("j0", "acme", {"gens": 5, "dispatches": 1,
                                 "device_seconds": 0.625}, mode="edit")
        assert led.drain()
        led.close()
        out[name] = (led.totals(), reg.snapshot(), buf.getvalue())
    assert out["port"] == out["jax"]
    assert tusage.OVERFLOW_TENANT in out["port"][0]


# ------------------------------------------------------------------- serve


def test_serve_ab_identity_and_conservation():
    """Metering on vs off: strip_timing streams identical; the on
    leg's usageEntry dispatch records conserve every component; the
    unequal-gens pack splits proportionally; results, tenant ledgers and
    counters (tests/test_usage.py's A/B)."""
    jobs = [("a", _TPA, 3, 3, "acme"), ("b", _TPA, 4, 10, "acme"),
            ("c", _TPB, 5, 10, "zeta")]

    def leg(usage):
        buf = io.StringIO()
        svc = SolveService(_serve_cfg(obs=True, usage=usage), out=buf,
                           registry=MetricsRegistry())
        for jid, p, seed, gens, tenant in jobs:
            svc.submit(p, job_id=jid, seed=seed, generations=gens,
                       tenant=tenant)
        svc.drive()
        svc.close()
        return svc, _records(buf)

    svc_off, recs_off = leg(False)
    svc_on, recs_on = leg(True)
    assert tjsonl.strip_timing(recs_off) == tjsonl.strip_timing(recs_on)
    assert not any("usageEntry" in r for r in recs_off)
    disp = _dispatch_entries(recs_on)
    assert disp
    for u in disp:
        for f in ("gens", "device_seconds", "compile_seconds", "flops"):
            assert sum(lane[f] for lane in u["lanes"]) == u[f], (f, u)
        assert u["flops"] > 0.0 and u["compile_seconds"] == 0.0
        assert u["overhead_device_seconds"] == 0.0
        assert u["device_seconds"] > 0
    packed = next(u for u in disp if len(u["lanes"]) == 2
                  and {x["job"] for x in u["lanes"]} == {"a", "b"})
    by_job = {x["job"]: x for x in packed["lanes"]}
    assert by_job["a"]["gens"] == 3 and by_job["b"]["gens"] == 5
    assert by_job["a"]["device_seconds"] == tusage.split(
        packed["device_seconds"], [3, 5])[1][0]
    assert "usage" not in svc_off.queue.get("a").result
    for jid, _, _, gens, tenant in jobs:
        res = svc_on.queue.get(jid).result
        assert res["tenant"] == tenant and res["usage"]["gens"] == gens
        assert res["usage"]["gens"] == res["gens"]
    totals = svc_on.usage.totals()
    assert totals["acme"]["gens"] == 13 and totals["acme"]["jobs"] == 2
    assert totals["zeta"]["gens"] == 10 and totals["zeta"]["jobs"] == 1
    snap = svc_on.registry.snapshot()
    assert snap["counters"]["usage.tenant.acme.gens"] == 13
    assert snap["counters"]["usage.tenant.zeta.jobs"] == 1
    # the settle totals: one a job, its meter the result's
    finals = {r["usageEntry"]["job"]: r["usageEntry"] for r in recs_on
              if r.get("usageEntry", {}).get("event") == "total"}
    assert sorted(finals) == ["a", "b", "c"]
    assert finals["b"]["gens"] == 10 and finals["b"]["tenant"] == "acme"


def _ship_after_two_quanta(svc_cls, cfg, problem):
    """A job of 20 generations stepped twice (quantum 5), its resident
    group parked, its wire through JSON."""
    svc = svc_cls(cfg, out=io.StringIO(),
                  registry=(MetricsRegistry() if svc_cls is SolveService
                            else JRegistry()))
    svc.submit(problem, job_id="r", seed=3, generations=20, tenant="acme")
    svc.step()
    svc.step()
    svc.scheduler.flush_resident("ship")
    wire = json.loads(json.dumps(svc.queue.get("r").ship.pack()))
    svc.close()
    return wire


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_warm_start_continues_the_meter(direction):
    """A wire shipped at generation 10 carries the meter's cursor; the
    other package resumes the job and continues it: the settled meter
    has all 20 generations and 4 dispatches, while the survivor's
    ledger holds only its own 10 and does not count the job again."""
    if direction == "jax-to-port":
        wire = _ship_after_two_quanta(JSolveService,
                                      _serve_cfg(JServeConfig), _PA)
        svc = SolveService(_serve_cfg(), out=io.StringIO(),
                           registry=MetricsRegistry())
        problem = _TPA
    else:
        wire = _ship_after_two_quanta(SolveService, _serve_cfg(), _TPA)
        svc = JSolveService(_serve_cfg(JServeConfig), out=io.StringIO(),
                            registry=JRegistry())
        problem = _PA
    assert wire["usage"]["gens"] == 10 and wire["usage"]["dispatches"] == 2
    svc.submit(problem, job_id="r", seed=3, generations=20,
               snapshot=wire, tenant="acme")
    assert svc.queue.get("r").usage["gens"] == 10      # seeded
    svc.drive()
    svc.close()
    res = svc.queue.get("r").result
    assert res["resumed_at"] == 10
    assert res["usage"]["gens"] == 20 and res["usage"]["dispatches"] == 4
    assert res["usage"]["device_seconds"] >= wire["usage"][
        "device_seconds"]
    totals = svc.usage.totals()
    assert totals["acme"]["gens"] == 10 and totals["acme"]["jobs"] == 0


def test_wire_without_cursor_meters_from_zero():
    """A wire with no cursor (shipped with metering off) resumes with a
    meter of its own quanta alone."""
    svc1 = SolveService(_serve_cfg(usage=False), out=io.StringIO(),
                        registry=MetricsRegistry())
    svc1.submit(_TPA, job_id="r", seed=3, generations=20)
    svc1.step()
    svc1.step()
    svc1.scheduler.flush_resident()
    wire = json.loads(json.dumps(svc1.queue.get("r").ship.pack()))
    svc1.close()
    assert "usage" not in wire
    svc2 = SolveService(_serve_cfg(), out=io.StringIO(),
                        registry=MetricsRegistry())
    svc2.submit(_TPA, job_id="r", seed=3, generations=20, snapshot=wire)
    svc2.drive()
    svc2.close()
    assert svc2.queue.get("r").result["usage"]["gens"] == 10


@pytest.mark.parametrize("action", ["die", "hang"])
def test_ledger_fault_isolation(action):
    """Fault site `usage`: a dead or hung ledger never stalls dispatch,
    settlement or the writer's drain — the job finishes, the stream is
    complete, and the per-job meter (the drive loop's own arithmetic)
    still reaches the result."""
    buf = io.StringIO()
    svc = SolveService(_serve_cfg(obs=True), out=buf,
                       registry=MetricsRegistry())
    tfaults.install(f"usage:1:{action}")
    t0 = time.monotonic()
    svc.submit(_TPA, job_id="f", seed=3, generations=10, tenant="acme")
    svc.drive()
    tfaults.install(None)
    svc.close()
    assert time.monotonic() - t0 < 60
    assert svc.queue.get("f").state == "done"
    assert svc.queue.get("f").result["usage"]["gens"] == 10
    recs = _records(buf)
    assert any("solution" in r for r in recs)
    if action == "die":
        assert not svc.usage.alive()
    else:
        assert svc.usage.alive()        # parked, abandoned by close
    assert not _dispatch_entries(recs)  # the first batch never settled


def test_flags_and_plumbing():
    """Metering on by default, --no-usage off (JAX's parse); the fault
    site is in the validated set; the queue's tenant_label is
    obs/usage.py's; usageEntry is a timing record."""
    assert parse_serve_args([]).usage is True
    assert parse_serve_args(["--no-usage"]).usage is False
    assert tfaults.FaultPlan.parse("usage:1:die") is not None
    assert tqueue.tenant_label is tusage.tenant_label
    assert tqueue.DEFAULT_TENANT == jusage.DEFAULT_TENANT
    assert tjsonl.strip_timing([{"usageEntry": {"gens": 1}},
                                {"runEntry": {"totalBest": 1,
                                              "feasible": True}}]) \
        == [{"runEntry": {"totalBest": 1, "feasible": True}}]
