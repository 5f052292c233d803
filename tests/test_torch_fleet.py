"""The port's fleet control plane (timetabling_ga_tpu_torch/fleet and the
fleet half of runtime/config.py) against the JAX package's, on the same
inputs, with no replica running:

  - parse_fleet_args over a set of argvs: JAX's fields (all but
    `backend`, whose default is "gpu" here and "tpu" there) or JAX's
    message;
  - route_entry and scale_entry write JAX's bytes;
  - the Router over one sequence of stub handle views (readiness, queue
    depth, compile counts, deaths, exclusions): JAX's choices,
    outcomes, last decisions, stats and `fleet.route.*` counters;
  - the ReplicaSet's boot grace, dead-after and restart with stub probes
    (tests/test_fleet.py:253), in both packages;
  - choose_victim and the AutoScaler over one injected clock and
    history: JAX's scaleEntry sequence and `fleet.scale.*` counters
    (the scenarios of tests/test_scale.py:197-519);
  - the gateway's scale snapshot leaves a retiring owner out of the
    warmth guard (a never-started Gateway, driven by hand).
"""

import dataclasses
import io
import json

import numpy as np
import pytest

from timetabling_ga_tpu.fleet import autoscaler as jscaler
from timetabling_ga_tpu.fleet import replicas as jreplicas
from timetabling_ga_tpu.fleet import router as jrouter
from timetabling_ga_tpu.obs import history as jhistory
from timetabling_ga_tpu.obs import metrics as jmetrics
from timetabling_ga_tpu.obs import spans as jspans
from timetabling_ga_tpu.runtime import config as jconfig
from timetabling_ga_tpu.runtime import faults as jfaults
from timetabling_ga_tpu.runtime import jsonl as jjsonl
from timetabling_ga_tpu_torch.fleet import autoscaler as tscaler
from timetabling_ga_tpu_torch.fleet import replicas as treplicas
from timetabling_ga_tpu_torch.fleet import router as trouter
from timetabling_ga_tpu_torch.fleet.gateway import Gateway
from timetabling_ga_tpu_torch.obs import history as thistory
from timetabling_ga_tpu_torch.obs import metrics as tmetrics
from timetabling_ga_tpu_torch.obs import spans as tspans
from timetabling_ga_tpu_torch.runtime import config as tconfig
from timetabling_ga_tpu_torch.runtime import faults as tfaults
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl

# (config, faults, jsonl, router, replicas, autoscaler, history, metrics,
# spans) of one package
_JAX = (jconfig, jfaults, jjsonl, jrouter, jreplicas, jscaler, jhistory,
        jmetrics, jspans)
_PORT = (tconfig, tfaults, tjsonl, trouter, treplicas, tscaler, thistory,
         tmetrics, tspans)


@pytest.fixture(autouse=True)
def _no_plans():
    tfaults.install(None)
    jfaults.install(None)
    yield
    tfaults.install(None)
    jfaults.install(None)


# ---------------------------------------------------------------- flags

_ARGVS = [
    ["--spawn", "2"],
    ["--listen", "127.0.0.1:0", "--replica", "http://a:1", "--replica",
     "http://b:2", "--probe-every", "0.2", "--", "--backend", "cpu",
     "--lanes", "4"],
    ["--spawn", "2", "--backend", "cpu", "-o", "gw.jsonl",
     "--metrics-every", "5", "--slo-p99", "2.5", "--slo-window", "10",
     "--stall-after", "0", "--incident-dir", "inc",
     "--incident-min-interval", "0", "--history-every", "0.5"],
    ["--spawn", "1", "--scale-max", "3", "--scale-min", "2",
     "--scale-up-queue", "16", "--scale-up-for", "45",
     "--scale-cooldown", "90", "--scale-dry-run"],
    ["--replica", "http://x", "--scale-max", "2", "--scale-dry-run"],
    ["--spawn", "1", "--dead-after", "5", "--boot-grace", "30",
     "--max-restarts", "0", "--place-timeout", "10", "--route-retries",
     "2", "--retry-wait", "0.5", "--backlog", "3", "--snapshot-hwm",
     "0", "--snapshot-timeout", "1", "--retain-terminal", "7",
     "--io-timeout", "4", "--probe-timeout", "0.5", "--poll-every",
     "0.1", "--faults", "route:1:hang"],
    [],
    ["--replica"],
    ["--replica", "http://a:1", "--spawn", "2"],
    ["--spawn", "-1"],
    ["--spawn", "1", "--", "--bogus", "x"],
    ["--replica", "u", "--dead-after", "0"],
    ["--replica", "u", "--probe-every", "0"],
    ["--replica", "u", "--snapshot-hwm", "-1"],
    ["--replica", "u", "--slo-p99", "-1"],
    ["--replica", "u", "--listen", "nohost"],
    ["--replica", "u", "--scale-max", "2"],
    ["--spawn", "1", "--scale-max", "2", "--scale-min", "3"],
    ["--spawn", "1", "--scale-max", "2", "--scale-up-queue", "2",
     "--scale-down-queue", "4"],
    ["--spawn", "1", "--scale-max", "2", "--history-every", "0"],
    ["--spawn", "1", "--scale-max", "2", "--scale-cooldown", "-1"],
    ["--spawn", "2", "--", "-o", "x.jsonl"],
    ["--spawn", "1", "--nope", "1"],
    ["--spawn", "1", "--backend", "cpu", "--", "--lanes", "2",
     "--quantum", "3", "--pop-size", "4", "-m", "8"],
]


def _fleet_outcome(config_mod, argv):
    try:
        cfg = config_mod.parse_fleet_args(argv)
    except (SystemExit, ValueError) as e:
        return type(e).__name__, str(e)
    fields = dataclasses.asdict(cfg)
    own = argv[:argv.index("--")] if "--" in argv else argv
    if "--backend" not in own:
        fields.pop("backend")
    return "ok", fields


@pytest.mark.parametrize("argv", _ARGVS,
                         ids=[" ".join(a) or "empty" for a in _ARGVS])
def test_parse_fleet_args_equal_jax(argv):
    assert _fleet_outcome(tconfig, argv) == _fleet_outcome(jconfig, argv)


def test_fleet_backend_default_is_the_card():
    assert tconfig.FleetConfig().backend == "gpu"
    assert tconfig.parse_fleet_args(["--spawn", "1"]).backend == "gpu"
    with pytest.raises(SystemExit) as e:
        tconfig.parse_fleet_args(["--spawn", "1", "--backend", "tpu"])
    assert str(e.value) == "unknown backend: tpu (gpu or cpu)"


# ------------------------------------------------------------- records


def test_route_and_scale_entry_bytes_equal_jax():
    def write(jsonl):
        buf = io.StringIO()
        jsonl.route_entry(buf, "j42", (64, 8, 8, 64, 5, 9), "r0", "hit",
                          backlog=1.0, pins=2, compile_hit_rate=0.93,
                          attempt=1, flow=(1 << 32) + 3)
        jsonl.route_entry(buf, 7, None, "r1", "warm")
        jsonl.scale_entry(buf, "up", "queue_depth", ts=41.2345678,
                          replica="s1", live=1, target=2, dry_run=False,
                          evidence={"serve.queue_depth": {
                              "op": ">=", "threshold": 8.0,
                              "for_s": 30.0, "mean": 12.4}})
        jsonl.scale_entry(buf, "down", "idle", ts=-1.0, blocked="warmth",
                          live=2)
        jsonl.scale_entry(buf, "hold", "x")
        return buf.getvalue()
    got = write(tjsonl)
    assert got == write(jjsonl)
    assert all(tjsonl.strip_timing([json.loads(x)]) == []
               for x in got.splitlines())


# --------------------------------------------------------------- router


class _StubHandle:
    """The view a router reads of one replica."""

    def __init__(self, name):
        self.name = name
        self.ready = True
        self.dead = False
        self.queue_depth = None
        self.compile_count = 0.0
        self.compile_cache_hits = 0.0

    def compile_hit_rate(self):
        total = self.compile_count + self.compile_cache_hits
        return self.compile_cache_hits / total if total else 0.0


class _StubSet:
    def __init__(self, handles):
        self.handles = handles

    def live(self):
        return [h for h in self.handles if not h.dead]


def _route_trace(router_mod, metrics_mod, script):
    """Replay `script` (a list of ops over fresh stub handles) through
    one package's Router; returns everything it decided."""
    handles = [_StubHandle(f"r{i}") for i in range(3)]
    reg = metrics_mod.MetricsRegistry()
    router = router_mod.Router(_StubSet(handles), registry=reg)
    out = []
    for op in script:
        kind = op[0]
        if kind == "route":
            _, bucket, exclude = op
            try:
                h = router.route(bucket, exclude=exclude)
                out.append(("route", h.name, dict(router.last_decision)))
            except router_mod.NoReplicaError as e:
                out.append(("none", str(e)))
        elif kind == "dead":
            handles[op[1]].dead = True
            router.on_replica_dead(handles[op[1]].name)
        elif kind == "alive":
            handles[op[1]].dead = False
        elif kind == "set":
            _, i, field, value = op
            setattr(handles[i], field, value)
        elif kind == "owner":
            out.append(("owner", router.sole_warm_owner(
                op[1], [h.name for h in handles if not h.dead])))
    counters = {k: v for k, v in reg.snapshot()["counters"].items()
                if k.startswith("fleet.route.")}
    return out, router.stats(), router.hit_rate(), dict(router.pin_counts), \
        counters


def _fixed_script():
    a, b, c = (32, 4, 4, 32, 5, 9), (64, 4, 4, 32, 5, 9), ("C",)
    return [
        ("route", a, ()), ("route", a, ()), ("route", b, ()),
        ("route", b, ()), ("set", 0, "ready", False),
        ("route", a, ()), ("set", 0, "ready", True), ("route", a, ()),
        ("set", 1, "queue_depth", 9.0), ("set", 0, "queue_depth", 0.0),
        ("route", c, ()), ("route", a, ("r0",)),
        ("set", 2, "compile_count", 10.0),
        ("set", 2, "compile_cache_hits", 90.0),
        ("route", ("D",), ()), ("owner", a), ("owner", ("Z",)),
        ("dead", 1), ("route", b, ()), ("route", b, ()),
        ("set", 0, "queue_depth", float("nan")), ("route", ("E",), ()),
        ("dead", 0), ("dead", 2), ("route", a, ()),
        ("alive", 2), ("route", a, ("r2",)), ("route", a, ()),
    ]


def _random_script(seed, steps=300):
    rng = np.random.default_rng(seed)
    buckets = [(32, 4, 4, 32, 5, 9), (64, 4, 4, 32, 5, 9),
               (64, 8, 4, 64, 5, 9), (128, 8, 8, 64, 5, 9)]
    script = []
    for _ in range(steps):
        u = rng.random()
        i = int(rng.integers(3))
        if u < 0.55:
            bucket = buckets[int(rng.integers(len(buckets)))]
            exclude = (f"r{i}",) if rng.random() < 0.1 else ()
            script.append(("route", bucket, exclude))
        elif u < 0.65:
            script.append(("set", i, "ready", bool(rng.random() < 0.7)))
        elif u < 0.8:
            script.append(("set", i, "queue_depth",
                           float(rng.integers(0, 5))))
        elif u < 0.88:
            script.append(("set", i, "compile_count",
                           float(rng.integers(0, 20))))
            script.append(("set", i, "compile_cache_hits",
                           float(rng.integers(0, 200))))
        elif u < 0.93:
            script.append(("dead", i))
        elif u < 0.98:
            script.append(("alive", i))
        else:
            script.append(("owner", buckets[int(rng.integers(4))]))
    return script


@pytest.mark.parametrize("script", ["fixed", 0, 1, 2],
                         ids=["fixed", "seed0", "seed1", "seed2"])
def test_router_decisions_equal_jax(script):
    ops = _fixed_script() if script == "fixed" else _random_script(script)
    got = _route_trace(trouter, tmetrics, ops)
    assert got == _route_trace(jrouter, jmetrics, ops)
    decisions = [d for d in got[0] if d[0] == "route"]
    assert decisions and {d[2]["outcome"] for d in decisions} <= {
        "hit", "warm", "miss"}


def test_router_affinity_detours_and_deaths():
    """tests/test_fleet.py:210's story on the port's router."""
    r0, r1 = _StubHandle("r0"), _StubHandle("r1")
    router = trouter.Router(_StubSet([r0, r1]))
    ba, bb = ("A",), ("B",)
    first = router.route(ba)
    assert all(router.route(ba) is first for _ in range(4))
    second = router.route(bb)
    assert second is not first
    assert router.hit_rate() == 1.0 and router.stats()["warmups"] == 2
    first.ready = False
    assert router.route(ba) is second                # a detour
    assert (router.stats()["misses"], router.stats()["repins"]) == (1, 0)
    first.ready = True
    assert router.route(ba) is first                 # back home, warm
    second.dead = True
    router.on_replica_dead(second.name)
    assert router.route(bb) is first
    first.dead = True
    with pytest.raises(trouter.NoReplicaError):
        router.route(ba)


# ---------------------------------------------------------- replica set


class _Proc:
    def poll(self):
        return None

    def terminate(self):
        pass

    def wait(self, timeout=None):
        return 0


def _replica_set_story(replicas_mod):
    """tests/test_fleet.py:253: a replica that never answered stays up
    through the boot grace, then dies; a spawned one respawns with its
    probe state reset, then dies for good. Nothing listens on port 9."""
    events = []
    h = replicas_mod.ReplicaHandle("boot", "http://127.0.0.1:9")
    rs = replicas_mod.ReplicaSet(
        [h], dead_after=1, boot_grace=60.0, probe_timeout=0.2,
        on_death=lambda hh, r: events.append((hh.name, r)))
    rs.probe_all()
    events.append(("after-first", h.dead, h.fails))
    h.born -= 120.0
    rs.probe_all()
    events.append(("after-grace", h.dead, h.fails))
    h2 = replicas_mod.ReplicaHandle("w", "http://127.0.0.1:9",
                                    proc=_Proc(), respawn=_Proc)
    h2.ok_once = True
    rs2 = replicas_mod.ReplicaSet(
        [h2], dead_after=2, boot_grace=60.0, probe_timeout=0.2,
        max_restarts=1, on_death=lambda hh, r: events.append((hh.name, r)))
    rs2.probe_all()
    events.append(("one-fail", h2.dead, h2.fails, h2.restarts))
    rs2.probe_all()
    events.append(("respawned", h2.dead, h2.fails, h2.restarts,
                   h2.ok_once))
    h2.born -= 120.0
    rs2.probe_all()
    rs2.probe_all()
    events.append(("gone", h2.dead, h2.restarts))
    # drain mode: no more respawns
    h3 = replicas_mod.ReplicaHandle("x", "http://127.0.0.1:9",
                                    proc=_Proc(), respawn=_Proc)
    h3.ok_once = True
    rs3 = replicas_mod.ReplicaSet([h3], dead_after=1, max_restarts=5,
                                  probe_timeout=0.2,
                                  on_death=lambda hh, r: events.append(
                                      (hh.name, r)))
    rs3.stop_restarts()
    rs3.probe_all()
    events.append(("drained", h3.dead, h3.restarts,
                   [x.name for x in rs3.live()]))
    return events


def test_replica_set_boot_grace_dead_after_restart_equal_jax():
    got = _replica_set_story(treplicas)
    assert got == _replica_set_story(jreplicas)
    assert got[:3] == [("after-first", False, 0), ("boot", False),
                       ("after-grace", True, 1)]
    assert ("respawned", False, 0, 1, False) in got
    assert ("gone", True, 1) in got and ("drained", True, 0, []) in got


# ------------------------------------------------------------ autoscaler

_VICTIM_CASES = [
    ({"r0": {"inflight": 0, "idle": True},
      "r1": {"inflight": 0, "idle": True},
      "r2": {"inflight": 2, "idle": True}}, {}),
    ({"r0": {"inflight": 0, "idle": True},
      "r1": {"inflight": 0, "idle": True},
      "r2": {"inflight": 2, "idle": True}}, {"r0": [[32, 4, 4, 32, 5, 9]]}),
    ({"r0": {"inflight": 0, "idle": True},
      "r1": {"inflight": 0, "idle": True}}, {"r0": [[1]], "r1": [[2]]}),
    ({"r0": {"inflight": 0, "idle": False}}, {}),
    ({"r0": {"inflight": 0, "idle": True, "resident_groups": 3.0,
             "resident_bytes": 4096.0},
      "r1": {"inflight": 1, "idle": True, "resident_groups": 0.0,
             "resident_bytes": 0.0}}, {}),
    ({"r0": {"inflight": 0, "idle": True, "resident_groups": 2.0,
             "resident_bytes": 8192.0},
      "r1": {"inflight": 0, "idle": True, "resident_groups": 5.0,
             "resident_bytes": 1024.0}}, {}),
    ({"r0": {"inflight": 0, "idle": True},
      "r1": {"inflight": 2, "idle": True, "resident_groups": 0.0,
             "resident_bytes": 0.0}}, {}),
    ({"r0": {"inflight": 0, "idle": True, "resident_groups": 0.0,
             "resident_bytes": 0.0},
      "r1": {"inflight": 0, "idle": True, "resident_groups": 7.0,
             "resident_bytes": 2.0 ** 20}}, {"r0": [[1]]}),
]


def _random_victim_cases(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        reps = {}
        for i in range(int(rng.integers(1, 6))):
            v = {"inflight": int(rng.integers(0, 3)),
                 "idle": bool(rng.random() < 0.7)}
            if rng.random() < 0.6:
                v["resident_groups"] = float(rng.integers(0, 3))
                v["resident_bytes"] = float(rng.integers(0, 4)) * 1024.0
            reps[f"r{i}"] = v
        protected = {n: [[int(rng.integers(9))]] for n in reps
                     if rng.random() < 0.3}
        out.append((reps, protected))
    return out


def test_choose_victim_equal_jax():
    cases = _VICTIM_CASES + _random_victim_cases(5)
    got = [tscaler.choose_victim(r, p) for r, p in cases]
    assert got == [jscaler.choose_victim(r, p) for r, p in cases]
    assert got[:8] == [("r0", []), ("r1", ["r0"]), (None, ["r0", "r1"]),
                       (None, []), ("r1", []), ("r1", []), ("r1", []),
                       ("r1", ["r0"])]


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class _Handle:
    def __init__(self, name):
        self.name = name
        self.dead = False
        self.retired = False


class _Set:
    def __init__(self, handles):
        self._h = {h.name: h for h in handles}

    def all(self):
        return list(self._h.values())

    def get(self, name):
        return self._h.get(name)

    def add(self, handle):
        self._h[handle.name] = handle


class _StubGateway:
    """The surface AutoScaler reads (tests/test_scale.py:81): a registry
    and a history ring of one package on a fake clock, a settable scale
    snapshot, and recorders in place of the spawn pool and the preempt
    seam."""

    def __init__(self, mods, handles, clock):
        _, _, jsonl, _, _, _, history, metrics, spans = mods
        self.registry = metrics.MetricsRegistry()
        self.now = clock
        self.history = history.HistoryRing(registry=self.registry,
                                           every_s=1.0, now=clock)
        self.replicas = _Set(handles)
        self.writer = io.StringIO()
        self.tracer = spans.NULL_TRACER
        self.flight = None
        self.protected = {}
        self.preempted = []
        self.adopted = []

    def scale_snapshot(self):
        return {"replicas": {h.name: {"dead": h.dead,
                                      "retired": h.retired,
                                      "inflight": 0, "pins": 0}
                             for h in self.replicas.all()},
                "protected": dict(self.protected)}

    def preempt_replica(self, name):
        self.preempted.append(name)

    def adopt_replica(self, handle):
        self.adopted.append(handle.name)
        self.replicas.add(handle)

    def _rec(self, fn, *args, **kw):
        fn(*args, **kw)


def _feed(gw, clock, seconds, depth, counters=None):
    for _ in range(int(seconds)):
        clock.t += 1.0
        gw.registry.gauge("serve.queue_depth").set(float(depth))
        for h in gw.replicas.all():
            gw.registry.gauge(f"fleet.replica.{h.name}.backlog").set(0.0)
        for name, v in (counters or {}).items():
            gw.registry.counter(name).inc(v)
        gw.history.sample_once()


def _scale_cfg(config_mod, **kw):
    for k, v in dict(spawn=1, scale_min=1, scale_max=3,
                     scale_up_queue=5.0, scale_up_for=10.0,
                     scale_down_queue=1.0, scale_down_for=10.0,
                     scale_idle_window=10.0, scale_cooldown=30.0,
                     scale_every=1.0, scale_warm_recent=120.0).items():
        kw.setdefault(k, v)
    return config_mod.FleetConfig(**kw)


def _scenario(name, mods):
    """One tests/test_scale.py scenario on one package: (scaleEntry
    bodies, fleet.scale.* counters and gauges, actuations, tick
    results)."""
    config, faults, _, _, _, scaler_mod, _, _, _ = mods
    clock = _Clock()
    handles = [_Handle("r0")]
    kw, feed, dry = {}, [], False
    if name == "sustained":
        feed = [(5, 8.0), "tick", (7, 8.0), "tick"]
    elif name == "cooldown":
        feed = [(12, 8.0), "tick"] + [(1, 8.0), "tick"] * 5 + [
            (30, 8.0), "tick"]
    elif name == "warmth-retires-cold":
        handles = [_Handle("r0"), _Handle("r1")]
        feed = ["protect-r0", (12, 0.0), "tick"]
    elif name == "warmth-holds":
        handles = [_Handle("r0"), _Handle("r1")]
        feed = ["protect-both", (12, 0.0), "tick"]
    elif name == "flap":
        kw = dict(scale_cooldown=40.0, scale_max=2)
        feed = [(12, 8.0), "tick", (12, 0.0), "tick"] * 4
    elif name == "min-floor":
        kw = dict(scale_cooldown=1000.0)
        feed = [(12, 8.0), "tick", "kill-all", (1, 8.0), "tick"]
    elif name == "starved":
        kw = dict(scale_starve_rate=1.0)
        feed = [("counters", 12, 0.5), "tick"]
    elif name == "dry-run":
        kw, dry = dict(scale_dry_run=True), True
        feed = [(12, 8.0), "tick"]
    elif name == "die":
        feed = ["die", "tick"]
    gw = _StubGateway(mods, handles, clock)
    scaler = scaler_mod.AutoScaler(
        gw, _scale_cfg(config, **kw),
        spawn_fn=None if dry else (lambda n: _Handle(n)), now=clock)
    ticks = []
    for step in feed:
        if step == "tick":
            ticks.append(scaler.tick())
        elif step == "protect-r0":
            gw.protected = {"r0": [[32, 4, 4, 32, 5, 9]]}
        elif step == "protect-both":
            gw.protected = {"r0": [[1]], "r1": [[2]]}
        elif step == "kill-all":
            for h in gw.replicas.all():
                h.dead = True
        elif step == "die":
            faults.install("scaler:1:die")
        elif step[0] == "counters":
            _feed(gw, clock, step[1], step[2], counters={
                "usage.tenant.acme.queue_seconds": 2.0,
                "usage.tenant.acme.flops": 1e9})
        else:
            _feed(gw, clock, *step)
    faults.install(None)
    snap = gw.registry.snapshot()
    scale = {k: v for part in ("counters", "gauges")
             for k, v in snap[part].items() if k.startswith("fleet.scale.")}
    # `ts` is the NULL tracer's wall clock, not the injected one
    records = [{k: v for k, v in json.loads(x)["scaleEntry"].items()
                if k != "ts"}
               for x in gw.writer.getvalue().splitlines()]
    return (records, scale, gw.adopted, gw.preempted,
            [h.retired for h in gw.replicas.all()], ticks)


_SCENARIOS = ["sustained", "cooldown", "warmth-retires-cold",
              "warmth-holds", "flap", "min-floor", "starved", "dry-run",
              "die"]


@pytest.mark.parametrize("name", _SCENARIOS)
def test_autoscaler_decisions_equal_jax(name):
    got = _scenario(name, _PORT)
    assert got == _scenario(name, _JAX)
    records, scale, adopted, preempted, _, ticks = got
    if name == "sustained":
        assert adopted == ["s0"] and records[0]["reason"] == "queue_depth"
    elif name == "cooldown":
        assert adopted == ["s0", "s1"]
        assert scale["fleet.scale.blocked_cooldown"] == 5
    elif name == "warmth-retires-cold":
        assert preempted == ["r1"] and records[-1]["evidence"][
            "warmth_skipped"] == {"r0": [[32, 4, 4, 32, 5, 9]]}
    elif name == "warmth-holds":
        assert preempted == [] and records[-1]["blocked"] == "warmth"
    elif name == "flap":
        acted = scale["fleet.scale.ups"] + scale["fleet.scale.downs"]
        assert 1 <= acted <= 1 + int(96 // 40)
    elif name == "min-floor":
        assert records[-1]["reason"] == "min_floor" and len(adopted) == 2
    elif name == "starved":
        assert records[-1]["reason"] == "tenant_starved:acme"
    elif name == "dry-run":
        assert adopted == [] and records[-1]["dry_run"] is True
    elif name == "die":
        assert ticks == [False] and records == []


def test_scale_snapshot_ignores_retiring_owner():
    """tests/test_scale.py:347 on the port's Gateway, never started: the
    warmth guard counts surviving capacity only."""
    r0 = treplicas.ReplicaHandle("r0", "http://127.0.0.1:1")
    r1 = treplicas.ReplicaHandle("r1", "http://127.0.0.1:2")
    cfg = tconfig.FleetConfig(replicas=[r0.url, r1.url],
                              listen="127.0.0.1:0", scale_max=3,
                              scale_dry_run=True)
    gw = Gateway(cfg, [r0, r1])
    try:
        bucket = (32, 4, 4, 32, 5, 9)
        gw.router._warm = {"r0": {bucket}, "r1": {bucket}}
        gw._bucket_routed_t[bucket] = gw.now()
        r0.retired = True
        gw._refresh_view()
        snap = gw.scale_snapshot()
        assert snap["protected"] == {"r1": [list(bucket)]}
        assert snap["replicas"]["r0"]["retired"] is True
        r0.retired = False
        gw._refresh_view()
        assert gw.scale_snapshot()["protected"] == {}
    finally:
        gw.close()


def test_spawned_workers_default_to_the_card(tmp_path, monkeypatch):
    """`fleet --spawn` without --backend starts `serve --http --backend
    gpu` workers; on a machine with no card they exit with an error and
    the gateway reports them dead (no fallback to the CPU)."""
    import os
    import time

    from timetabling_ga_tpu_torch.fleet.replicas import http_json
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", repo)
    cfg = tconfig.parse_fleet_args(
        ["--spawn", "1", "--listen", "127.0.0.1:0", "--max-restarts",
         "0", "--probe-every", "0.1", "--poll-every", "0.05"])
    handles = treplicas.spawn_local(cfg)
    assert handles[0].proc.args[-4:] == [
        "--backend", "gpu", "-o", "tt-fleet-r0.jsonl"]
    gw = Gateway(cfg, handles, owned=True).start()
    try:
        deadline = time.monotonic() + 120.0
        while not handles[0].dead:
            assert time.monotonic() < deadline, "the worker never died"
            time.sleep(0.05)
        assert handles[0].proc.returncode not in (None, 0)
        view = http_json("GET", gw.url + "/v1/fleet", ok=(200,))
        assert [(r["name"], r["dead"]) for r in view["replicas"]] == [
            ("r0", True)]
        ready = http_json("GET", gw.url + "/readyz", ok=(503,))
        assert "no_ready_replica" in ready["reasons"]
    finally:
        gw.close()
