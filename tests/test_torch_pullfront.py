"""The port's pull front, history ring, memory poller and scrape parsers
(timetabling_ga_tpu_torch/obs/http.py, history.py, cost.py, scrape.py)
against the JAX package's.

  readiness   the same (ready, body) for the same gauges, one case per
              reason string (a wire contract), none, several, absent
  listen      parse_listen accepts and refuses the same specs, with the
              same messages
  scrape      parse_exposition, parse_exemplars, scalar, labeled and
              hit_rate give equal results on the port's expositions
  history     the same samples at the same injected times give equal
              window(), series(), rate, mean_over and sustained answers
  front       both packages' ObsServers over equal registries answer
              every route with the same status, content type and body
              (/profile: the 404 of a server with no capture wired); a
              scrape changes no instrument
  poller      MemPoller's gauges and counters equal JAX's for the same
              stats; the port's stats source is None on the CPU
  faults      the obs_listen, scrape, mem_poll and history sites act as
              JAX's do (tests/test_obs.py:799-900, test_cost.py:143-200)

Every server and thread is closed in a `finally`.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from timetabling_ga_tpu.obs import cost as jcost
from timetabling_ga_tpu.obs import history as jhistory
from timetabling_ga_tpu.obs import http as jhttp
from timetabling_ga_tpu.obs import metrics as jmetrics
from timetabling_ga_tpu.obs import scrape as jscrape
from timetabling_ga_tpu.runtime import faults as jfaults
from timetabling_ga_tpu_torch.obs import cost as tcost
from timetabling_ga_tpu_torch.obs import history as thistory
from timetabling_ga_tpu_torch.obs import http as thttp
from timetabling_ga_tpu_torch.obs import metrics as tmetrics
from timetabling_ga_tpu_torch.obs import scrape as tscrape
from timetabling_ga_tpu_torch.runtime import faults as tfaults

# (jax modules, port modules) for the parametrized package runs
_PKGS = {"jax": (jhttp, jhistory, jcost, jmetrics, jfaults),
         "port": (thttp, thistory, tcost, tmetrics, tfaults)}


@pytest.fixture(autouse=True)
def _no_fault_plans():
    jfaults.install(None)
    tfaults.install(None)
    yield
    jfaults.install(None)
    tfaults.install(None)


# ------------------------------------------------------------ readiness

# one case per reason string, the all-clear and absent-gauge cases,
# thresholds just below each condition, and several reasons at once
_READINESS = {
    "none": {},
    "clear": {"serve.queue_depth": 3, "serve.backlog": 4,
              "engine.degrade_level": 1,
              "engine.recovery_budget_remaining": 2,
              "engine.recovery_budget_configured": 3,
              "device.mem_frac_used": 0.5, "engine.stalled": 0,
              "serve.draining": 0, "fleet.replicas_ready": 1,
              "fleet.tick_age_s": 1.0, "fleet.tick_stall_after": 5.0,
              "fleet.slo_burn": 0},
    "backlog_full": {"serve.queue_depth": 4, "serve.backlog": 4},
    "backlog_zero_bound": {"serve.queue_depth": 4, "serve.backlog": 0},
    "degraded": {"engine.degrade_level": 2},
    "recovery_exhausted": {"engine.recovery_budget_remaining": 0,
                           "engine.recovery_budget_configured": 3},
    "recovery_unconfigured": {"engine.recovery_budget_remaining": 0,
                              "engine.recovery_budget_configured": 0},
    "near_hbm_limit": {"device.mem_frac_used": 0.95},
    "near_hbm_limit_edge": {"device.mem_frac_used": tcost.NEAR_HBM_FRAC},
    "stalled": {"engine.stalled": 1},
    "draining": {"serve.draining": 1},
    "no_ready_replica": {"fleet.replicas_ready": 0},
    "dispatcher_stalled": {"fleet.tick_age_s": 6.0,
                           "fleet.tick_stall_after": 5.0},
    "stall_watch_off": {"fleet.tick_age_s": 6.0,
                        "fleet.tick_stall_after": 0},
    "slo_burn": {"fleet.slo_burn": 1},
    "several": {"serve.queue_depth": 9, "serve.backlog": 4,
                "engine.degrade_level": 3, "engine.stalled": 1,
                "device.mem_frac_used": 0.99, "fleet.slo_burn": 1},
}


def _registry(metrics_mod, gauges: dict):
    reg = metrics_mod.MetricsRegistry()
    for name, v in gauges.items():
        reg.gauge(name).set(v)
    return reg


@pytest.mark.parametrize("case", sorted(_READINESS))
def test_readiness_equals_jax(case):
    gauges = _READINESS[case]
    want = jhttp.readiness(_registry(jmetrics, gauges))
    got = thttp.readiness(_registry(tmetrics, gauges))
    assert got == want
    assert tcost.NEAR_HBM_FRAC == jcost.NEAR_HBM_FRAC
    if case in ("backlog_full", "degraded", "recovery_exhausted",
                "near_hbm_limit", "stalled", "draining",
                "no_ready_replica", "dispatcher_stalled", "slo_burn"):
        assert got == (False, dict(got[1], reasons=[case], ready=False))
    assert got[0] == (not got[1]["reasons"])


# ---------------------------------------------------------- parse_listen

_SPECS = ["127.0.0.1:0", "localhost:8080", "0.0.0.0:65535", "[::1]:9",
          "a:b:1", ":80", "host", "host:", "host:x", "host:70000",
          "host:-1", 8080, "1.2.3.4:1.5"]


@pytest.mark.parametrize("spec", _SPECS, ids=[str(s) for s in _SPECS])
def test_parse_listen_equals_jax(spec):
    def outcome(fn):
        try:
            return "ok", fn(spec)
        except ValueError as e:
            return "error", str(e)
    assert outcome(thttp.parse_listen) == outcome(jhttp.parse_listen)


# ---------------------------------------------------------- scrape parsers


def _drive(reg):
    """Counters, gauges, a pull gauge and histograms with exemplars, on
    either package's registry (the router's families among them)."""
    reg.counter("compile.count").inc(3)
    reg.counter("compile.cache_hits").inc(9)
    reg.counter("engine.gens").inc(30)
    reg.gauge("serve.queue_depth").set(5)
    reg.gauge("serve.backlog").set(8)
    reg.gauge("flight.dumps").set(2)
    reg.gauge_fn("writer.queue_depth", lambda: 3)
    h = reg.histogram("engine.dispatch_seconds")
    for i, v in enumerate((0.0004, 0.003, 0.07, 2.0)):
        h.observe(v, exemplar={"dispatch": str(i)})
    q = reg.histogram("serve.job_seconds", buckets=(0.5, 1.0))
    q.observe(0.7, exemplar={"job": 'a"b\\c\nd'})
    q.observe(0.2, exemplar={})


@pytest.mark.parametrize("render", ["to_openmetrics", "to_prometheus"])
def test_scrape_parsers_equal_jax(render):
    reg = tmetrics.MetricsRegistry()
    _drive(reg)
    text = getattr(reg, render)() + "garbage line {\nname{x=1} notnum\n"
    fams = tscrape.parse_exposition(text)
    assert fams == jscrape.parse_exposition(text)
    assert tscrape.parse_exemplars(text) == jscrape.parse_exemplars(text)
    for name in ("tt_serve_queue_depth", "tt_engine_gens_total",
                 "tt_engine_dispatch_seconds_bucket", "absent"):
        assert (tscrape.scalar(fams, name, -1.0)
                == jscrape.scalar(fams, name, -1.0))
    for le in ("0.005", "+Inf", "nope"):
        assert (tscrape.labeled(fams, "tt_engine_dispatch_seconds_bucket",
                                le=le)
                == jscrape.labeled(fams,
                                   "tt_engine_dispatch_seconds_bucket",
                                   le=le))
    assert tscrape.hit_rate(fams) == jscrape.hit_rate(fams) == 0.75
    assert tscrape.hit_rate({}) == jscrape.hit_rate({}) == 0.0
    if render == "to_openmetrics":
        ex = tscrape.parse_exemplars(text)
        assert ("tt_serve_job_seconds_bucket", {"job": 'a"b\\c\nd'},
                0.7) in ex
    for name in ("QUEUE_DEPTH", "BACKLOG", "COMPILE_COUNT", "COMPILE_HITS",
                 "FLIGHT_DUMPS", "RESIDENT_GROUPS", "RESIDENT_BYTES"):
        assert getattr(tscrape, name) == getattr(jscrape, name)


# --------------------------------------------------------------- history


def _drive_ring(pkg, every, capacity, steps):
    """A ring over a fresh registry on an injected clock: `steps`
    samples `every` seconds apart, counters, gauges and a histogram
    moving between them; returns the answers of every query."""
    _, hist_mod, _, metrics_mod, _ = _PKGS[pkg]
    t = [10.0]
    reg = metrics_mod.MetricsRegistry()
    ring = hist_mod.HistoryRing(registry=reg, every_s=every,
                                capacity=capacity, now=lambda: t[0])
    reg.gauge("g").set(4.0)
    reg.gauge_fn("nan", lambda: 1 / 0)
    lat = reg.histogram("lat")
    answers = []
    for i in range(steps):
        reg.counter("c").inc(3 if i % 2 else 1)
        reg.gauge("g").set(4.0 + (i % 3))
        lat.observe(0.1 * i)
        assert ring.sample_once()
        t[0] += every
    for w in (None, 0.0, every, 2.5 * every, 100.0):
        answers.append(("window", w, ring.window(w)))
    for name in ("c", "g", "lat.count", "lat.sum", "nan", "absent"):
        answers.append(("series", name, ring.series(name),
                        ring.series(name, 2 * every)))
        for w in (every, 3 * every, 100.0):
            answers.append(("rate", name, w, ring.rate(name, w)))
            answers.append(("mean", name, w, ring.mean_over(name, w)))
        for op, thr in ((">=", 4.0), ("<=", 6.0), (">", 4.0), ("<", 7.0),
                        ("==", 4.0)):
            for for_s in (0.0, every, 3 * every, 100.0):
                answers.append(("sustained", name, op, thr, for_s,
                                ring.sustained(name, op, thr, for_s)))
    answers.append(("names", ring.names()))
    with pytest.raises(ValueError) as e:
        ring.sustained("g", "~", 1.0, 1.0)
    answers.append(("bad op", str(e.value)))
    return answers


@pytest.mark.parametrize("every,capacity,steps", [
    (1.0, None, 6), (0.2, 4, 9), (0.01, 600, 3), (2.0, 1, 2)])
def test_history_ring_equals_jax(every, capacity, steps):
    assert thistory.HISTORY_CAP == jhistory.HISTORY_CAP
    got = _drive_ring("port", every, capacity, steps)
    want = _drive_ring("jax", every, capacity, steps)
    assert got == want


def test_history_sustained_requires_coverage():
    """A ring that has not watched the signal for the window answers
    False (tests/test_flight.py test_history_sustained_requires_coverage,
    on the port)."""
    t = [0.0]
    reg = tmetrics.MetricsRegistry()
    ring = thistory.HistoryRing(registry=reg, every_s=1.0,
                                now=lambda: t[0])
    reg.gauge("g").set(9.0)
    ring.sample_once()
    t[0] += 0.5
    assert not ring.sustained("g", ">=", 1.0, 30.0)
    assert not ring.sustained("nope", ">=", 1.0, 1.0)
    assert ring.rate("g", 30.0) is None
    assert ring.mean_over("nope", 1.0) is None
    for _ in range(30):
        t[0] += 1.0
        ring.sample_once()
    assert ring.sustained("g", ">=", 1.0, 30.0)


def test_history_thread_samples_and_closes():
    """start() samples on the ring's own thread; close() joins it."""
    reg = tmetrics.MetricsRegistry()
    reg.counter("c").inc()
    ring = thistory.HistoryRing(registry=reg, every_s=0.05).start()
    try:
        deadline = time.monotonic() + 20.0
        while len(ring.series("c")) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(ring.series("c")) >= 2 and ring.alive()
    finally:
        ring.close()
    assert not ring.alive()


# ----------------------------------------------------------- the front


def _get(url, timeout=5.0):
    """(status, content type, body bytes), HTTP errors included."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


_ROUTES = ["/metrics", "/healthz", "/readyz", "/metrics/history",
           "/metrics/history?window=1.5", "/metrics/history?window=soon",
           "/profile", "/profile?for=2", "/nope"]


def _front(pkg, gauges, probes, with_ring):
    """A server of package `pkg` over a registry holding `gauges` and
    the same histogram, with a ring sampled three times on an injected
    clock (or none); returns (server, registry)."""
    http_mod, hist_mod, _, metrics_mod, _ = _PKGS[pkg]
    reg = _registry(metrics_mod, gauges)
    reg.histogram("engine.dispatch_seconds").observe(
        0.07, exemplar={"dispatch": "3"})
    ring = None
    if with_ring:
        t = [0.0]
        ring = hist_mod.HistoryRing(registry=reg, every_s=1.0,
                                    now=lambda: t[0])
        for _ in range(3):
            ring.sample_once()
            t[0] += 1.0
    srv = http_mod.ObsServer("127.0.0.1:0", registry=reg, probes=probes,
                             history=ring)
    return srv.start(), reg


@pytest.mark.parametrize("case", [
    ("clear", True, True), ("backlog_full", True, False),
    ("several", False, True)], ids=["ready", "backlog_full", "unhealthy"])
def test_pull_front_answers_equal_jax(case):
    """Every route of the port's front answers what JAX's answers over
    the same registry state: status, content type and body."""
    gauges, healthy, with_ring = _READINESS[case[0]], case[1], case[2]
    probes = {"process": lambda: True,
              "writer": (lambda: True) if healthy else (lambda: 1 / 0)}
    servers = []
    try:
        for pkg in ("jax", "port"):
            servers.append(_front(pkg, gauges, probes, with_ring))
        (jsrv, _), (tsrv, treg) = servers
        assert tsrv.address[0] == "127.0.0.1" and tsrv.address[1] > 0
        assert tsrv.url == f"http://127.0.0.1:{tsrv.address[1]}"
        before = treg.snapshot()
        for route in _ROUTES:
            got = _get(tsrv.url + route)
            want = _get(jsrv.url + route)
            assert got == want, route
        # a scrape changes no instrument
        assert treg.snapshot() == before
        status, ctype, body = _get(tsrv.url + "/metrics")
        assert ctype == thttp.OPENMETRICS_CT == jhttp.OPENMETRICS_CT
        assert body.decode().endswith("# EOF\n")
        assert b'# {dispatch="3"} 0.07' in body
        status, _, body = _get(tsrv.url + "/profile")
        assert status == 404 and json.loads(body)["reason"] == (
            "no profile capture wired (--profile-dir/--profile-for)")
    finally:
        for srv, _ in servers:
            srv.close()
    for srv, _ in servers:
        assert not srv.alive()


def test_taken_port_raises():
    """A listener whose address is in use raises at construction, as
    JAX's does; nothing carries on silently."""
    first = thttp.ObsServer("127.0.0.1:0").start()
    try:
        with pytest.raises(OSError):
            thttp.ObsServer(f"127.0.0.1:{first.address[1]}")
    finally:
        first.close()


def test_close_without_start_and_twice():
    srv = thttp.ObsServer("127.0.0.1:0")
    srv.close()
    srv.close()
    assert not srv.alive()


# -------------------------------------------------------------- poller


def _poll(pkg, stats_seq):
    """MemPoller of package `pkg` on a fresh registry fed `stats_seq`
    (a dict, None, or an exception to raise), one poll each; returns
    the registry snapshot after each poll."""
    _, _, cost_mod, metrics_mod, _ = _PKGS[pkg]
    reg = metrics_mod.MetricsRegistry()
    it = iter(stats_seq)

    def stats():
        s = next(it)
        if isinstance(s, Exception):
            raise s
        return s

    poller = cost_mod.MemPoller(stats, interval_s=1.0, registry=reg)
    snaps = []
    for _ in stats_seq:
        assert poller.poll_once()
        snaps.append(reg.snapshot())
    return snaps


def test_mem_poller_equals_jax():
    seq = [None, {"bytes_in_use": 10, "bytes_limit": 100,
                  "peak_bytes_in_use": 40},
           RuntimeError("torn read"), {"bytes_in_use": 95},
           {"bytes_limit": 0, "bytes_in_use": 1}, {},
           {"bytes_in_use": 96, "bytes_limit": 100}]
    got, want = _poll("port", seq), _poll("jax", seq)
    assert got == want
    assert got[-1]["gauges"]["device.mem_frac_used"] == 0.96
    assert got[-1]["counters"] == {"device.mem_polls": 6.0,
                                   "device.mem_poll_errors": 1.0}


def test_torch_memory_stats_fn_on_the_cpu():
    """No allocator stats on the CPU: the source returns None, so the
    poller counts its polls and sets no gauge (JAX's CPU behavior)."""
    read = tcost.torch_memory_stats_fn("cpu")
    assert read() is None
    reg = tmetrics.MetricsRegistry()
    poller = tcost.MemPoller(read, interval_s=0.05, registry=reg).start()
    try:
        deadline = time.monotonic() + 20.0
        while (reg.snapshot()["counters"].get("device.mem_polls", 0) < 2
               and time.monotonic() < deadline):
            time.sleep(0.02)
    finally:
        poller.close()
    snap = reg.snapshot()
    assert snap["counters"]["device.mem_polls"] >= 2
    assert not any(n.startswith("device.") for n in snap.get("gauges", {}))
    assert not poller.alive()


# -------------------------------------------------------------- faults


def _site_outcomes(pkg, spec):
    """What each observability thread does under fault plan `spec` in
    package `pkg`: the poller's and the sampler's return values and
    error counters, the listener's accept loop and two scrapes."""
    http_mod, hist_mod, cost_mod, metrics_mod, faults_mod = _PKGS[pkg]
    faults_mod.install(spec)
    reg = metrics_mod.MetricsRegistry()
    reg.gauge("g").set(1.0)
    out = {}
    poller = cost_mod.MemPoller(lambda: {"bytes_in_use": 1,
                                         "bytes_limit": 2},
                                registry=reg)
    out["mem_poll"] = [poller.poll_once(), poller.poll_once()]
    ring = hist_mod.HistoryRing(registry=reg, every_s=1.0,
                                now=lambda: 0.0)
    out["history"] = [ring.sample_once(), ring.sample_once()]
    out["counters"] = reg.snapshot()["counters"]
    srv = http_mod.ObsServer("127.0.0.1:0", registry=reg).start()
    try:
        if spec and spec.startswith("obs_listen"):
            srv._thread.join(timeout=10.0)     # the accept loop ends
        out["accepting"] = srv.alive()
        scrapes = []
        if out["accepting"]:
            for _ in range(2):
                try:
                    scrapes.append(_get(srv.url + "/healthz",
                                        timeout=2.0)[0])
                except (urllib.error.URLError, ConnectionError, OSError):
                    scrapes.append("dropped")
        out["scrapes"] = scrapes
    finally:
        srv.close()
        faults_mod.install(None)
    return out


@pytest.mark.parametrize("spec", [
    "obs_listen:1:die", "obs_listen:1:error", "scrape:1:die",
    "scrape:1:error", "scrape:2:unavailable", "mem_poll:1:die",
    "mem_poll:1:error", "mem_poll:2:unavailable", "history:1:die",
    "history:2:error", None])
def test_obs_fault_sites_act_as_jax(spec):
    got = _site_outcomes("port", spec)
    want = _site_outcomes("jax", spec)
    assert got == want


@pytest.mark.parametrize("site", ["scrape", "mem_poll", "history"])
def test_a_hung_thread_parks_alone(site, monkeypatch):
    """A `hang` parks the thread that hit it and nothing else: a hung
    scrape leaves the next scrape answered, a hung poller or sampler
    leaves its owner's close() returning after its 2 s join (the thread
    is abandoned), each well before the hang ends."""
    monkeypatch.setattr(tfaults, "HANG_S", 6.0)
    tfaults.install(f"{site}:1:hang")
    reg = tmetrics.MetricsRegistry()
    reg.counter("c").inc()
    try:
        if site == "scrape":
            srv = thttp.ObsServer("127.0.0.1:0", registry=reg).start()
            try:
                parked = threading.Thread(
                    target=lambda: _get(srv.url + "/healthz"), daemon=True)
                parked.start()
                time.sleep(0.1)
                t0 = time.monotonic()
                assert _get(srv.url + "/healthz")[0] == 200
                assert time.monotonic() - t0 < 4.0
            finally:
                srv.close()
            parked.join(timeout=10.0)
            return
        if site == "mem_poll":
            owner = tcost.MemPoller(lambda: None, interval_s=0.05,
                                    registry=reg)
        else:
            owner = thistory.HistoryRing(registry=reg, every_s=0.05)
        owner.start()
        time.sleep(0.1)
        t0 = time.monotonic()
        owner.close()
        assert time.monotonic() - t0 < 4.5
    finally:
        tfaults.install(None)


# ---------------------------------------------------------------- flags

_FLIGHT_FIELDS = ("obs_listen", "history_every", "incident_dir",
                  "incident_min_interval", "mem_poll_every")
_FLAG_ARGVS = {
    "defaults": [],
    "set": ["--obs-listen", "127.0.0.1:9100", "--history-every", "0.5",
            "--incident-dir", "inc", "--incident-min-interval", "0",
            "--mem-poll-every", "2"],
    "zeros": ["--history-every", "0", "--mem-poll-every", "0"],
    "listen-no-port": ["--obs-listen", "nohost"],
    "listen-bad-port": ["--obs-listen", "h:x"],
    "listen-range": ["--obs-listen", "h:99999"],
    "history-negative": ["--history-every", "-1"],
    "interval-negative": ["--incident-min-interval", "-0.5"],
    "poll-negative": ["--mem-poll-every", "-1"],
    "no-value": ["--incident-dir"],
    "not-a-number": ["--history-every", "soon"],
}


@pytest.mark.parametrize("entry", ["run", "serve"])
@pytest.mark.parametrize("case", sorted(_FLAG_ARGVS))
def test_flight_flags_parse_as_jax(entry, case):
    """The five flags parse on both entry points with JAX's defaults,
    and a bad value stops the parse with JAX's exception and message."""
    from timetabling_ga_tpu.runtime import config as jconfig
    from timetabling_ga_tpu_torch.runtime import config as tconfig
    argv = _FLAG_ARGVS[case]
    if entry == "run":
        argv = ["-i", "x.tim"] + argv
    parse = "parse_args" if entry == "run" else "parse_serve_args"

    def outcome(config_mod):
        try:
            cfg = getattr(config_mod, parse)(argv)
        except (SystemExit, ValueError) as e:
            return type(e).__name__, str(e)
        return "ok", {f: getattr(cfg, f) for f in _FLIGHT_FIELDS}
    assert outcome(tconfig) == outcome(jconfig)
    for flag in ("--obs-listen", "--history-every", "--incident-dir",
                 "--incident-min-interval", "--mem-poll-every"):
        assert flag not in tconfig.NOT_PORTED
        assert flag in tconfig._SERVE_FLAG_MAP
