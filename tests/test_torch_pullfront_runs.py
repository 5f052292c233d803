"""The pull front, the history ring, the flight recorder and the memory
poller wired into the port's engine run and serve service
(timetabling_ga_tpu_torch/runtime/engine.py `run`, serve/service.py),
on the CPU, against the JAX package's wiring.

  engine  `--obs --obs-listen 127.0.0.1:0 --incident-dir ... --faults
          dispatch:2:unavailable` with a thread scraping every route
          during the run: the record stream under strip_timing equals
          the clean run's, the fault's bundle has the trigger and the
          sections of a JAX run of the same flags, its flight_dump span
          is on the stream, and no observability thread outlives run()
  serve   the same surfaces on a service: /readyz reads backlog_full
          while the queue is at its bound, a quantum fault writes its
          bundle, the streams equal those of the same faults without
          the surfaces
  ports   a listener address in use raises out of run() and out of the
          service's constructor, with every thread they started closed
"""

import contextlib
import io
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from timetabling_ga_tpu.obs import metrics as jmetrics
from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.runtime import faults as jfaults
from timetabling_ga_tpu.runtime.config import RunConfig as JRunConfig
from timetabling_ga_tpu_torch.obs import flight as tflight
from timetabling_ga_tpu_torch.obs import http as thttp
from timetabling_ga_tpu_torch.obs import metrics as tmetrics
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime import faults as tfaults
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl
from timetabling_ga_tpu_torch.runtime.config import RunConfig as TRunConfig
from timetabling_ga_tpu_torch.runtime.config import ServeConfig
from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing

torch.set_num_threads(1)

# the observability threads' names (obs/history.py, flight.py, cost.py,
# http.py, usage.py); the JAX package's threads have the same names, and
# an earlier test in the worker may have abandoned one (a hung thread is
# never waited out), so a test counts only the threads it started
_OBS_THREADS = ("tt-history", "tt-flight", "tt-mem-poll", "tt-obs_listen",
                "tt-usage")

# tests/test_torch_faults.py's run, on its 15-event instance; without
# the sec/gen probe both packages run the first chunk serially, so the
# fault at the second dispatch falls after a retired chunk in each
_RUN = dict(seed=3, pop_size=8, islands=1, generations=20,
            migration_period=5, max_steps=8, time_limit=300,
            backend="cpu", auto_tune=False, trace=True, precompile=False)


@pytest.fixture(autouse=True)
def _no_plans():
    tfaults.install(None)
    jfaults.install(None)
    yield
    tfaults.install(None)
    jfaults.install(None)


@pytest.fixture(scope="module")
def tim_file(tmp_path_factory):
    problem = random_instance(55, n_events=15, n_rooms=5, n_features=2,
                              n_students=10, attend_prob=0.1)
    path = tmp_path_factory.mktemp("pullfront") / "tiny.tim"
    path.write_text(dump_tim(problem))
    return str(path)


@contextlib.contextmanager
def _fresh_registries():
    saved = jmetrics.REGISTRY, tmetrics.REGISTRY
    jmetrics.REGISTRY = jmetrics.MetricsRegistry()
    tmetrics.REGISTRY = tmetrics.MetricsRegistry()
    try:
        yield
    finally:
        jmetrics.REGISTRY, tmetrics.REGISTRY = saved


def _obs_threads(known):
    """The live observability threads not in the set `known`."""
    return [t.name for t in threading.enumerate()
            if t.name in _OBS_THREADS and t.is_alive() and t not in known]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5.0) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


class _Scraper:
    """Records every ObsServer the port builds (the listener binds
    127.0.0.1:0, so its port is known only then) and scrapes each route
    of the newest one from a thread until stopped.

    The run is held at the front's start until the scraper has an
    answer from every route and one non-empty history series (or
    GATE_S passes): a 20-generation run on the 15-event instance can
    end before a loaded worker lands one round of scrapes. And the
    run's writer stops only after the scraper has stopped (its last
    scrape answered): /healthz probes the writer, and the run closes
    its front after the writer (JAX's order, engine.py), so a scrape
    landing between the two would read the run's teardown, not the
    run."""

    ROUTES = ("/metrics", "/healthz", "/readyz",
              "/metrics/history?window=10")
    GATE_S = 60.0

    def __init__(self, monkeypatch):
        self.servers, self.answers = [], []
        self._stop = threading.Event()
        self._ready = threading.Event()
        real = thttp.ObsServer
        scraper = self

        class Recorded(real):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                scraper.servers.append(self)

            def start(self):
                started = super().start()
                scraper._ready.wait(scraper.GATE_S)
                return started

        monkeypatch.setattr(thttp, "ObsServer", Recorded)
        real_close = tjsonl.AsyncWriter.close

        def close(writer, *a, **k):
            scraper.close()
            return real_close(writer, *a, **k)

        monkeypatch.setattr(tjsonl.AsyncWriter, "close", close)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(0.05):
            if not self.servers:
                continue
            for route in self.ROUTES:
                try:
                    self.answers.append(
                        (route, *_get(self.servers[-1].url + route)))
                except (urllib.error.URLError, OSError):
                    pass            # the run ended and closed the front
            if self._has_every_route():
                self._ready.set()

    def _has_every_route(self):
        history = self.got("/metrics/history?window=10")
        return (all(self.got(route) for route in self.ROUTES)
                and any(a[1] == 200 and json.loads(a[3])["series"]
                        for a in history))

    def close(self):
        self._stop.set()
        self._ready.set()
        self._thread.join(timeout=10.0)

    def got(self, route):
        return [a for a in self.answers if a[0] == route]


def _engine(engine_mod, config, tim_file, **kw):
    buf = io.StringIO()
    best = engine_mod.run(config(**dict(_RUN, input=tim_file, **kw)),
                          out=buf)
    return best, [json.loads(x) for x in buf.getvalue().splitlines()]


def _surfaces(tmp, name):
    return dict(obs=True, obs_listen="127.0.0.1:0", history_every=0.05,
                incident_dir=str(tmp / name), incident_min_interval=0.0,
                mem_poll_every=0.05, faults="dispatch:2:unavailable")


def _bundle_shape(core):
    """The trigger and the section keys (the metrics snapshot's kinds
    depend on whether a dispatch retired before the fault: timing)."""
    return core["trigger"], sorted(core), sorted(core["history"])


def test_engine_surfaces_leave_the_stream_alone(tim_file, tmp_path,
                                                monkeypatch):
    from timetabling_ga_tpu.runtime import engine as jengine
    from timetabling_ga_tpu_torch.runtime import engine as tengine
    with _fresh_registries():
        best, clean = _engine(tengine, TRunConfig, tim_file)
    known = set(threading.enumerate())
    scraper = _Scraper(monkeypatch)
    try:
        with _fresh_registries():
            best_on, on = _engine(tengine, TRunConfig, tim_file,
                                  **_surfaces(tmp_path, "port"))
    finally:
        scraper.close()
    assert best_on == best
    assert strip_timing(on) == strip_timing(clean)
    assert not _obs_threads(known)
    assert len(scraper.servers) == 1 and not scraper.servers[0].alive()
    # the front answered during the run
    metrics = scraper.got("/metrics")
    assert metrics and all(a[1] == 200 for a in metrics)
    assert metrics[-1][3].decode().endswith("# EOF\n")
    assert all(a[1] == 200 for a in scraper.got("/healthz"))
    for _, status, ctype, body in scraper.got("/readyz"):
        assert ctype == "application/json"
        assert set(json.loads(body)) == {
            "ready", "reasons", "queue_depth", "backlog", "degrade_level",
            "recovery_budget_remaining", "mem_frac_used", "stalled",
            "draining"}
    assert any(json.loads(a[3])["series"]
               for a in scraper.got("/metrics/history?window=10"))
    # the fault's bundle, and its dump span on the stream
    cores = [tflight.load_bundle(p) for p in
             tflight.list_bundles(str(tmp_path / "port"))]
    fault_cores = [c for c in cores
                   if c["trigger"].startswith("fault:dispatch")]
    assert len(fault_cores) == 1, [c["trigger"] for c in cores]
    core = fault_cores[0]
    assert core["process"] == "engine" and core["records"]
    assert core["config"]["values"]["obs_listen"] == "127.0.0.1:0"
    assert "device.mem_polls" in core["metrics"]["counters"]
    assert core["history"]["series"]
    assert any(r.get("spanEntry", {}).get("name") == "flight_dump"
               for r in on)
    # a JAX run of the same flags writes a bundle of the same shape
    saved = jengine._purge_programs
    jengine._purge_programs = lambda mesh: None
    try:
        with _fresh_registries():
            _engine(jengine, JRunConfig, tim_file,
                    **_surfaces(tmp_path, "jax"))
    finally:
        jengine._purge_programs = saved
    jcores = [tflight.load_bundle(p) for p in
              tflight.list_bundles(str(tmp_path / "jax"))]
    jfault = [c for c in jcores if c["trigger"].startswith("fault:dispatch")]
    assert [_bundle_shape(c) for c in jfault] == [_bundle_shape(core)]


# ---------------------------------------------------------------- serve

_TIM_A = dump_tim(random_instance(71, n_events=12, n_rooms=3, n_features=2,
                                  n_students=8, attend_prob=0.2))
_TIM_B = dump_tim(random_instance(72, n_events=40, n_rooms=4, n_features=2,
                                  n_students=30, attend_prob=0.1))
_JOBS = (("qa", _TIM_A, 3, 15), ("qb", _TIM_B, 4, 15))


def _serve(tmp, surfaces, readyz=None):
    """tests/test_torch_serve_faults.py's two jobs under a quantum fault,
    with a backlog of two; returns (service, record text, the /readyz
    answer while both jobs are queued)."""
    from timetabling_ga_tpu_torch.serve.service import SolveService
    kw = dict(backend="cpu", lanes=2, quantum=5, pop_size=4, max_steps=8,
              backlog=2, faults="quantum:2:unavailable")
    if surfaces:
        kw.update(obs_listen="127.0.0.1:0", history_every=0.05,
                  incident_dir=str(tmp / "inc"), incident_min_interval=0.0)
    buf = io.StringIO()
    svc = SolveService(ServeConfig(**kw), out=buf,
                       registry=tmetrics.MetricsRegistry())
    ready = None
    try:
        for jid, tim, seed, gens in _JOBS:
            svc.submit(load_tim(tim), job_id=jid, seed=seed,
                       generations=gens)
        if surfaces:
            ready = _get(svc.obs_server.url + "/readyz")
        svc.drive()
    finally:
        svc.close()
    return svc, buf.getvalue(), ready


def test_serve_readyz_and_quantum_bundle(tmp_path):
    _, base, _ = _serve(tmp_path, False)
    known = set(threading.enumerate())
    svc, text, ready = _serve(tmp_path, True)
    assert not _obs_threads(known) and not svc.obs_server.alive()
    status, ctype, body = ready
    assert status == 503 and ctype == "application/json"
    body = json.loads(body)
    assert body["reasons"] == ["backlog_full"]
    assert (body["queue_depth"], body["backlog"]) == (2.0, 2.0)
    lines = [json.loads(x) for x in text.splitlines()]
    assert strip_timing(lines) == strip_timing(
        [json.loads(x) for x in base.splitlines()])
    cores = [tflight.load_bundle(p)
             for p in tflight.list_bundles(str(tmp_path / "inc"))]
    quantum = [c for c in cores if c["trigger"] == "fault:quantum/requeue"]
    assert len(quantum) == 1, [c["trigger"] for c in cores]
    assert quantum[0]["process"] == "serve"
    assert quantum[0]["config"]["kind"] == "ServeConfig"
    status, body = tflight.incident_response(svc.flight)
    assert status == 200 and body["incident"]["trigger"].startswith(
        ("fault:quantum", "reason:"))


def test_taken_port_leaks_nothing(tim_file, tmp_path):
    """The listener's address is in use: run() and the service raise,
    every observability thread they started is closed, and the
    service's pull gauges are released (JAX service.py:184-205)."""
    from timetabling_ga_tpu_torch.runtime import engine as tengine
    from timetabling_ga_tpu_torch.serve.service import SolveService
    taken = thttp.ObsServer("127.0.0.1:0").start()
    known = set(threading.enumerate())
    listen = f"127.0.0.1:{taken.address[1]}"
    try:
        with _fresh_registries(), pytest.raises(OSError):
            _engine(tengine, TRunConfig, tim_file, obs=True,
                    obs_listen=listen, incident_dir=str(tmp_path / "e"))
        assert not _obs_threads(known)
        reg = tmetrics.MetricsRegistry()
        with pytest.raises(OSError):
            SolveService(ServeConfig(backend="cpu", obs=True,
                                     obs_listen=listen,
                                     incident_dir=str(tmp_path / "s")),
                         out=io.StringIO(), registry=reg)
        assert not _obs_threads(known)
        gauges = reg.snapshot()["gauges"]
        assert gauges["writer.queue_depth"] == 0.0
        assert gauges["serve.queue_depth"] == 0.0
    finally:
        taken.close()
    assert not taken.alive()
