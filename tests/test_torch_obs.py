"""The port's observability (timetabling_ga_tpu_torch/obs: spans, the
metrics exposition, the engine's and the serve path's --obs records)
against the JAX package's.

  unit    the text expositions (to_prometheus, to_openmetrics) byte-equal
          to JAX's after the same registry operations; SpanTracer's
          records equal to JAX's apart from ts/dur (nesting, the
          disabled no-op, error marking, flows, measured spans)
  engine  one module baseline a package on JAX's obs-test config (pop 8,
          2 islands, 30 generations at migration period 10, -m 8,
          metrics every dispatch) on the 40-event instance of
          tests/test_usage.py, with --quality and a checkpoint every
          epoch: the port's --obs stream equals its run without --obs
          under strip_timing; its span names, each span's cat and
          attribute keys, its last metricsEntry's metric names (the
          cost observatory's compile.*/cost.* families included) and
          its qualityEntry keys are JAX's
  serve   the same on a request file of tests/test_usage.py's
          problems: the span taxonomy, each job's flow (one chain a job,
          the same spans in the same order as JAX's) and
          {"stats": "prometheus"}

Each package's runs report into a fresh registry of its own (the
process registries swapped for the run), so the metric names compared
are the run's alone.
"""

import contextlib
import io
import json
import math
import re

import pytest
import torch

from timetabling_ga_tpu.obs import metrics as jmetrics
from timetabling_ga_tpu.obs import spans as jspans
from timetabling_ga_tpu.obs import trace_export as jexport
from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.runtime.config import RunConfig as JRunConfig
from timetabling_ga_tpu.runtime.config import ServeConfig as JServeConfig
from timetabling_ga_tpu_torch.obs import metrics as tmetrics
from timetabling_ga_tpu_torch.obs import spans as tspans
from timetabling_ga_tpu_torch.obs import trace_export as texport
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl
from timetabling_ga_tpu_torch.runtime.config import RunConfig as TRunConfig
from timetabling_ga_tpu_torch.runtime.config import (
    ServeConfig as TServeConfig)

torch.set_num_threads(1)

# tests/test_usage.py's problems: _PB is the engine's 40-event instance
_PA = random_instance(71, n_events=12, n_rooms=3, n_features=2,
                      n_students=8, attend_prob=0.2)
_PB = random_instance(72, n_events=40, n_rooms=4, n_features=2,
                      n_students=30, attend_prob=0.1)

# tests/test_obs.py's engine config (its _engine_run), quality and a
# checkpoint every epoch on top
_ENGINE = dict(seed=3, pop_size=8, islands=2, generations=30,
               migration_period=10, max_steps=8, time_limit=300,
               backend="cpu", auto_tune=False, trace=True,
               metrics_every=1, quality=True, checkpoint_every=1)

_SERVE = dict(backend="cpu", lanes=2, quantum=5, pop_size=4, max_steps=8,
              metrics_every=1, quality=True)

@contextlib.contextmanager
def _fresh_registries():
    """Both packages' process registries swapped for fresh ones."""
    saved = jmetrics.REGISTRY, tmetrics.REGISTRY
    jmetrics.REGISTRY = jmetrics.MetricsRegistry()
    tmetrics.REGISTRY = tmetrics.MetricsRegistry()
    try:
        yield jmetrics.REGISTRY, tmetrics.REGISTRY
    finally:
        jmetrics.REGISTRY, tmetrics.REGISTRY = saved


def _lines(buf):
    return [json.loads(x) for x in buf.getvalue().splitlines()]


def _spans(recs):
    return [r["spanEntry"] for r in recs if "spanEntry" in r]


def _taxonomy(recs) -> dict:
    """span name -> {(cat, attribute keys)}."""
    out: dict = {}
    for s in _spans(recs):
        keys = tuple(sorted(set(s) - {"ts", "dur"}))
        out.setdefault(s["name"], set()).add((s["cat"], keys))
    return out


def _metric_names(snapshot) -> dict:
    return {kind: sorted(snapshot.get(kind, {}))
            for kind in ("counters", "gauges", "histograms")}


# ------------------------------------------------------------ the unit tier


def _drive_registry(reg):
    """The same operations on either package's registry."""
    reg.counter("engine.dispatches").inc()
    reg.counter("engine.gens").inc(30)
    reg.counter("serve.quantum_seconds").inc(0.125)
    reg.counter("odd-name/x").inc(2.5)
    reg.gauge("engine.gens_per_sec").set(1234.5678)
    reg.gauge("big").set(1e17)
    reg.gauge_fn("writer.queue_depth", lambda: 3)
    reg.gauge_fn("broken", lambda: 1 / 0)          # NaN
    h = reg.histogram("engine.dispatch_seconds")
    for i, v in enumerate((0.0004, 0.003, 0.07, 0.07, 2.0, 700.0)):
        h.observe(v, exemplar={"dispatch": str(i)})
    q = reg.histogram("serve.job_seconds", buckets=(0.5, 1.0))
    q.observe(0.7, exemplar={"job": 'a"b\\c\nd'})
    q.observe(0.2, exemplar={})
    reg.histogram("empty")


@pytest.mark.parametrize("render", ["to_prometheus", "to_openmetrics",
                                    "snapshot"])
def test_exposition_equals_jax(render):
    """After the same operations both registries render the same bytes:
    counters as `_total`, gauges plain (NaN for a failing pull source),
    histograms as bucket/sum/count (OpenMetrics: exemplars with escaped
    labels and the `# EOF` trailer)."""
    jreg, treg = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    _drive_registry(jreg)
    _drive_registry(treg)
    got, want = getattr(treg, render)(), getattr(jreg, render)()
    assert got == want
    if render == "to_openmetrics":
        assert got.endswith("# EOF\n") and '\\"b\\\\c\\nd' in got
    if render == "to_prometheus":
        assert "tt_odd_name_x_total 2.5" in got
        assert "tt_broken NaN" in got


def test_prom_helpers_equal_jax():
    for v in (0, 1, -3, 2.5, 1e15, 1e16, float("nan"), 1 / 3):
        assert tmetrics._prom_num(v) == jmetrics._prom_num(v)
    for n in ("a.b-c", "x y/z", "ok_name:1"):
        assert tmetrics._prom_name(n) == jmetrics._prom_name(n)
    assert tmetrics._escape_label('q"\\\n') == jmetrics._escape_label(
        'q"\\\n')
    g = tmetrics.Gauge("g", None, fn=lambda: 7)
    assert g.value == 7.0


def _drive_tracer(mod, flow_base=0):
    """Nesting, a measured span, an error span, flows and a thread: the
    same calls on either package's tracer; returns its records."""
    import threading
    buf = io.StringIO()
    tr = mod.SpanTracer(buf, flow_base=flow_base)
    f1, f2 = tr.new_flow(), tr.new_flow()
    with tr.span("outer", cat="engine", gens=3, flow=f1):
        with tr.span("inner", cat="device", flow=[f1, f2]):
            pass
        tr.record("dispatch", tr._epoch + 0.5, 0.25, cat="device",
                  epochs=1, flow=f2)
    with pytest.raises(ValueError):
        with tr.span("boom", job="j1"):
            raise ValueError("x")
    th = threading.Thread(target=lambda: tr.record(
        "fetch-read", tr._epoch, -1.0, flow=f1), name="tt-fetch-watchdog")
    th.start()
    th.join()
    disabled = mod.SpanTracer(buf, enabled=False)
    with disabled.span("never"):
        disabled.record("never", 0.0, 1.0)
    assert disabled.new_flow() == 0
    assert mod.SpanTracer(None).enabled is False
    assert mod.NULL_TRACER.enabled is False
    return _lines(buf), (f1, f2)


@pytest.mark.parametrize("flow_base", [0, jspans.XFLOW_BASE])
def test_span_tracer_equals_jax(flow_base):
    """The port's SpanTracer writes JAX's spanEntry records, equal apart
    from ts and dur: depth per thread, tid lanes, an error span marked
    and re-raised, flow ids from flow_base, the disabled tracer silent."""
    assert tspans.XFLOW_BASE == jspans.XFLOW_BASE
    got, gf = _drive_tracer(tspans, flow_base)
    want, wf = _drive_tracer(jspans, flow_base)
    assert gf == wf == (flow_base + 1, flow_base + 2)
    strip = [{k: v for k, v in r["spanEntry"].items()
              if k not in ("ts", "dur")} for r in got]
    assert strip == [{k: v for k, v in r["spanEntry"].items()
                      if k not in ("ts", "dur")} for r in want]
    by = {r["spanEntry"]["name"]: r["spanEntry"] for r in got}
    assert [r["spanEntry"]["name"] for r in got] == [
        "inner", "dispatch", "outer", "boom", "fetch-read"]
    assert by["inner"]["depth"] == 1 and by["dispatch"]["depth"] == 1
    assert by["boom"]["error"] is True
    assert by["dispatch"]["dur"] == 0.25
    assert by["fetch-read"]["tid"] == 1 and by["fetch-read"]["dur"] == 0.0


def test_span_quality_usage_entries_equal_jax():
    """The three emitters write JAX's lines."""
    from timetabling_ga_tpu.runtime import jsonl as jjsonl
    assert tjsonl.TIMING_RECORDS == jjsonl.TIMING_RECORDS
    got = io.StringIO()
    want = io.StringIO()
    for mod, out in ((tjsonl, got), (jjsonl, want)):
        mod.span_entry(out, "quantum", "device", 1.23456789, -2, 1, 3,
                       job=["a"], flow=[4])
        mod.quality_entry(out, {"quality.ops.x": 3}, ts=2.5, job="a",
                          gens=5)
        mod.quality_entry(out, {"hamming": 0.5})
        mod.usage_entry(out, {"dispatch": 1, "gens": 2}, ts=-1)
    assert got.getvalue() == want.getvalue()
    assert tjsonl.strip_timing(_lines(got)) == []


# ---------------------------------------------------------- the engine tier


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """The module's engine baseline: the port without and with --obs and
    JAX with --obs on one config, each in fresh registries. Returns
    {leg: (best, records, the run's registry)}."""
    from timetabling_ga_tpu.runtime import engine as jengine
    from timetabling_ga_tpu_torch.runtime import engine as tengine
    tmp = tmp_path_factory.mktemp("obs_engine")
    tim = tmp / "pb.tim"
    tim.write_text(dump_tim(_PB))
    runs = {}
    for leg, eng, cfg_cls, obs in (
            ("port", tengine, TRunConfig, False),
            ("port-obs", tengine, TRunConfig, True),
            ("jax-obs", jengine, JRunConfig, True)):
        buf = io.StringIO()
        cfg = cfg_cls(**dict(_ENGINE, input=str(tim), obs=obs,
                             checkpoint=str(tmp / f"{leg}.npz")))
        with _fresh_registries() as (jreg, treg):
            best = eng.run(cfg, out=buf)
            reg = jreg if leg.startswith("jax") else treg
            runs[leg] = (best, _lines(buf), reg)
    return runs


def test_engine_obs_stream_equals_obs_off(engine_runs):
    """--obs adds spanEntry, metricsEntry and qualityEntry records and
    changes nothing else: the streams are equal under strip_timing."""
    b0, l0, _ = engine_runs["port"]
    b1, l1, _ = engine_runs["port-obs"]
    assert b0 == b1
    assert tjsonl.strip_timing(l0) == tjsonl.strip_timing(l1)
    kinds = {next(iter(r)) for r in l1}
    assert {"spanEntry", "metricsEntry", "qualityEntry"} <= kinds


def test_engine_obs_off_emits_no_obs_records(engine_runs):
    _, l0, _ = engine_runs["port"]
    assert not any("spanEntry" in r or "metricsEntry" in r
                   or "qualityEntry" in r for r in l0)


def test_engine_span_taxonomy_equals_jax(engine_runs):
    """The same span names as JAX's engine, each with JAX's cat and
    attribute keys; every dispatch has its dispatch, fetch, fetch-read
    and process spans on one flow, and each checkpoint's ckpt-write
    (the writer thread) shares the checkpoint's flow."""
    _, lp, _ = engine_runs["port-obs"]
    _, lj, _ = engine_runs["jax-obs"]
    got, want = _taxonomy(lp), _taxonomy(lj)
    assert got == want
    assert {"init", "dispatch", "fetch", "fetch-read", "process",
            "checkpoint", "ckpt-write"} <= set(got)
    spans = _spans(lp)
    n_disp = sum(1 for s in spans if s["name"] == "dispatch")
    assert n_disp == 3
    for s in spans:
        if s["name"] == "dispatch":
            chain = {x["name"] for x in spans if x.get("flow") == s["flow"]}
            assert chain == {"dispatch", "fetch", "fetch-read", "process"}
        if s["name"] == "checkpoint":
            chain = [x["name"] for x in spans if x.get("flow") == s["flow"]]
            assert sorted(chain) == ["checkpoint", "ckpt-write"]
            assert next(x for x in spans if x["name"] == "ckpt-write"
                        and x["flow"] == s["flow"])["tid"] != s["tid"]


def test_engine_metric_names_equal_jax(engine_runs):
    """The last metricsEntry names JAX's counters, gauges and histograms
    (minus the cost families), and its counts are the run's: one
    metricsEntry a dispatch plus one at the end of the try."""
    _, lp, _ = engine_runs["port-obs"]
    _, lj, _ = engine_runs["jax-obs"]
    mp = [r["metricsEntry"] for r in lp if "metricsEntry" in r]
    mj = [r["metricsEntry"] for r in lj if "metricsEntry" in r]
    assert _metric_names(mp[-1]) == _metric_names(mj[-1])
    assert len(mp) == len(mj) == 3 + 1
    c = mp[-1]["counters"]
    assert c["engine.dispatches"] == 3 and c["engine.gens"] == 30
    assert mp[-1]["histograms"]["engine.dispatch_seconds"]["count"] == 3
    assert "engine.recovery_seconds" not in mp[-1]["gauges"]
    assert all("ts" in m for m in mp)


def test_engine_dispatch_exemplars(engine_runs):
    """engine.dispatch_seconds carries a {"dispatch": n} exemplar, as
    JAX's does: the OpenMetrics rendering of the run's registry shows
    one for each dispatch's bucket."""
    _, _, reg = engine_runs["port-obs"]
    _, _, jreg = engine_runs["jax-obs"]
    ex = re.findall(r'^tt_engine_dispatch_seconds_bucket\{[^}]*\} \d+ '
                    r'# \{dispatch="(\d+)"\}', reg.to_openmetrics(), re.M)
    jex = re.findall(r'^tt_engine_dispatch_seconds_bucket\{[^}]*\} \d+ '
                     r'# \{dispatch="(\d+)"\}', jreg.to_openmetrics(),
                     re.M)
    assert ex and jex
    assert set(ex) <= {"1", "2", "3"}
    assert reg.snapshot()["histograms"]["engine.dispatch_seconds"][
        "count"] == 3


def test_engine_quality_entry_keys_equal_jax(engine_runs):
    _, lp, _ = engine_runs["port-obs"]
    _, lj, _ = engine_runs["jax-obs"]
    qp = [r["qualityEntry"] for r in lp if "qualityEntry" in r]
    qj = [r["qualityEntry"] for r in lj if "qualityEntry" in r]
    assert len(qp) == len(qj) == 3
    assert {tuple(sorted(q)) for q in qp} == {tuple(sorted(q)) for q in qj}
    # `dispatch` is the count of dispatches enqueued when the entry is
    # written (JAX's numbering): with a chunk in flight, one ahead
    nums = [q["dispatch"] for q in qp]
    assert nums == sorted(nums) and nums[-1] == 3


# ----------------------------------------------------------- the serve tier


def _requests(tmp):
    pa, pb = tmp / "pa.tim", tmp / "pb.tim"
    pa.write_text(dump_tim(_PA))
    pb.write_text(dump_tim(_PB))
    return [{"submit": {"id": "a", "instance": str(pa), "seed": 3,
                        "generations": 10, "tenant": "acme"}},
            {"submit": {"id": "b", "instance": str(pa), "seed": 4,
                        "generations": 5, "tenant": "zeta"}},
            {"submit": {"id": "c", "instance": str(pb), "seed": 5,
                        "generations": 10}},
            {"drain": True},
            {"stats": True},
            {"stats": "prometheus"}]


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """The port's serve path without and with --obs and JAX's with
    --obs on one request file, each in fresh registries."""
    from timetabling_ga_tpu.serve.service import serve_stream as jserve
    from timetabling_ga_tpu_torch.serve.service import (
        serve_stream as tserve)
    tmp = tmp_path_factory.mktemp("obs_serve")
    text = "\n".join(json.dumps(r) for r in _requests(tmp)) + "\n"
    runs = {}
    for leg, serve, cfg in (
            ("port", tserve, TServeConfig(**_SERVE)),
            ("port-obs", tserve, TServeConfig(**_SERVE, obs=True)),
            ("jax-obs", jserve, JServeConfig(**_SERVE, obs=True,
                                             mesh_devices=1))):
        out = io.StringIO()
        with _fresh_registries():
            svc = serve(cfg, io.StringIO(text), out)
        runs[leg] = (svc, _lines(out))
    return runs


def test_serve_obs_stream_equals_obs_off(serve_runs):
    _, l0 = serve_runs["port"]
    _, l1 = serve_runs["port-obs"]
    assert tjsonl.strip_timing(l0) == tjsonl.strip_timing(l1)
    assert not any("spanEntry" in r or "qualityEntry" in r
                   or "usageEntry" in r for r in l0)


def test_serve_span_taxonomy_equals_jax(serve_runs):
    """admit, pack, init, resume, quantum, park, finalize (and any
    flush): JAX's names, cats and attribute keys."""
    got = _taxonomy(serve_runs["port-obs"][1])
    want = _taxonomy(serve_runs["jax-obs"][1])
    assert got == want
    assert {"admit", "pack", "init", "resume", "quantum", "park",
            "finalize"} <= set(got)


@pytest.mark.parametrize("job", ["a", "b", "c"])
def test_serve_job_flow_equals_jax(serve_runs, job):
    """`trace --job` renders one chain a job: a single flow id from s to
    f, through the same spans in the same order as JAX's."""
    recs_p = serve_runs["port-obs"][1]
    recs_j = serve_runs["jax-obs"][1]
    doc = texport.export_chrome_trace(recs_p, job=job)
    flows = sorted((e for e in doc["traceEvents"]
                    if e["ph"] in ("s", "t", "f")), key=lambda e: e["ts"])
    assert len({e["id"] for e in flows}) == 1
    assert flows[0]["ph"] == "s" and flows[-1]["ph"] == "f"
    assert all(e["ph"] == "t" for e in flows[1:-1])

    def names(recs):
        return [s["name"] for s in _spans(recs)
                if jexport._span_matches_job(s, job)]
    assert names(recs_p) == names(recs_j)
    jdoc = jexport.export_chrome_trace(recs_j, job=job)
    assert len([e for e in jdoc["traceEvents"]
                if e["ph"] in ("s", "t", "f")]) == len(flows)


def test_serve_quality_entry_keys_equal_jax(serve_runs):
    def keys(recs):
        return {tuple(sorted(r["qualityEntry"])) for r in recs
                if "qualityEntry" in r}
    got, want = keys(serve_runs["port-obs"][1]), keys(
        serve_runs["jax-obs"][1])
    assert got == want and len(got) == 1


_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? (NaN|[-+0-9.e]+)$')


def test_serve_stats_prometheus(serve_runs):
    """{"stats": "prometheus"} answers a metricsEntry carrying the text
    exposition (every line a TYPE comment or a sample), the plain
    {"stats": true} one without it, both with JAX's serve metric
    names; the service's prometheus() is the same rendering."""
    svc, recs = serve_runs["port-obs"]
    snaps = [r["metricsEntry"] for r in recs if "metricsEntry" in r]
    plain, prom = snaps[-2], snaps[-1]
    assert "prometheus" not in plain
    text = prom["prometheus"]
    for line in text.splitlines():
        assert line.startswith("# TYPE ") or _PROM_LINE.match(line), line
    assert "tt_serve_dispatches_total" in text
    assert "tt_serve_job_seconds_bucket" in text
    assert prom["counters"]["serve.jobs_done"] == 3
    # after close the ledger has settled every quantum: the registries
    # name the same metrics, the tenants' counters among them (the
    # ledger bumps a tenant counter only for a non-zero share: the
    # port's compile_seconds are 0 once the kernels are built, where JAX
    # bills its compiles; both bill their counted flops)
    jsvc = serve_runs["jax-obs"][0]
    zero = re.compile(r"^usage\.tenant\..*\.compile_seconds$")

    def names(snap):
        out = _metric_names(snap)
        out["counters"] = [n for n in out["counters"] if not zero.match(n)]
        return out
    assert names(svc.stats()) == names(jsvc.stats())
    assert not any(zero.match(n) for n in svc.stats()["counters"])
    assert "usage.tenant.acme.flops" in svc.stats()["counters"]
    assert "tt_usage_tenant_acme_gens_total 10" in svc.prometheus()
    assert math.isclose(float(re.search(
        r"^tt_serve_gens_total (\S+)$", text, re.M).group(1)),
        prom["counters"]["serve.gens"])
    assert svc.prometheus().startswith("# TYPE ")
