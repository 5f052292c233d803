"""The port's cost observatory (timetabling_ga_tpu_torch/obs/cost.py and
the work table, timetabling_ga_tpu_torch/work.py) against the JAX
package's (timetabling_ga_tpu/obs/cost.py; tests/test_cost.py's cases).

  unit     `_sig` tells shapes, dtypes and scalars apart; CostProgram
           counts one compile a signature and hits after, its costEntry
           under a bound emitter (JAX's field set) and none unbound; its
           cost is the work the call counted; the roofline helpers on
           the H100's peaks and compile_hit_rate; the ProfileCapture
           lifecycle, its count of only the dispatches enqueued after
           its start, and its hang/die faults never stalling; /profile
           and the `profile` client against a stub capture
  work     every entry point and form has a count; a CPU wrapper tallies
           what its kernel branch would launch, LAUNCHES untouched
  engine   the record stream under strip_timing is the same with the
           observatory off (TT_COST_OBS's leg), on and warm, and with
           --profile-for (--trace-profile's leg is in test_torch_prof.py);
           --profile-for N brackets N dispatches, and a real
           worker-started capture attributes the dispatch thread's work
  serve    the stream is the same with the observatory off and on and
           with a capture; the profile and mem-poll faults never stall
           it; every dispatch usageEntry's flops is the sum of its
           quantum's counted launches, and its lanes sum to it
"""

import io
import json
import threading
import time

import pytest
import torch

from timetabling_ga_tpu.obs import cost as jcost
from timetabling_ga_tpu.obs.metrics import MetricsRegistry as JRegistry
from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu_torch import kernels, work
from timetabling_ga_tpu_torch.obs import cost as tcost
from timetabling_ga_tpu_torch.obs import http as thttp
from timetabling_ga_tpu_torch.obs import metrics as tmetrics
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime import dispatch_core as tdcore
from timetabling_ga_tpu_torch.runtime import faults, jsonl
from timetabling_ga_tpu_torch.runtime.config import RunConfig, ServeConfig

torch.set_num_threads(1)

# tests/test_usage.py's problems: _PB is the engine's 40-event instance
_PA = random_instance(71, n_events=12, n_rooms=3, n_features=2,
                      n_students=8, attend_prob=0.2)
_PB = random_instance(72, n_events=40, n_rooms=4, n_features=2,
                      n_students=30, attend_prob=0.1)


def _wait(cond, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _pa(problem, dev="cpu"):
    return load_tim(dump_tim(problem)).device_arrays(dev)


# -------------------------------------------------------------------- unit


def test_sig_distinguishes_shapes_dtypes_and_scalars():
    a = torch.zeros((4, 3), dtype=torch.int32)
    b = torch.zeros((4, 4), dtype=torch.int32)
    c = torch.zeros((4, 3), dtype=torch.float32)
    assert tcost._sig((a, 1)) == tcost._sig((a, 2))
    assert tcost._sig((a,)) != tcost._sig((b,))
    assert tcost._sig((a,)) != tcost._sig((c,))
    assert tcost._sig((a, 1)) != tcost._sig((a, 1.0))
    assert tcost._sig(((a, a),)) != tcost._sig(((a, b),))
    assert tcost._sig(({"x": a},)) != tcost._sig(({"x": b},))
    # dataclass problems key by their tensors: two shapes never collide
    assert tcost._sig((_pa(_PA),)) != tcost._sig((_pa(_PB),))
    tag = tcost.sig_tag(tcost._sig((a, 1)))
    assert tag == tcost.sig_tag(tcost._sig((a, 2)))
    assert len(tag) == 10


class _Counters:
    """A stand-in for the kernels' totals: (ops, bytes, build seconds)."""

    def __init__(self):
        self.ops = self.bytes = 0
        self.build = 0.0

    def __call__(self):
        return self.ops, self.bytes, self.build


def test_cost_program_accounting_and_cost_entry_emission():
    reg = MetricsRegistry()
    obs = tcost.Observatory(registry=reg)
    buf = io.StringIO()
    obs.bind(buf, now=lambda: 1.5)
    cnt = _Counters()

    def toy(x):
        cnt.ops += 3 * x.numel()
        cnt.bytes += 8 * x.numel()
        cnt.build += 0.25
        return x * 2 + 1

    prog = tcost.CostProgram(toy, "toy", observatory=obs, counters=cnt)
    x = torch.arange(8, dtype=torch.int32)
    assert prog(x)[:3].tolist() == [1, 3, 5]
    assert prog.last_compiled and prog.last_compile_s == 0.25
    assert prog.last_cost == {"flops": 24.0, "bytes_accessed": 64.0,
                              "arg_bytes": 32.0, "out_bytes": 32.0,
                              "intensity": 24.0 / 64.0}
    assert reg.counter("compile.count").value == 1
    assert reg.counter("compile.count.toy").value == 1
    assert reg.counter("compile.cache_hits").value == 0
    assert reg.histogram("compile.seconds").count == 1
    g = reg.snapshot()["gauges"]
    assert g["cost.flops.toy"] == 24.0 and g["cost.bytes.toy"] == 64.0
    prog(x)                                    # warm: a cache hit
    assert not prog.last_compiled and prog.last_compile_s == 0.0
    assert reg.counter("compile.count").value == 1
    assert reg.counter("compile.cache_hits").value == 1
    prog(torch.arange(16, dtype=torch.int32))  # new shape: a compile
    assert reg.counter("compile.count").value == 2
    assert prog.last_cost["flops"] == 48.0
    recs = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert len(recs) == 2 and all("costEntry" in r for r in recs)
    ce = recs[0]["costEntry"]
    assert ce["program"] == "toy" and ce["ts"] == 1.5
    assert ce["lowerSeconds"] == 0.0 and ce["compileSeconds"] == 0.25
    assert jsonl.strip_timing(recs) == []
    obs.unbind()
    prog(torch.arange(32, dtype=torch.int32))
    assert reg.counter("compile.count").value == 3
    assert len(buf.getvalue().splitlines()) == 2
    # a call that counts nothing has no cost
    quiet = tcost.CostProgram(lambda v: v + 1, "plain", observatory=obs,
                              counters=_Counters())
    assert quiet(41) == 42 and quiet.last_cost is None


def test_cost_entry_fields_equal_jax():
    """A jitted JAX program's costEntry and a port program's carry the
    same fields (XLA's temp/code buffer sizes, which the port has no
    counterpart of, where JAX's CPU compile reports them)."""
    import jax
    import numpy as np
    bufs = []
    for mod, prog_of, x in (
            (jcost, lambda o: jcost.CostProgram(
                jax.jit(lambda v: v * 2 + 1), "toy", observatory=o),
             np.arange(8, dtype=np.int32)),
            (tcost, lambda o: tcost.CostProgram(
                _tallying_toy, "toy", observatory=o),
             torch.arange(8, dtype=torch.int32))):
        obs = mod.Observatory(registry=(
            MetricsRegistry() if mod is tcost else JRegistry()))
        buf = io.StringIO()
        obs.bind(buf, now=lambda: 2.0)
        prog_of(obs)(x)
        bufs.append(json.loads(buf.getvalue())["costEntry"])
    j, t = bufs
    no_counterpart = {"temp_bytes", "code_bytes"}
    assert list(t) == [k for k in j if k not in no_counterpart]


def _tallying_toy(x):
    kernels.tally(work.Work(3 * x.numel(), 8 * x.numel()))
    return x * 2 + 1


def test_kernel_counters_drive_the_default_program():
    """The default counters are the kernels' totals: a CPU wrapper
    tallies the work its kernel branch would launch, without a launch."""
    pa = _pa(_PB)
    slots = torch.randint(0, pa.n_slots, (6, pa.n_events),
                          dtype=torch.int32,
                          generator=torch.Generator().manual_seed(1))
    from timetabling_ga_tpu_torch.ops import fitness, rooms
    launches = dict(kernels.LAUNCHES)
    prog = tcost.CostProgram(
        lambda s: fitness.batch_penalty(pa, s, rooms.assign_rooms(pa, s)),
        "eval", observatory=tcost.Observatory(MetricsRegistry()))
    prog(slots)
    want = [work.assign_rooms(pa, slots), work.batch_penalty(pa, slots)]
    assert prog.last_cost["flops"] == sum(w.ops for w in want) > 0
    assert prog.last_cost["bytes_accessed"] == sum(w.bytes for w in want)
    assert kernels.LAUNCHES == launches


def test_work_table_covers_every_entry_point():
    assert set(work.TABLE) == set(kernels.SIGNATURES) | set(kernels.FORMS)
    pa = _pa(_PB)
    assert work.penalty_ops(pa) > 0 and work.k4_candidate_ops(pa) > 0
    assert work.quality_ops(2, 4) == (2 * 4 * 11 + 2 * 7 * 10,
                                      2 * 4 * 26 + 2 * 2 * 7 * 4)


def test_roofline_helpers_on_h100_peaks_and_hit_rate():
    assert tcost.H100_HBM_BYTES_S == 3.35e12
    assert tcost.H100_INT32_OPS_S == 67e12 / 4
    assert tcost.HBM_PEAK_GBPS == 3350.0
    out = tcost.roofline(27.6e6, 0.865e6, 400_000)
    assert out["arithmetic_intensity_flops_per_byte"] == pytest.approx(
        31.9, rel=0.01)
    assert out["int32_peak_tops"] == tcost.INT32_PEAK_TOPS == 16.75
    assert out["hbm_peak_gbps"] == tcost.HBM_PEAK_GBPS
    assert out["achieved_tflops"] == pytest.approx(11.0, abs=0.05)
    assert out["flop_utilization_vs_int32_peak_pct"] == pytest.approx(
        100 * 11.04 / 16.75, abs=0.1)
    assert out["min_fused_fraction_pct"] == 0.0
    reg = MetricsRegistry()
    tcost.set_live_roofline({"flops": 16.75e12, "bytes_accessed": 3.35e9},
                            2.0, registry=reg)
    g = reg.snapshot()["gauges"]
    assert g["cost.achieved_tflops"] == pytest.approx(8.375)
    assert g["cost.flop_utilization_pct"] == pytest.approx(50.0)
    assert g["cost.logical_gbps"] == pytest.approx(1.675)
    tcost.set_live_roofline(None, 1.0, registry=reg)     # no-ops
    tcost.set_live_roofline({"flops": 1.0}, 0.0, registry=reg)
    assert tcost.compile_hit_rate(MetricsRegistry()) == 0.0
    reg.counter("compile.count").inc(2)
    reg.counter("compile.cache_hits").inc(6)
    assert tcost.compile_hit_rate(reg) == pytest.approx(0.75)


def test_profile_capture_lifecycle():
    calls = []
    cap = tcost.ProfileCapture(lambda d: calls.append(("start", d)),
                               lambda: calls.append(("stop",)),
                               default_dir="outdir",
                               registry=MetricsRegistry())
    try:
        ack = cap.trigger(2)
        assert ack == {"ok": True, "dispatches": 2, "dir": "outdir"}
        assert _wait(lambda: ("start", "outdir") in calls)
        busy = cap.trigger(1)
        assert not busy["ok"] and "active" in busy["reason"]
        cap.on_dispatch()
        assert ("stop",) not in calls
        cap.on_dispatch()
        assert _wait(lambda: ("stop",) in calls)
        assert _wait(lambda: not cap.active())
        assert cap.trigger(1)["ok"]
        assert _wait(lambda: calls.count(("start", "outdir")) == 2)
        cap.on_dispatch()
        assert _wait(lambda: calls.count(("stop",)) == 2)
        assert _wait(lambda: cap.last()["completed"] == 2)
    finally:
        cap.close()
    assert cap.trigger(1) == {"ok": False, "reason": "capture closed"}


def test_profile_capture_counts_only_dispatches_enqueued_after_start():
    calls = []
    cap = tcost.ProfileCapture(lambda d: calls.append("start"),
                               lambda: calls.append("stop"),
                               registry=MetricsRegistry())
    try:
        early = cap.on_enqueue()        # on the card before the start
        assert cap.trigger(1)["ok"]
        assert _wait(lambda: cap._remaining > 0)
        late = cap.on_enqueue()
        assert late == early + 1
        cap.on_dispatch(early)          # only partly in the capture
        time.sleep(0.05)
        assert "stop" not in calls
        cap.on_dispatch(late)
        assert _wait(lambda: "stop" in calls)
        assert _wait(lambda: cap.last()["completed"] == 1)
        # a loop with no more dispatches ends a capture still waiting
        assert cap.trigger(2)["ok"]
        assert _wait(lambda: cap._remaining > 0)
        cap.on_dispatch(early)
        cap.flush()
        assert _wait(lambda: calls.count("stop") == 2)
        assert _wait(lambda: cap.last()["completed"] == 2)
        cap.flush()                     # nothing live: a no-op
        assert calls.count("stop") == 2
    finally:
        cap.close()


@pytest.mark.parametrize("action", ["hang", "die"])
def test_profile_capture_hang_and_die_never_stall(monkeypatch, action):
    monkeypatch.setattr(faults, "HANG_S", 30.0)
    calls = []
    faults.install(f"profile:1:{action}")
    try:
        cap = tcost.ProfileCapture(lambda d: calls.append("start"),
                                   lambda: calls.append("stop"),
                                   registry=MetricsRegistry())
        assert cap.trigger(1)["ok"]
        time.sleep(0.05)
        t0 = time.monotonic()
        for _ in range(100):
            cap.on_dispatch()
        assert time.monotonic() - t0 < 0.5
        assert "start" not in calls
        t0 = time.monotonic()
        cap.close()
        assert time.monotonic() - t0 < 3.0
    finally:
        faults.install(None)


def test_profile_endpoint_and_cli_client(capsys):
    calls = []
    cap = tcost.ProfileCapture(lambda d: calls.append(d), lambda: None,
                               registry=MetricsRegistry())
    cap.on_complete = lambda d: {"capture_dir": d, "n_events": 0,
                                 "total_s": 0.0, "phases": {},
                                 "unattributed_s": 0.0,
                                 "unattributed_frac": 0.0,
                                 "unattributed_top_ops": []}
    srv = thttp.ObsServer("127.0.0.1:0", registry=MetricsRegistry(),
                          profile=cap).start()
    try:
        assert tcost.main_profile([srv.url, "--for", "3"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out == {"ok": True, "dispatches": 3,
                       "dir": cap.default_dir}
        assert _wait(lambda: calls == [cap.default_dir])
        assert tcost.main_profile([srv.url]) == 1          # busy: 409
        assert "active" in json.loads(capsys.readouterr().out)["reason"]
        for _ in range(3):
            cap.on_dispatch()
        assert _wait(lambda: not cap.active())
        # --attribute: the next capture's attribution, rendered. The
        # dispatch comes once the worker has started the capture and
        # counts dispatches (active() is already true at the trigger: a
        # dispatch before the worker's start would not count, and on a
        # loaded host the capture then never landed)
        th = threading.Thread(target=lambda: [
            _wait(lambda: cap._remaining > 0, timeout=30.0),
            cap.on_dispatch()])
        th.start()
        assert tcost.main_profile([srv.url.replace("http://", ""),
                                   "--attribute", "--timeout", "10"]) == 0
        th.join()
        out = capsys.readouterr().out
        assert "== phases (tt-profile: 0 device ops" in out
        import urllib.request
        with urllib.request.urlopen(srv.url + "/profile?last=1") as r:
            assert json.loads(r.read())["completed"] == 2
    finally:
        srv.close()
        cap.close()
    srv2 = thttp.ObsServer("127.0.0.1:0",
                           registry=MetricsRegistry()).start()
    try:
        assert tcost.main_profile([srv2.url]) == 1
        assert "no profile capture" in json.loads(
            capsys.readouterr().out)["reason"]
    finally:
        srv2.close()


def test_profile_client_help_equals_jax(capsys):
    assert tcost.main_profile(["--help"]) == 0
    got = capsys.readouterr().out
    assert jcost.main_profile(["--help"]) == 0
    assert got == capsys.readouterr().out
    with pytest.raises(SystemExit):
        tcost.main_profile([])
    with pytest.raises(SystemExit):
        tcost.main_profile(["http://x", "--for"])


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def tim(tmp_path_factory):
    path = tmp_path_factory.mktemp("cost") / "pb.tim"
    path.write_text(dump_tim(_PB))
    return str(path)


def _engine_run(tim, **kw):
    from timetabling_ga_tpu_torch.runtime import engine
    buf = io.StringIO()
    base = dict(input=tim, seed=3, pop_size=8, islands=2, generations=30,
                migration_period=10, max_steps=8, time_limit=300,
                backend="cpu", auto_tune=False, trace=True,
                metrics_every=1)
    base.update(kw)
    best = engine.run(RunConfig(**base), out=buf)
    return best, [json.loads(x) for x in buf.getvalue().splitlines()]


def _compile_counters(reg):
    c = reg.snapshot().get("counters", {})
    return {k: v for k, v in c.items() if k.startswith("compile.")}


def test_engine_stream_identity_and_accounting(tim, monkeypatch,
                                               tmp_path):
    """Observatory off (TT_COST_OBS's leg), on (--obs, the programs
    fresh), warm, with --profile-for and with --trace-profile: the same
    records under strip_timing. The on leg counts one compile a program
    signature and writes costEntry records; the warm leg counts none,
    only hits, and moves the roofline gauges; --profile-for 2 brackets
    two dispatches."""
    from timetabling_ga_tpu_torch.runtime import engine
    monkeypatch.setattr(engine, "DISPATCH_CAP_S", 1e9)
    reg = tcost.OBSERVATORY.registry
    monkeypatch.setattr(tcost, "ENABLED", False)
    monkeypatch.setattr(tdcore, "PROGRAMS", {})
    b_off, l_off = _engine_run(tim)
    assert not any("costEntry" in r for r in l_off)
    assert all(not isinstance(p, tcost.CostProgram)
               for p in tdcore.PROGRAMS.values())
    monkeypatch.setattr(tcost, "ENABLED", True)
    monkeypatch.setattr(tdcore, "PROGRAMS", {})
    before = _compile_counters(reg)
    b_on, l_on = _engine_run(tim, obs=True)
    after = _compile_counters(reg)
    assert b_on == b_off
    assert jsonl.strip_timing(l_on) == jsonl.strip_timing(l_off)
    ce = [r["costEntry"] for r in l_on if "costEntry" in r]
    assert {c["program"] for c in ce} == {"init", "dyn_runner", "runner"}
    assert all(c["flops"] > 0 and c["compileSeconds"] == 0.0 for c in ce)
    assert after["compile.count.runner"] - before.get(
        "compile.count.runner", 0) == 1
    assert after["compile.count"] - before.get("compile.count", 0) == 3
    gauges = tmetrics.REGISTRY.snapshot()["gauges"]
    assert gauges["cost.achieved_tflops"] > 0
    assert gauges["cost.flop_utilization_pct"] > 0
    b2, l2 = _engine_run(tim)
    final = _compile_counters(reg)
    assert b2 == b_off
    assert jsonl.strip_timing(l2) == jsonl.strip_timing(l_off)
    assert final["compile.count"] == after["compile.count"]
    assert final["compile.cache_hits"] > after["compile.cache_hits"]
    # --profile-for 2 with a stub profiler: two dispatches bracketed
    calls = []

    class Stub:
        def __init__(self, device, all_threads=False):
            assert all_threads

        def start(self, d):
            calls.append(("start", d))

        def stop(self):
            calls.append(("stop",))

    monkeypatch.setattr(engine.obs_prof, "TorchProfiler", Stub)
    n0 = tmetrics.REGISTRY.counter("profile.captures").value
    b3, l3 = _engine_run(tim, profile_for=2,
                         profile_dir=str(tmp_path / "p"))
    assert b3 == b_off
    assert jsonl.strip_timing(l3) == jsonl.strip_timing(l_off)
    assert _wait(lambda: ("stop",) in calls)
    assert calls == [("start", str(tmp_path / "p")), ("stop",)]
    assert tmetrics.REGISTRY.counter("profile.captures").value == n0 + 1


def test_engine_profile_capture_attributes_into_the_log(tim, tmp_path):
    """A real worker-started capture (--profile-for 1 under --obs): it
    records every thread, so its attribution finds the dispatch
    thread's phases, publishes prof.* gauges and writes a profEntry;
    the stream is that of the run without it."""
    from timetabling_ga_tpu_torch.obs import prof
    _, l0 = _engine_run(tim, generations=60)
    _, l1 = _engine_run(tim, generations=60, obs=True, profile_for=1,
                        profile_dir=str(tmp_path / "p"))
    assert jsonl.strip_timing(l1) == jsonl.strip_timing(l0)
    entries = [r["profEntry"] for r in l1 if "profEntry" in r]
    if not entries:
        # the run may end before the worker's attribution lands (JAX's
        # capture has the same race); the capture itself is on disk
        attr = prof.attribute(str(tmp_path / "p"))
    else:
        assert entries[0]["dir"] == str(tmp_path / "p")
        attr = prof._entry_to_attr(entries[0])
    assert attr["total_s"] > 0
    assert "delta" in attr["phases"]


# ------------------------------------------------------------------- serve


def _serve_run(**kw):
    from timetabling_ga_tpu_torch.serve.service import SolveService
    buf = io.StringIO()
    cfg = ServeConfig(backend="cpu", lanes=2, quantum=5, pop_size=4,
                      max_steps=8, generations=15, metrics_every=1,
                      **kw)
    svc = SolveService(cfg, out=buf)
    for i, p in enumerate((_PA, _PB, _PA)):
        svc.submit(load_tim(dump_tim(p)), job_id=f"j{i}", seed=i)
    svc.drive()
    svc.close()
    return [json.loads(x) for x in buf.getvalue().splitlines()]


def test_serve_stream_identity_and_flops(monkeypatch):
    """Observatory off and on (--obs) give the same records under
    strip_timing; each dispatch usageEntry's flops is the sum of the
    work its quantum's launches counted (the CPU wrappers tally it as
    the kernels would), its lanes sum to it, and the lane programs count
    one compile a bucket."""
    from timetabling_ga_tpu_torch.parallel import islands
    monkeypatch.setattr(tcost, "ENABLED", False)
    monkeypatch.setattr(tdcore, "PROGRAMS", {})
    l_off = _serve_run()
    monkeypatch.setattr(tcost, "ENABLED", True)
    monkeypatch.setattr(tdcore, "PROGRAMS", {})
    counted = []
    lane_run = islands.lane_run

    def spy(*a, **k):
        o0 = kernels.WORK["ops"]
        out = lane_run(*a, **k)
        counted.append(kernels.WORK["ops"] - o0)
        return out

    monkeypatch.setattr(islands, "lane_run", spy)
    before = _compile_counters(tcost.OBSERVATORY.registry)
    l_on = _serve_run(obs=True)
    after = _compile_counters(tcost.OBSERVATORY.registry)
    assert jsonl.strip_timing(l_on) == jsonl.strip_timing(l_off)
    assert any("costEntry" in r for r in l_on)
    assert after["compile.count.lane_runner"] - before.get(
        "compile.count.lane_runner", 0) == 2        # two buckets
    usage = sorted((r["usageEntry"] for r in l_on if "usageEntry" in r
                    and "dispatch" in r["usageEntry"]),
                   key=lambda u: u["dispatch"])
    assert len(usage) == len(counted) > 0
    for u, c in zip(usage, counted):
        assert c > 0 and u["flops"] == float(c)
        assert sum(x["flops"] for x in u["lanes"]) == u["flops"]
    assert sum(r["usageEntry"]["flops"] for r in l_on
               if "usageEntry" in r
               and r["usageEntry"].get("event") == "total") == sum(counted)


def test_serve_mem_poll_and_profile_faults_never_stall(monkeypatch):
    """A hung or dying poller and capture never stall dispatch, serve or
    writer drain: the stream completes, close() returns, and the records
    match a fault-free run under strip_timing."""
    monkeypatch.setattr(faults, "HANG_S", 30.0)
    l0 = _serve_run()
    for spec in ("mem_poll:1:hang,profile:1:hang",
                 "mem_poll:1:die,profile:1:die"):
        t0 = time.monotonic()
        l1 = _serve_run(obs=True, mem_poll_every=0.01, profile_for=1,
                        faults=spec)
        assert time.monotonic() - t0 < 25.0, spec
        assert jsonl.strip_timing(l1) == jsonl.strip_timing(l0), spec
        faults.install(None)
    assert faults.injected_total() >= 2


def test_serve_profile_for_stream_identity(tmp_path):
    """--profile-for on serve: a real capture of one quantum, the
    records those of the run without it."""
    l0 = _serve_run()
    l1 = _serve_run(profile_for=1, profile_dir=str(tmp_path / "sp"))
    assert jsonl.strip_timing(l1) == jsonl.strip_timing(l0)
    assert _wait(lambda: list((tmp_path / "sp").glob(
        "plugins/profile/*/*.pt.trace.json.gz")), timeout=10.0)
