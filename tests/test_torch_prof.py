"""The port's phase profiler (timetabling_ga_tpu_torch/obs/prof.py)
against the JAX package's (timetabling_ga_tpu/obs/prof.py).

  scopes   the registry is JAX's PHASES and rejects a name outside it;
           a scope does nothing outside a live capture and opens a
           `tt.*` range inside one (decorator and context manager);
           TT_PROF_SCOPES=0 gives the function itself
  map      the kernel map covers every entry point and form of
           kernels.py, with phases of the registry
  parser   `_self_times` equals JAX's; `attribute` on synthetic
           torch.profiler Chrome traces (gz and plain): a kernel under
           a gpu_user_annotation range, kernels by the map alone, a
           cpu_op under a user_annotation of its own thread, the token
           scan, the honest `unattributed` bucket, the newest run, a
           missing capture
  output   on the same attribution dicts, `publish` (gauges and the
           profEntry line), `render`, `diff`, `render_diff` and
           `main_hotspots` (capture dir, log, --diff, --json, missing
           input, help) give JAX's bytes
  capture  a real CPU capture: the port's engine with --trace-profile
           on a 40-event instance writes one `profile` phase record,
           and the capture attributes its CPU ops to the sweep, ga and
           fitness phases
"""

import gzip
import io
import json
import os

import pytest
import torch

from timetabling_ga_tpu.obs import prof as jprof
from timetabling_ga_tpu.obs.metrics import MetricsRegistry as JRegistry
from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.runtime import jsonl as jjsonl
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.obs import prof as tprof
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl

torch.set_num_threads(1)

# tests/test_usage.py's engine instance (40 events)
_PB = random_instance(72, n_events=40, n_rooms=4, n_features=2,
                      n_students=30, attend_prob=0.1)


# ------------------------------------------------------------------ scopes


def test_scope_registry_equals_jax_and_rejects_unknown_names():
    assert tprof.PHASES == jprof.PHASES
    for p in tprof.PHASES:
        assert tprof.short(p) == jprof.short(p) == p[3:]
    assert tprof.short("unattributed") == "unattributed"
    for bad in ("tt.breeding", "sweep"):
        with pytest.raises(ValueError, match=bad):
            tprof.scope(bad)


def test_scopes_inert_outside_a_capture_and_ranges_inside(tmp_path):
    """Outside a capture a scoped call is the function's own (no range
    can be recorded: none is open); inside one its ops land in the
    scope's phase, through the decorator and the context manager."""
    @tprof.scope("tt.sweep")
    def work(x):
        return (x * 3).sum()

    x = torch.arange(64, dtype=torch.float32)
    assert not tprof._LIVE[0]
    assert float(work(x)) == float((x * 3).sum())
    with tprof.scope("tt.rooms"):
        assert not tprof._LIVE[0]
    cap = tprof.TorchProfiler("cpu")
    cap.start(str(tmp_path))
    assert tprof._LIVE[0]
    work(x)
    with tprof.scope("tt.rooms"):
        torch.cumsum(x, 0)
    path = cap.stop()
    assert not tprof._LIVE[0]
    assert path.endswith(".pt.trace.json.gz") and os.path.isfile(path)
    attr = tprof.attribute(str(tmp_path))
    assert attr["phases"]["sweep"]["seconds"] > 0
    assert attr["phases"]["rooms"]["seconds"] > 0
    assert any("mul" in op for op, _ in
               attr["phases"]["sweep"]["top_ops"])
    assert any("cumsum" in op for op, _ in
               attr["phases"]["rooms"]["top_ops"])


def test_scopes_off_give_the_function_itself(monkeypatch):
    monkeypatch.setattr(tprof, "SCOPES_ENABLED", False)

    def f(x):
        return x + 1

    assert tprof.scope("tt.sweep")(f) is f
    with tprof.scope("tt.ga") as s:
        assert s is not None
    with pytest.raises(ValueError):
        tprof.scope("tt.nope")


# --------------------------------------------------------------------- map


def test_kernel_map_covers_every_entry_point():
    assert set(tprof.KERNEL_PHASES) == set(kernels.SIGNATURES) | set(
        kernels.FORMS)
    assert set(tprof.KERNEL_PHASES.values()) <= set(tprof.PHASES)
    # a form counts in its entry point's phase
    for form, entry in kernels.FORMS.items():
        assert tprof.KERNEL_PHASES[form] == tprof.KERNEL_PHASES[entry]
    for name, want in (("sweep_pass_kernel", "sweep_pass"),
                       ("void sweep_pass_kernel<8>(int const*, int)",
                        "sweep_pass"),
                       ("random_ls_kernel(int*)", "random_ls"),
                       ("random_ls_events_kernel(float const*)",
                        "random_ls_events"),
                       ("aten::mul", None), ("my_kernelish", None),
                       ("_kernel", None)):
        assert tprof.kernel_entry(name) == want, name


def test_write_scope_map_roundtrip(tmp_path):
    path = tprof.write_scope_map(str(tmp_path))
    assert os.path.basename(path) == tprof.SIDECAR
    with open(path) as f:
        assert json.load(f) == {"kernels": tprof.KERNEL_PHASES}


# ------------------------------------------------------------------ parser


def test_self_times_equals_jax():
    evs = [
        {"ts": 0.0, "dur": 100.0, "name": "outer"},
        {"ts": 10.0, "dur": 30.0, "name": "a"},
        {"ts": 50.0, "dur": 40.0, "name": "b"},
        {"ts": 55.0, "dur": 5.0, "name": "c"},
        {"ts": 200.0, "dur": 10.0, "name": "d"},
    ]
    got = [(e["name"], s) for e, s in tprof._self_times(evs)]
    want = [(e["name"], s) for e, s in jprof._self_times(evs)]
    assert got == want
    assert dict(got) == {"outer": 30.0, "a": 30.0, "b": 35.0, "c": 5.0,
                         "d": 10.0}


def _gpu_doc():
    """A synthetic CUDA capture, durations in us: K5 under a tt.sweep
    range on the GPU timeline (the range wins over the map: it says
    tt.sweep too, and a K2 inside it also lands in tt.sweep), K8's
    chain and a memcpy outside any range (K8 by the map; the memcpy
    unattributed), a kernel named with a tt.rooms token, an unknown
    kernel (unattributed), and host events that are not device work."""
    return {"traceEvents": [
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "ts": 0, "dur": 100, "name": "tt.sweep"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 0,
         "dur": 60, "name": "void sweep_pass_kernel<8>(int const*)"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 70,
         "dur": 20, "name": "batch_penalty_kernel(int const*)"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 200,
         "dur": 50, "name": "random_ls_kernel(int const*)"},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "ts": 300,
         "dur": 10, "name": "Memcpy DtoH (Device -> Pinned)"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 400,
         "dur": 30, "name": "gather/tt.rooms/k"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 500,
         "dur": 40, "name": "some_library_kernel"},
        # host work: ignored where the trace has device events
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": 0,
         "dur": 999, "name": "aten::copy_"},
        {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1, "ts": 0,
         "dur": 5, "name": "cudaLaunchKernel"},
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "GPU 0"}},
    ]}


def _cpu_doc():
    """A synthetic CPU capture: cpu_ops under a tt.fitness range of
    their own thread (a nested op's self time subtracted from its
    parent), one on another thread that the range does not enclose."""
    return {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1,
         "ts": 0, "dur": 100, "name": "tt.fitness"},
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": 5,
         "dur": 50, "name": "aten::bmm"},
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": 10,
         "dur": 20, "name": "aten::empty"},
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 2, "ts": 5,
         "dur": 30, "name": "aten::copy_"},
        {"ph": "X", "cat": "python_function", "pid": 1, "tid": 1,
         "ts": 0, "dur": 500, "name": "run"},
    ]}


def _write_capture(root, doc, gz=True, run="2026_01_01_00_00_00_000001"):
    d = os.path.join(root, "plugins", "profile", run)
    os.makedirs(d, exist_ok=True)
    text = json.dumps(doc)
    if gz:
        with gzip.open(os.path.join(d, "host.pt.trace.json.gz"), "wt",
                       encoding="utf-8") as f:
            f.write(text)
    else:
        with open(os.path.join(d, "host.pt.trace.json"), "w",
                  encoding="utf-8") as f:
            f.write(text)
    return root


@pytest.mark.parametrize("gz", [True, False])
def test_attribute_gpu_capture(tmp_path, gz):
    attr = tprof.attribute(_write_capture(str(tmp_path), _gpu_doc(), gz))
    assert attr["n_events"] == 6
    assert attr["total_s"] == pytest.approx(210e-6)
    ph = attr["phases"]
    assert ph["sweep"]["seconds"] == pytest.approx(80e-6)
    assert ph["sweep"]["top_ops"][0][0].startswith("void sweep_pass")
    assert ph["delta"]["seconds"] == pytest.approx(50e-6)
    assert ph["rooms"]["seconds"] == pytest.approx(30e-6)
    assert "fitness" not in ph
    assert attr["unattributed_s"] == pytest.approx(50e-6)
    assert [op for op, _ in attr["unattributed_top_ops"]] == [
        "some_library_kernel", "Memcpy DtoH (Device -> Pinned)"]
    assert list(ph) == ["sweep", "delta", "rooms"]    # ranked
    assert sum(d["frac"] for d in ph.values()) + attr[
        "unattributed_frac"] == pytest.approx(1.0, abs=1e-3)
    assert attr["trace_files"] == [
        "host.pt.trace.json.gz" if gz else "host.pt.trace.json"]


def test_attribute_by_the_kernel_map_alone(tmp_path):
    """Without ranges (a capture whose ranges did not reach it) every
    hand kernel is placed by the map: K5 and K2 now split."""
    doc = _gpu_doc()
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e.get("cat") != "gpu_user_annotation"]
    attr = tprof.attribute(_write_capture(str(tmp_path), doc))
    ph = attr["phases"]
    assert ph["sweep"]["seconds"] == pytest.approx(60e-6)
    assert ph["fitness"]["seconds"] == pytest.approx(20e-6)
    assert ph["delta"]["seconds"] == pytest.approx(50e-6)
    # a copied capture's sidecar is the map it was taken under
    root = str(tmp_path)
    with open(os.path.join(root, tprof.SIDECAR), "w") as f:
        json.dump({"kernels": {"sweep_pass": "tt.polish"}}, f)
    attr = tprof.attribute(root)
    assert attr["phases"]["polish"]["seconds"] == pytest.approx(60e-6)
    assert "fitness" not in attr["phases"]
    assert attr["unattributed_s"] == pytest.approx(120e-6)


def test_attribute_lahc_pre_pass_to_its_range(tmp_path):
    """K10 launches K8's pre-pass inside lahc_steps' tt.lahc range: both
    kernels go to the range's phase, though the map puts the pre-pass
    under tt.delta."""
    assert tprof.KERNEL_PHASES["random_ls_events"] == "tt.delta"
    doc = {"traceEvents": [
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "ts": 0, "dur": 100, "name": "tt.lahc"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 0,
         "dur": 10, "name": "random_ls_events_kernel(float const*)"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 12,
         "dur": 80, "name": "lahc_kernel(K10Args)"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 200,
         "dur": 5, "name": "random_ls_events_kernel(float const*)"}]}
    attr = tprof.attribute(_write_capture(str(tmp_path), doc))
    assert attr["phases"]["lahc"]["seconds"] == pytest.approx(90e-6)
    assert attr["phases"]["delta"]["seconds"] == pytest.approx(5e-6)


def test_attribute_cpu_capture_and_honest_bucket(tmp_path):
    attr = tprof.attribute(_write_capture(str(tmp_path), _cpu_doc()))
    assert attr["n_events"] == 3
    assert attr["phases"]["fitness"]["seconds"] == pytest.approx(50e-6)
    assert dict(attr["phases"]["fitness"]["top_ops"]) == pytest.approx(
        {"aten::bmm": 30e-6, "aten::empty": 20e-6})
    assert attr["unattributed_s"] == pytest.approx(30e-6)
    assert attr["unattributed_top_ops"][0][0] == "aten::copy_"


def test_attribute_newest_run_and_missing_capture(tmp_path):
    root = _write_capture(str(tmp_path), _gpu_doc(),
                          run="2026_01_01_00_00_00_000001")
    _write_capture(root, _cpu_doc(), run="2026_01_01_00_00_00_000000")
    assert tprof.attribute(root)["total_s"] == pytest.approx(210e-6)
    _write_capture(root, _cpu_doc(), run="2026_01_01_00_00_01_000000")
    assert tprof.attribute(root)["total_s"] == pytest.approx(80e-6)
    with pytest.raises(FileNotFoundError):
        tprof.attribute(str(tmp_path / "nope"))


# ------------------------------------------------------------------ output


def _attrs(tmp_path):
    a = tprof.attribute(_write_capture(str(tmp_path / "a"), _gpu_doc()))
    b = tprof.attribute(_write_capture(str(tmp_path / "b"), _cpu_doc()))
    return a, b


def test_publish_equals_jax(tmp_path):
    """The same gauges and the same profEntry line as JAX's publish; a
    capture hook's registry carries JAX's prof.* names."""
    a, _ = _attrs(tmp_path)
    treg, jreg = TRegistry(), JRegistry()
    tbuf, jbuf = io.StringIO(), io.StringIO()
    tprof.publish(a, registry=treg, out=tbuf, now=lambda: 12.5)
    jprof.publish(a, registry=jreg, out=jbuf, now=lambda: 12.5)
    assert tbuf.getvalue() == jbuf.getvalue()
    assert treg.snapshot() == jreg.snapshot()
    assert "prof.phase_seconds.sweep" in treg.snapshot()["gauges"]
    recs = [json.loads(x) for x in tbuf.getvalue().splitlines()]
    assert "profEntry" in tjsonl.TIMING_RECORDS
    assert tjsonl.strip_timing(recs) == []
    reg = TRegistry()
    tprof.publish(a, registry=reg)          # no emitter: gauges only
    assert reg.snapshot() == treg.snapshot()
    out = io.StringIO()
    hook = tprof.capture_hook(out=out, registry=TRegistry())
    got = hook(str(tmp_path / "a"))
    assert got == a
    assert os.path.isfile(str(tmp_path / "a" / tprof.SIDECAR))
    assert "profEntry" in out.getvalue()


def test_prof_entry_equals_jax():
    payload = {"dir": "d", "totalSeconds": 1.5,
               "phases": {"sweep": {"s": 1.0, "frac": 0.66,
                                    "top_ops": [["k", 1.0]]}},
               "unattributedSeconds": 0.5, "unattributedFrac": 0.33}
    tb, jb = io.StringIO(), io.StringIO()
    tjsonl.prof_entry(tb, payload, ts=-1, job="j")
    jjsonl.prof_entry(jb, payload, ts=-1, job="j")
    assert tb.getvalue() == jb.getvalue()


def test_render_diff_render_diff_equal_jax(tmp_path):
    a, b = _attrs(tmp_path)
    for attr in (a, b):
        for k in (1, 3, 5):
            assert tprof.render(attr, top_k=k) == jprof.render(attr,
                                                              top_k=k)
    assert tprof.diff(a, b) == jprof.diff(a, b)
    assert tprof.render_diff(tprof.diff(a, b)) == jprof.render_diff(
        jprof.diff(a, b))
    e = tprof._entry_to_attr({"dir": "x", "totalSeconds": 2.0,
                              "phases": {"ga": {"s": 1.0, "frac": 0.5}}})
    assert e == jprof._entry_to_attr({"dir": "x", "totalSeconds": 2.0,
                                      "phases": {"ga": {"s": 1.0,
                                                        "frac": 0.5}}})


def test_main_hotspots_equals_jax(tmp_path, capsys):
    """On a capture dir (JAX's renderer fed the port's attribution), on
    a log's profEntry records, --diff, --json and --top: JAX's bytes."""
    a, b = _attrs(tmp_path)
    root = str(tmp_path / "a")
    assert tprof.main_hotspots([root]) == 0
    assert capsys.readouterr().out == jprof.render(a) + "\n"
    assert tprof.main_hotspots([root, "--json", "--top", "1"]) == 0
    assert json.loads(capsys.readouterr().out) == a
    logs = []
    for name, attr in (("a", a), ("b", b)):
        log = tmp_path / f"{name}.jsonl"
        with open(log, "w") as f:
            jprof.publish(attr, registry=JRegistry(), out=f)
        logs.append(str(log))
    for argv in ([logs[0]], [logs[1], "--top", "1"],
                 ["--diff", logs[0], logs[1]],
                 ["--diff", logs[0], logs[1], "--json"]):
        assert tprof.main_hotspots(argv) == 0
        got = capsys.readouterr().out
        assert jprof.main_hotspots(argv) == 0
        assert got == capsys.readouterr().out, argv
    assert tprof.main_hotspots(["--diff", logs[0], root]) == 0
    assert "phase diff" in capsys.readouterr().out


def test_main_hotspots_missing_input_and_help(tmp_path, capsys):
    assert tprof.main_hotspots([str(tmp_path / "gone")]) == 1
    assert "tt hotspots:" in capsys.readouterr().err
    assert tprof.main_hotspots(["--help"]) == 0
    got = capsys.readouterr().out
    assert jprof.main_hotspots(["--help"]) == 0
    assert got == capsys.readouterr().out
    for argv in ([], ["--diff", "only-one"], ["--top"]):
        with pytest.raises(SystemExit):
            tprof.main_hotspots(argv)


# ----------------------------------------------------------------- capture


def test_trace_profile_capture_on_cpu(tmp_path):
    """The port's engine with --trace-profile on the 40-event instance
    (the sweep local search, so every phase of a generation runs): one
    `profile` phase record a try, the stream that of the run without
    it, and the capture attributes its CPU ops to sweep, ga and
    fitness."""
    from timetabling_ga_tpu_torch.runtime import engine
    from timetabling_ga_tpu_torch.runtime.config import RunConfig
    tim = tmp_path / "pb.tim"
    tim.write_text(dump_tim(_PB))
    base = dict(input=str(tim), seed=3, pop_size=4, islands=2,
                generations=4, migration_period=2, time_limit=300,
                backend="cpu", auto_tune=False, trace=True,
                ls_mode="sweep", ls_sweeps=1, init_sweeps=0)
    recs = {}
    for leg, extra in (("off", {}),
                       ("on", {"trace_profile": str(tmp_path / "tp")})):
        buf = io.StringIO()
        engine.run(RunConfig(**base, **extra), out=buf)
        recs[leg] = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert tjsonl.strip_timing(recs["on"]) == tjsonl.strip_timing(
        recs["off"])
    prof = [r["phase"] for r in recs["on"]
            if r.get("phase", {}).get("name") == "profile"]
    assert len(prof) == 1 and prof[0]["dir"] == str(tmp_path / "tp")
    assert not any(r.get("phase", {}).get("name") == "profile"
                   for r in recs["off"])
    # the capture was the serial loop's
    loops = [r["phase"] for r in recs["on"]
             if r.get("phase", {}).get("name") == "gen-loop"]
    assert loops and loops[0]["pipelined"] is False
    attr = tprof.attribute(str(tmp_path / "tp"))
    for phase in ("sweep", "ga", "fitness"):
        assert attr["phases"][phase]["seconds"] > 0, attr["phases"]
    assert attr["unattributed_frac"] < 0.5
