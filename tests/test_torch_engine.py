"""The port's CLI and run loop (timetabling_ga_tpu_torch/cli.py,
runtime/) against the JAX CLI: the same record kinds and keys for the
same flags, a protocol-valid stream, feasibility on a 30-event
instance, the same tuned defaults and byte-identical JSONL records."""

import io
import json
import os
import subprocess
import sys

import pytest
import torch

from timetabling_ga_tpu.problem import dump_tim
from timetabling_ga_tpu.runtime import config as jconfig
from timetabling_ga_tpu.runtime import jsonl as jjsonl
from timetabling_ga_tpu_torch import cli as tcli
from timetabling_ga_tpu_torch.runtime import config as tconfig
from timetabling_ga_tpu_torch.runtime import engine as tengine
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl

torch.set_num_threads(1)

FLAGS = ["-s", "3", "--backend", "cpu", "-t", "300", "--no-auto-tune",
         "--ls-mode", "sweep", "--ls-sweeps", "1", "--init-sweeps", "2",
         "--pop-size", "8", "--generations", "10", "--migration-period",
         "5", "--islands", "2", "--trace"]


@pytest.fixture(scope="module")
def tim_path(tmp_path_factory, small_problem):
    path = tmp_path_factory.mktemp("tim") / "small.tim"
    path.write_text(dump_tim(small_problem))
    return str(path)


def _records(text):
    return [json.loads(line) for line in text.splitlines()]


def _shape(records):
    """Record kinds in stream order with their key sets (phase records
    by name), logEntry records dropped and repeats collapsed — what two
    solvers' streams share when their values and chunk counts differ."""
    out = []
    for rec in records:
        (kind, body), = rec.items()
        item = (kind, body.get("name"), tuple(sorted(body)))
        if kind != "logEntry" and (not out or out[-1] != item):
            out.append(item)
    return out


def _check_protocol(records):
    logs = [r["logEntry"] for r in records if "logEntry" in r]
    assert logs, "no logEntry"
    for proc in {x["procID"] for x in logs}:
        bests = [x["best"] for x in logs if x["procID"] == proc]
        assert bests == sorted(bests, reverse=True)
    sols = [r["solution"] for r in records if "solution" in r]
    runs = [r["runEntry"] for r in records if "runEntry" in r]
    assert len(runs) == 2 and "procsNum" in runs[1]
    assert runs[0]["totalBest"] == min(s["totalBest"] for s in sols)
    return sols, runs


def test_cli_stream_matches_jax_kinds_and_reaches_feasibility(
        tim_path, capsys):
    assert tcli.main(["-i", tim_path] + FLAGS) == 0
    port = _records(capsys.readouterr().out)
    sols, runs = _check_protocol(port)
    assert runs[0]["feasible"] and sols[0]["feasible"]
    assert len(sols[0]["timeslots"]) == 30

    from timetabling_ga_tpu.runtime import engine as jengine
    buf = io.StringIO()
    jengine.run(jconfig.parse_args(["-i", tim_path] + FLAGS), out=buf)
    ref = _records(buf.getvalue())
    _check_protocol(ref)
    assert _shape(port) == _shape(ref)
    assert {k for r in port for k in r} == {k for r in ref for k in r}


def test_tuned_defaults_match_jax():
    for n_events in (30, 400):
        for argv in ([], ["--pop-size", "8"], ["--ls-sweeps", "1"]):
            j = jconfig.parse_args(["-i", "x.tim"] + argv)
            t = tconfig.parse_args(["-i", "x.tim"] + argv)
            j.apply_tuned_defaults(n_events)
            t.apply_tuned_defaults(n_events)
            for f in ("pop_size", "ls_sweeps", "init_sweeps",
                      "ls_swap_block", "migration_period", "ls_hot_k",
                      "post_hot_k", "post_ls_sweeps", "post_swap_block",
                      "epochs_per_dispatch", "post_pop_size", "p3",
                      "ls_mode", "ls_converge", "ls_sideways"):
                assert getattr(j, f) == getattr(t, f), (n_events, argv, f)


@pytest.mark.parametrize("argv,word", [
    (["--peer-timeout", "5"], "--peer-timeout"),
    (["--num-processes", "2"], "--num-processes"),
    (["--coordinator", "h:1"], "--coordinator"),
    (["--no-accord"], "--no-accord"),
    (["--distributed"], "--distributed"),
    (["--process-id", "1"], "--process-id")])
def test_unported_flags_are_refused_by_name(argv, word):
    with pytest.raises(SystemExit, match="not yet ported") as e:
        tconfig.parse_args(["-i", "x.tim"] + argv)
    assert word in str(e.value)


@pytest.mark.parametrize("argv", [
    ["--trace-profile", "d"], ["--profile-dir", "d"],
    ["--profile-for", "2"],
    ["--profile-for", "0", "--profile-dir", "p", "--trace-profile", "t"]])
def test_profile_flags_parse_as_jax(argv):
    """The run's profiling flags parse as JAX's; serve takes
    --profile-dir and --profile-for as JAX's serve does."""
    j = jconfig.parse_args(["-i", "x.tim"] + argv)
    t = tconfig.parse_args(["-i", "x.tim"] + argv)
    for f in ("trace_profile", "profile_dir", "profile_for"):
        assert getattr(t, f) == getattr(j, f), f
    sargv = [a for i, a in enumerate(argv)
             if a != "--trace-profile" and (i == 0 or argv[i - 1]
                                            != "--trace-profile")]
    js = jconfig.parse_serve_args(sargv)
    ts = tconfig.parse_serve_args(sargv)
    assert (ts.profile_dir, ts.profile_for) == (js.profile_dir,
                                                js.profile_for)
    with pytest.raises(SystemExit, match="--profile-for must be >= 0"):
        tconfig.parse_args(["-i", "x.tim", "--profile-for", "-1"])
    with pytest.raises(SystemExit, match="--profile-for must be >= 0"):
        tconfig.parse_serve_args(["--profile-for", "-1"])


def test_checkpoint_flag_refusals_match_jax():
    """The tuned post_pop_size is dropped under --checkpoint, and an
    explicit --post-pop-size with --checkpoint stops the parse with
    JAX's message (JAX config.py:411-415, 647-649)."""
    for argv in ([], ["--pop-size", "8"]):
        j = jconfig.parse_args(["-i", "x.tim", "--checkpoint", "c"] + argv)
        t = tconfig.parse_args(["-i", "x.tim", "--checkpoint", "c"] + argv)
        j.apply_tuned_defaults(400)
        t.apply_tuned_defaults(400)
        assert j.post_pop_size is None and t.post_pop_size is None
        assert (j.checkpoint, j.checkpoint_every, j.resume) == (
            t.checkpoint, t.checkpoint_every, t.resume)
    argv = ["-i", "x.tim", "--checkpoint", "c", "--post-pop-size", "2"]
    with pytest.raises(SystemExit) as je:
        jconfig.parse_args(argv)
    with pytest.raises(SystemExit) as te:
        tconfig.parse_args(argv)
    assert str(je.value) == str(te.value)
    t = tconfig.parse_args(["-i", "x.tim", "--checkpoint", "c",
                            "--checkpoint-every", "3", "--resume"])
    assert (t.checkpoint, t.checkpoint_every, t.resume) == ("c", 3, True)


@pytest.mark.parametrize("mode", ["full", "deltas", "stats"])
def test_trace_mode_values_parse_as_jax(mode):
    argv = ["-i", "x.tim", "--trace-mode", mode]
    assert jconfig.parse_args(argv).trace_mode == \
        tconfig.parse_args(argv).trace_mode == mode
    with pytest.raises(SystemExit, match="unknown trace-mode"):
        tconfig.parse_args(["-i", "x.tim", "--trace-mode", "terse"])

@pytest.mark.parametrize("argv", [
    [], ["-p", "2"], ["-p", "3"], ["-p", "2", "-m", "50"],
    ["--ls-candidates", "5", "-p", "2"], ["-m", "3"], ["--ls-full-eval"],
    ["--ls-mode", "random", "-p", "3", "--ls-candidates", "16"],
    ["--ls-mode", "sweep", "--ls-sweeps", "2"]])
def test_ls_flags_and_ga_config_match_jax(argv):
    """The random-LS flags parse as the JAX CLI parses them, and
    build_ga_config sizes the search as the JAX engine does (rounds =
    maxSteps // candidates, maxSteps by -p unless -m)."""
    from timetabling_ga_tpu.runtime import engine as jengine
    argv = ["-i", "x.tim", "--no-auto-tune"] + argv
    j, t = jconfig.parse_args(argv), tconfig.parse_args(argv)
    for f in ("problem_type", "max_steps", "ls_candidates", "ls_mode",
              "ls_full_eval", "ls_time_limit"):
        assert getattr(j, f) == getattr(t, f), f
    assert j.resolved_max_steps() == t.resolved_max_steps()
    jg, tg = jengine.build_ga_config(j), tengine.build_ga_config(t)
    for f in ("pop_size", "ls_steps", "ls_candidates", "ls_delta",
              "ls_mode", "ls_sweeps", "p1", "p2", "p3"):
        assert getattr(jg, f) == getattr(tg, f), f


@pytest.mark.parametrize("argv", [
    [], ["--rooms-mode", "parallel"], ["--nsga2"], ["--post-lahc", "5000"],
    ["--post-lahc", "64", "--post-lahc-k", "1"],
    ["--nsga2", "--rooms-mode", "parallel", "--post-lahc", "7",
     "--post-lahc-k", "4096", "--pop-size", "8", "--post-pop-size", "2"],
    ["--post-lahc", "10", "--no-auto-tune"]])
def test_search_mode_flags_ga_and_post_configs_match_jax(argv):
    """--rooms-mode, --nsga2, --post-lahc and --post-lahc-k parse as the
    JAX CLI parses them; build_ga_config passes rooms_mode and
    multi_objective through, and build_post_config returns the post
    config whenever post_lahc > 0, even when it equals the repair config
    (JAX engine.py:453-507)."""
    from timetabling_ga_tpu.runtime import engine as jengine
    argv = ["-i", "x.tim"] + argv
    j, t = jconfig.parse_args(argv), tconfig.parse_args(argv)
    if "--no-auto-tune" not in argv:
        j.apply_tuned_defaults(400)
        t.apply_tuned_defaults(400)
    for f in ("rooms_mode", "nsga2", "post_lahc", "post_lahc_k",
              "post_pop_size"):
        assert getattr(j, f) == getattr(t, f), f
    jg, tg = jengine.build_ga_config(j), tengine.build_ga_config(t)
    for f in ("rooms_mode", "multi_objective", "pop_size"):
        assert getattr(jg, f) == getattr(tg, f), f
    jp, tp = jengine.build_post_config(j, jg), tengine.build_post_config(t, tg)
    assert (jp is None) == (tp is None)
    if jp is not None:
        for f in ("pop_size", "ls_sweeps", "ls_swap_block", "ls_hot_k",
                  "ls_sideways", "rooms_mode", "multi_objective", "p1",
                  "p2", "p3"):
            assert getattr(jp, f) == getattr(tp, f), f


@pytest.mark.parametrize("argv", [
    ["--post-lahc", "-1"], ["--post-lahc", "1000001"],
    ["--post-lahc-k", "0"], ["--post-lahc-k", "4097"],
    ["--rooms-mode", "greedy"]])
def test_search_mode_flag_validation_matches_jax(argv):
    argv = ["-i", "x.tim"] + argv
    with pytest.raises(SystemExit) as je:
        jconfig.parse_args(argv)
    with pytest.raises(SystemExit) as te:
        tconfig.parse_args(argv)
    assert str(je.value) == str(te.value)


def test_reference_path_cli_on_cpu(tim_path, capsys):
    """`--no-auto-tune -p 1` (the random-candidate LS, delta-scored) on
    the CPU emits a protocol-valid stream; -l is accepted with the JAX
    path's warning."""
    assert tcli.main(["-i", tim_path, "-s", "5", "--backend", "cpu",
                      "--no-auto-tune", "-p", "1", "--pop-size", "4",
                      "--generations", "3", "-l", "10", "--trace"]) == 0
    out = capsys.readouterr()
    records = _records(out.out)
    _check_protocol(records)
    assert "-l (LS time limit) is retired" in out.err
    disp = [r["phase"] for r in records if "phase" in r
            and r["phase"]["name"] == "dispatch"]
    assert sum(p["gens"] for p in disp) == 3


def test_nsga2_parallel_rooms_cli_on_cpu(tim_path, capsys):
    """`--nsga2 --rooms-mode parallel` on the CPU: every generation runs
    NSGA-II selection and the parallel matcher (their plain versions),
    and the stream is protocol-valid."""
    assert tcli.main(["-i", tim_path, "-s", "4", "--backend", "cpu",
                      "--no-auto-tune", "--ls-mode", "sweep",
                      "--ls-sweeps", "1", "--init-sweeps", "1",
                      "--pop-size", "6", "--islands", "2", "--generations",
                      "4", "--migration-period", "2", "--nsga2",
                      "--rooms-mode", "parallel", "--trace"]) == 0
    records = _records(capsys.readouterr().out)
    _check_protocol(records)
    disp = [r["phase"] for r in records if "phase" in r
            and r["phase"]["name"] == "dispatch"]
    assert sum(p["gens"] for p in disp) == 4


def test_gpu_backend_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.resolve_device("gpu")


def test_jsonl_records_are_byte_identical():
    records = []
    for mod in (jjsonl, tjsonl):
        buf = io.StringIO()
        mod.log_entry(buf, 1, 0, 3_000_017, 1.5)
        mod.solution_record(buf, 0, 0, 2.0, 17, True, [1, 2], [0, 1])
        mod.solution_record(buf, 1, 0, 2.0, 2_000_000, False)
        mod.run_entry(buf, 17, True)
        mod.run_entry(buf, 17, True, procs_num=2, threads_num=1,
                      total_time=2.5)
        mod.phase_record(buf, "dispatch", 0, 0.25, gens=4)
        records.append(buf.getvalue())
    assert records[0] == records[1]
    assert tjsonl.strip_timing(_records(records[1])) == \
        jjsonl.strip_timing(_records(records[0]))


def test_package_imports_without_jax_or_nvcc():
    code = ("import sys, timetabling_ga_tpu_torch.cli, "
            "timetabling_ga_tpu_torch.runtime.engine, "
            "timetabling_ga_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'timetabling_ga_tpu' or "
            "m.startswith('timetabling_ga_tpu.')]; "
            "assert not bad, bad")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo,
                   env={"PATH": os.defpath, "PYTHONPATH": repo})


C1_FLAGS = ["-s", "3", "--backend", "cpu", "-t", "300", "--no-auto-tune",
            "--ls-mode", "sweep", "--ls-sweeps", "1", "--init-sweeps", "1",
            "--pop-size", "4", "--generations", "6", "--migration-period",
            "2"]


def test_migrations_follow_generations_2_4_6(tim_path, monkeypatch,
                                             capsys):
    """The first sec/gen estimate is one generation on a clone, outside
    the run (JAX engine.py:817-836), so the run's first dispatch is a
    full epoch and it migrates after generations 2, 4 and 6, as the JAX
    engine does (engine.py:1997-2009)."""
    from timetabling_ga_tpu_torch.ops import ga as tga
    from timetabling_ga_tpu_torch.parallel import islands as tislands
    gens, migrations, probes = [0], [], []
    in_probe = [False]
    real_gen, real_mig = tga.generation, tislands.migrate
    real_probe = tengine.probe_sec_per_gen

    def generation(*a, **k):
        gens[0] += 0 if in_probe[0] else 1
        return real_gen(*a, **k)

    def migrate(*a, **k):
        if not in_probe[0]:
            migrations.append(gens[0])
        return real_mig(*a, **k)

    def probe(*a, **k):
        in_probe[0] = True
        try:
            probes.append(real_probe(*a, **k))
        finally:
            in_probe[0] = False
        return probes[-1]

    monkeypatch.setattr(tga, "generation", generation)
    monkeypatch.setattr(tislands, "migrate", migrate)
    monkeypatch.setattr(tengine, "probe_sec_per_gen", probe)
    assert tcli.main(["-i", tim_path] + C1_FLAGS) == 0
    capsys.readouterr()
    assert len(probes) == 1 and probes[0] > 0
    assert gens[0] == 6
    assert migrations == [2, 4, 6]


def test_probe_leaves_the_record_stream_unchanged(tim_path, monkeypatch,
                                                  capsys):
    """A run that takes its first estimate from the probe and one seeded
    with an estimate give the same records under strip_timing: the probe
    advances neither the run's state nor its generators."""
    assert tcli.main(["-i", tim_path] + C1_FLAGS) == 0
    probed = _records(capsys.readouterr().out)
    monkeypatch.setattr(tengine, "probe_sec_per_gen", lambda *a: 1e-3)
    assert tcli.main(["-i", tim_path] + C1_FLAGS) == 0
    seeded = _records(capsys.readouterr().out)
    _check_protocol(probed)
    assert tjsonl.strip_timing(probed) == tjsonl.strip_timing(seeded)


class _Sizing:
    """A config of the fields _dispatch_size reads."""

    def __init__(self, migration_period, epochs_per_dispatch):
        self.migration_period = migration_period
        self.epochs_per_dispatch = epochs_per_dispatch


@pytest.mark.parametrize("rule,args,want", [
    # budget spent, or one generation predicted over the cap: stop
    ("stop-budget", (_Sizing(5, 8), 100, 0.1, 0.0), None),
    ("stop-over-cap", (_Sizing(5, 8), 100, 10.5, 1e6), None),
    # n_epochs floored to a power of two (7 -> 4), then bounded by the
    # cap: 10 / (0.4 * 5) = 5 epochs fit, floored to 4; 2 at 0.9 s/gen
    ("pow2", (_Sizing(5, 7), 100, 0.01, 1e6), (4, 5)),
    ("cap-bounds-epochs", (_Sizing(5, 8), 100, 0.4, 1e6), (4, 5)),
    ("cap-bounds-epochs-2", (_Sizing(5, 8), 100, 0.9, 1e6), (2, 5)),
    # one epoch predicted over the cap: one shortened epoch of the
    # generations that fit, int(10 / 3) = 3
    ("shortened-epoch", (_Sizing(5, 8), 100, 3.0, 1e6), (1, 3)),
    # a tail shorter than migration_period, bounded by the cap too
    ("tail-capped", (_Sizing(50, 1), 40, 2.0, 1e6), (1, 5)),
    ("tail", (_Sizing(50, 1), 40, 0.01, 1e6), (1, 40)),
    # then the budget: 12 generations fit -> 2 epochs (a power of two),
    # 3 fit -> one shortened epoch
    ("budget-epochs", (_Sizing(5, 8), 100, 0.01, 0.125), (2, 5)),
    ("budget-short", (_Sizing(5, 8), 100, 0.01, 0.035), (1, 3)),
])
def test_dispatch_size_follows_jax_watchdog_rules(monkeypatch, rule, args,
                                                  want):
    """The port's dispatch sizing under TT_DISPATCH_CAP_S = 10 and a
    fixed sec/gen, case by case against JAX engine.py:1988-2075."""
    monkeypatch.setattr(tengine, "DISPATCH_CAP_S", 10.0)
    assert tengine._dispatch_size(*args) == want


def test_dispatch_cap_reads_the_environment():
    code = ("from timetabling_ga_tpu_torch.runtime import engine; "
            "print(engine.DISPATCH_CAP_S)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], check=True, cwd=repo,
        capture_output=True, text=True,
        env={"PATH": os.defpath, "PYTHONPATH": repo,
             "TT_DISPATCH_CAP_S": "2.5"}).stdout
    assert float(out) == 2.5


C2_FLAGS = ["-s", "3", "--backend", "cpu", "-t", "300", "--no-auto-tune",
            "--ls-mode", "sweep", "--ls-sweeps", "1", "--init-sweeps", "1",
            "--pop-size", "4", "--generations", "12", "--migration-period",
            "5", "--trace"]


class _DispatchClock:
    """A stand-in for the engine's `time` module whose monotonic clock
    moves only when a dispatch's trace is read: by `spg` seconds for each
    generation of that dispatch, whatever the host's load. Serial or
    pipelined, the wall the engine measures for a dispatch (its trace
    read's fence minus the previous fence or its enqueue) is then
    exactly spg x its generations."""

    def __init__(self, spg):
        import time
        self._time = time
        self.spg = spg
        self.t = 1000.0
        self.queued = []          # generations of dispatches not yet read

    def __getattr__(self, name):
        return getattr(self._time, name)

    def monotonic(self):
        return self.t


def _pin_dispatch_wall(monkeypatch, spg):
    """Make every dispatch of the port engine measure `spg` seconds a
    generation: the engine's clock is a _DispatchClock, advanced as each
    dispatch's trace is read (run_epochs queues its generations, the
    trace's HostCopy read takes them)."""
    from timetabling_ga_tpu_torch.parallel import islands as tislands
    from timetabling_ga_tpu_torch.runtime import dispatch_core as tdcore
    clock = _DispatchClock(spg)
    real_run, real_fetch = tislands.run_epochs, tdcore.fetch

    def run_epochs(pa, gens, state, cur, n_ep, g, *a, **k):
        clock.queued.append(n_ep * g)
        return real_run(pa, gens, state, cur, n_ep, g, *a, **k)

    def fetch(x, *a, **k):
        out = real_fetch(x, *a, **k)
        if isinstance(x, tdcore.HostCopy) and clock.queued:
            clock.t += clock.spg * clock.queued.pop(0)
        return out
    monkeypatch.setattr(tengine, "time", clock)
    monkeypatch.setattr(tislands, "run_epochs", run_epochs)
    monkeypatch.setattr(tdcore, "fetch", fetch)
    return clock


def test_engine_shortens_an_epoch_over_the_cap(tim_path, monkeypatch,
                                               capsys):
    """With a 1 s cap and a probe of 0.4 s a generation, a 5-generation
    epoch is predicted over the cap: the first dispatch is one shortened
    epoch of int(1 / 0.4) = 2 generations, and migration closes it
    (JAX engine.py:2019-2034). Every dispatch measures 0.4 s a
    generation too (_pin_dispatch_wall), so the sizing rule is checked
    whatever the host's load: a loaded host's real wall would move the
    estimate the engine folds in after each dispatch."""
    from timetabling_ga_tpu_torch.parallel import islands as tislands
    monkeypatch.setattr(tengine, "DISPATCH_CAP_S", 1.0)
    monkeypatch.setattr(tengine, "probe_sec_per_gen", lambda *a: 0.4)
    _pin_dispatch_wall(monkeypatch, 0.4)
    migrations = []
    real_mig = tislands.migrate

    def migrate(*a, **k):
        migrations.append(1)
        return real_mig(*a, **k)
    monkeypatch.setattr(tislands, "migrate", migrate)
    assert tcli.main(["-i", tim_path] + C2_FLAGS) == 0
    records = _records(capsys.readouterr().out)
    _check_protocol(records)
    disp = [r["phase"] for r in records if "phase" in r
            and r["phase"]["name"] == "dispatch"]
    assert (disp[0]["epochs"], disp[0]["gens"]) == (1, 2)
    assert sum(p["gens"] for p in disp) == 12
    assert all(p["gens"] <= 5 * p["epochs"] for p in disp)
    assert len(migrations) == sum(p["epochs"] for p in disp)


def test_engine_stops_before_the_tail_polish_over_the_cap(
        tim_path, monkeypatch, capsys):
    """A probe predicting one generation over the cap stops the
    generation loop before its first dispatch; the budget goes to the
    tail polish (JAX engine.py:1988-1997)."""
    monkeypatch.setattr(tengine, "DISPATCH_CAP_S", 1.0)
    monkeypatch.setattr(tengine, "probe_sec_per_gen", lambda *a: 5.0)
    assert tcli.main(["-i", tim_path] + C2_FLAGS) == 0
    records = _records(capsys.readouterr().out)
    _check_protocol(records)
    names = [r["phase"]["name"] for r in records if "phase" in r]
    assert "dispatch" not in names
    loop = [r["phase"] for r in records if "phase" in r
            and r["phase"]["name"] == "gen-loop"]
    assert loop[0]["dispatches"] == 0
    assert names.index("gen-loop") < names.index("tail-polish")
