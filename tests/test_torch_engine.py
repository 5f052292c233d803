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
    (["--obs"], "--obs"), (["--checkpoint", "c.npz"], "--checkpoint"),
    (["--ls-mode", "random"], "--ls-mode random"),
    (["--rooms-mode", "parallel"], "--rooms-mode parallel"),
    (["--trace-mode", "deltas"], "--trace-mode deltas"),
    (["--post-lahc", "8"], "--post-lahc"), (["--nsga2"], "--nsga2"),
    (["--distributed"], "--distributed"), (["-m", "8"], "-m")])
def test_unported_flags_are_refused_by_name(argv, word):
    with pytest.raises(SystemExit, match="not yet ported") as e:
        tconfig.parse_args(["-i", "x.tim"] + argv)
    assert word in str(e.value)


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
