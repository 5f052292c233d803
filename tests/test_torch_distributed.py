"""Islands across processes on the CPU: real two-process runs of the
port's CLI joined by torch.distributed over gloo (`--backend cpu
--coordinator 127.0.0.1:PORT --num-processes 2 --process-id i`), 2
islands a process.

Tier-1: the two-process stream equals the one-process 4-island stream
under strip_timing, with the accord channel and under --no-accord;
process 1 writes nothing (it never opens -o); process 0's runEntry
counts every island. A loopback twin of the peer-death e2e drives the
engine's PeerLost branch in one process (a process group of two whose
peer's collectives are this process's own, and an accord channel whose
peer has died); a JAX-format 8-island checkpoint resumes the same on a
2-shard mesh as on one shard.

Slow (the e2e twins of JAX tests/test_accord.py:350 and
tests/test_runtime.py:629): `dispatch@1:2:die` kills process 1; process
0 classifies PeerLost within --peer-timeout, writes the abort faultEntry
(lostProc 1) and a final checkpoint, exits 70; a fresh two-process
`--resume` run finishes as the uninjected run does. And a checkpoint
crosses layouts both ways: 2 processes -> 1 and 1 -> 2.
"""

import io
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.runtime import checkpoint as jckpt
from timetabling_ga_tpu_torch.parallel import comm
from timetabling_ga_tpu_torch.problem import load_tim_file
from timetabling_ga_tpu_torch.runtime import checkpoint as tckpt
from timetabling_ga_tpu_torch.runtime import config as tconfig
from timetabling_ga_tpu_torch.runtime import control_channel as tcc
from timetabling_ga_tpu_torch.runtime import engine
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFERENCE = ["-s", "5", "--backend", "cpu", "-t", "300", "--no-auto-tune",
             "-p", "1", "-m", "16", "--pop-size", "4",
             "--migration-period", "2", "--islands", "4"]


@pytest.fixture(scope="module")
def tim_path(tmp_path_factory):
    problem = random_instance(1, n_events=30, n_rooms=4, n_features=3,
                              n_students=20, attend_prob=0.15)
    path = tmp_path_factory.mktemp("dist") / "small.tim"
    path.write_text(dump_tim(problem))
    return str(path)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(faults=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("TT_FAULTS", None)
    if faults:
        env["TT_FAULTS"] = faults
    return env


def _cli(args):
    return [sys.executable, "-m", "timetabling_ga_tpu_torch", *args]


def _two(tim_path, flags, outs, faults=None, timeout=120, env_rdzv=False):
    """Run two processes of the CLI, joined by --coordinator or, with
    env_rdzv, by `--distributed` and torch's env:// variables; returns
    [(rc, stderr)] a process. Both are stopped, whatever happens."""
    port = _free_port()

    def launch(r):
        env = _env(faults)
        if env_rdzv:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE="2", RANK=str(r))
            join = ["--distributed"]
        else:
            join = ["--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(r)]
        return subprocess.Popen(
            _cli(["-i", tim_path, *flags, *join, "-o", outs[r]]), env=env,
            stderr=subprocess.PIPE, text=True, cwd=REPO)
    procs = [launch(r) for r in range(2)]
    res = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1, deadline
                                               - time.monotonic()))
            res.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def _one(tim_path, flags, out, faults=None):
    r = subprocess.run(_cli(["-i", tim_path, *flags, "-o", out]),
                       env=_env(faults), capture_output=True, text=True,
                       cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def _read(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.parametrize("launch", ["coordinator", "no-accord", "env"])
def test_two_processes_equal_one(tim_path, tmp_path, launch):
    """Two processes of 2 islands give the one-process 4-island stream,
    joined by --coordinator (with the accord channel and under
    --no-accord) or by --distributed's env:// variables; process 1
    writes nothing; the gloo backend is chosen and printed."""
    flags = REFERENCE + ["--generations", "8"] + (
        ["--no-accord"] if launch == "no-accord" else [])
    outs = [str(tmp_path / f"p{r}.jsonl") for r in range(2)]
    res = _two(tim_path, flags, outs, env_rdzv=launch == "env")
    for rc, err in res:
        assert rc == 0, err[-2000:]
        assert "gloo process group (--backend cpu)" in err
    assert not os.path.exists(outs[1])
    _one(tim_path, flags, str(tmp_path / "one.jsonl"))
    two, one = _read(outs[0]), _read(str(tmp_path / "one.jsonl"))
    assert tjsonl.strip_timing(two) == tjsonl.strip_timing(one)
    run_entry = [r["runEntry"] for r in two if "runEntry" in r][-1]
    assert run_entry["procsNum"] == 4
    assert not [r for r in two if "faultEntry" in r]


class _MirrorGroup(comm.ProcessGroup):
    """A process group of two in one process: the peer's shards are a
    copy of this process's (its gathers repeat ours, its halo rows are
    ours), enough to drive the engine's multi-process paths."""

    def __init__(self):
        super().__init__(rank=0, world=2, backend="gloo")

    def all_gather(self, x, axis=0):
        comm._guard()
        return np.concatenate([x, x], axis)

    def all_reduce_min(self, t):
        comm._guard()
        return t

    def exchange(self, to_next, to_prev):
        comm._guard()
        return to_next, to_prev

    def broadcast(self, vals):
        return [int(v) for v in vals]


def test_peer_lost_abort_loopback(tim_path, tmp_path, monkeypatch):
    """The peer-death twin in one process: the accord channel is a
    loopback view whose peer stops beating after the run's first
    fences, so a guard before a collective raises PeerLost within
    --peer-timeout; the run writes the abort faultEntry (proc 0, agreed
    false, lostProc 1) and a final checkpoint from its snapshot, and
    the error propagates (JAX engine.py:2190-2217)."""
    views = tcc.LoopbackChannel.group(2, peer_timeout=0.5, hb_interval=0.05)
    guards = [0]
    real_guard = tcc.LoopbackChannel.guard_collective

    def guard(self):
        # the peer meets the first fences (init, snapshot, first dispatch)
        # and then dies
        guards[0] += 1
        if guards[0] <= 6:
            return None
        views[1].kill()
        return real_guard(self)
    monkeypatch.setattr(tcc.LoopbackChannel, "guard_collective", guard)
    monkeypatch.setattr(tcc, "open_channel", lambda *a, **k: views[0])
    comm.install(_MirrorGroup())
    ck = str(tmp_path / "ck.npz")
    cfg = tconfig.parse_args(["-i", tim_path, *REFERENCE, "--generations",
                              "40", "--checkpoint", ck])
    out = io.StringIO()
    try:
        with pytest.raises(tcc.PeerLost) as ei:
            engine.run(cfg, out=out, devices=[CPU])
    finally:
        comm.install(None)
        views[1].close()
    assert ei.value.proc == 1
    recs = [json.loads(line) for line in out.getvalue().splitlines()]
    fe = [r["faultEntry"] for r in recs if "faultEntry" in r]
    assert fe[-1]["site"] == "accord" and fe[-1]["action"] == "abort"
    assert (fe[-1]["proc"], fe[-1]["agreed"], fe[-1]["lostProc"]) == (
        0, False, 1)
    with np.load(ck) as z:
        # the whole mesh's population: this process's shard and the
        # peer's
        assert z["slots"].shape[0] == 4 * 4
        assert int(z["generation"]) >= 0


def test_jax_checkpoint_resumes_the_same_on_any_layout(tim_path, tmp_path):
    """An 8-island checkpoint in JAX's format (no generator states)
    resumes on a 2-shard mesh as on one shard: the reseeded generators
    depend on each island's global index only."""
    flags = REFERENCE[:-2] + ["--islands", "8"]
    problem = load_tim_file(tim_path)
    cfg = tconfig.parse_args(["-i", tim_path, *flags, "--generations", "4"])
    gacfg = engine.build_ga_config(cfg)
    fp = tckpt.config_fingerprint(problem, gacfg, 8)
    mesh_one = engine.islands.Mesh([CPU], comm.SOLO)
    pa = [problem.device_arrays(CPU)]
    gens = engine.mesh_generators(mesh_one, 11, 0, 8)
    st = engine.islands.mesh_init(mesh_one, pa, gens, 4)[0]
    ck = str(tmp_path / "jax.npz")
    jckpt.save(ck, type(st)(*(x.numpy() for x in st)),
               np.zeros(2, np.uint32), 2, fp, [2_000_000] * 8, 5)
    outs = []
    for n, devices in enumerate(([CPU], [CPU, CPU])):
        # each resume writes its own checkpoints: a copy each
        mine = str(tmp_path / f"resume{n}.npz")
        shutil.copyfile(ck, mine)
        c = tconfig.parse_args(["-i", tim_path, *flags, "--generations",
                                "6", "--checkpoint", mine, "--resume"])
        buf = io.StringIO()
        engine.run(c, out=buf, devices=devices)
        outs.append(tjsonl.strip_timing(
            [json.loads(line) for line in buf.getvalue().splitlines()]))
    assert outs[0] == outs[1]
    assert [r["runEntry"] for r in outs[0]
            if "runEntry" in r][-1]["procsNum"] == 8


@pytest.mark.slow
def test_two_process_peer_death_agreed_abort_and_resume(tim_path, tmp_path):
    """`dispatch@1:2:die`: process 1 dies at its second dispatch;
    process 0 reports PeerLost within --peer-timeout (exit 70), with the
    abort faultEntry naming process 1 and a final checkpoint; a fresh
    two-process --resume run ends as the uninjected run does."""
    ck = str(tmp_path / "ck.npz")
    flags = REFERENCE + ["--generations", "40", "--peer-timeout", "5",
                         "--checkpoint", ck]
    outs = [str(tmp_path / f"p{r}.jsonl") for r in range(2)]
    t0 = time.monotonic()
    res = _two(tim_path, flags, outs, faults="dispatch@1:2:die")
    assert time.monotonic() - t0 < 60
    (rc0, err0), (rc1, _) = res
    assert rc0 == 70, err0[-2000:]
    assert rc1 != 0
    assert "lost contact with process 1" in err0
    fe = [r["faultEntry"] for r in _read(outs[0]) if "faultEntry" in r]
    assert fe[-1]["action"] == "abort" and fe[-1]["lostProc"] == 1
    assert fe[-1]["agreed"] is False
    assert os.path.exists(ck)
    res = _two(tim_path, flags + ["--resume"],
               [str(tmp_path / f"r{r}.jsonl") for r in range(2)])
    for rc, err in res:
        assert rc == 0, err[-2000:]
    _one(tim_path, REFERENCE + ["--generations", "40"],
         str(tmp_path / "base.jsonl"))

    def core(recs):
        return [r for r in tjsonl.strip_timing(recs)
                if "solution" in r or "runEntry" in r]
    assert core(_read(str(tmp_path / "r0.jsonl"))) == core(
        _read(str(tmp_path / "base.jsonl")))


@pytest.mark.slow
def test_checkpoint_crosses_process_layouts(tim_path, tmp_path):
    """2 processes write, 1 resumes; 1 writes, 2 resume: each ends as an
    uninterrupted one-process run does (JAX tests/test_runtime.py:629)."""
    base = str(tmp_path / "base.jsonl")
    _one(tim_path, REFERENCE + ["--generations", "12"], base)

    def core(recs):
        return [r for r in tjsonl.strip_timing(recs)
                if "solution" in r or "runEntry" in r]
    want = core(_read(base))
    ck = str(tmp_path / "a.npz")
    first = REFERENCE + ["--checkpoint", ck]
    res = _two(tim_path, first + ["--generations", "6"],
               [str(tmp_path / f"a{r}.jsonl") for r in range(2)])
    assert all(rc == 0 for rc, _ in res), res
    _one(tim_path, first + ["--generations", "12", "--resume"],
         str(tmp_path / "a_resumed.jsonl"))
    assert core(_read(str(tmp_path / "a_resumed.jsonl"))) == want
    ck = str(tmp_path / "b.npz")
    second = REFERENCE + ["--checkpoint", ck]
    _one(tim_path, second + ["--generations", "6"],
         str(tmp_path / "b.jsonl"))
    outs = [str(tmp_path / f"b{r}.jsonl") for r in range(2)]
    res = _two(tim_path, second + ["--generations", "12", "--resume"], outs)
    assert all(rc == 0 for rc, _ in res), res
    assert core(_read(outs[0])) == want
