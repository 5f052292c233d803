"""The port's depth-2 dispatch pipeline (runtime/dispatch_core.py
DispatchPipeline, runtime/engine.py's loop) against its serial loop and
the JAX engine's rules.

Held here on a 15-event instance: a pipelined run and a --no-pipeline
run give the same records under strip_timing, with and without
--checkpoint, in every trace mode and with the quality telemetry; the
`gen-loop` record says which loop ran, and the loop is serial wherever
JAX's is (a post config, the quality auto-kick); a pipelined checkpoint
covers the chunk in flight, so the saves are as many as the JAX
engine's; under --no-precompile a chunk is retired before the next is
enqueued until one has been measured; and the sizing reserves the
in-flight chunk's predicted cost out of the budget.
"""

import io
import json

import numpy as np
import pytest
import torch

from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.runtime.config import RunConfig as JRunConfig
from timetabling_ga_tpu_torch.runtime import dispatch_core as tdcore
from timetabling_ga_tpu_torch.runtime import engine as tengine
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl
from timetabling_ga_tpu_torch.runtime.config import RunConfig as TRunConfig

torch.set_num_threads(1)

_RUN = dict(seed=3, pop_size=8, islands=1, generations=30,
            migration_period=10, max_steps=8, time_limit=300,
            backend="cpu", auto_tune=False, trace=True)


@pytest.fixture(scope="module")
def tims(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipe") / "tiny.tim"
    path.write_text(dump_tim(random_instance(
        55, n_events=15, n_rooms=5, n_features=2, n_students=10,
        attend_prob=0.1)))
    return {"tiny": str(path)}


def _run(tim, **kw):
    buf = io.StringIO()
    args = dict(_RUN, input=tim)
    args.update(kw)
    best = tengine.run(TRunConfig(**args), out=buf)
    return best, [json.loads(x) for x in buf.getvalue().splitlines()]


def _phases(lines, name):
    return [x["phase"] for x in lines
            if "phase" in x and x["phase"]["name"] == name]


CONFIGS = {
    "reference": dict(),
    "islands-deltas": dict(islands=3, trace_mode="deltas"),
    "stats-full-eval": dict(trace_mode="stats", ls_full_eval=True),
    "sweep": dict(ls_mode="sweep", ls_sweeps=1, init_sweeps=1,
                  generations=12, migration_period=4, islands=2),
    "quality-stall": dict(quality=True, stall_window=1,
                          stall_hamming=1.0, islands=2),
}


@pytest.mark.parametrize("checkpoint", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_pipelined_equals_serial(name, checkpoint, tims, tmp_path):
    """The default (pipelined) run and --no-pipeline give the same
    records under strip_timing; `gen-loop` says which ran; with
    --checkpoint both final files hold the same population, generation,
    floor and generator states."""
    kw = dict(CONFIGS[name])
    tim = tims["tiny"]
    streams, files = {}, {}
    for pipe in (True, False):
        if checkpoint:
            files[pipe] = str(tmp_path / f"{pipe}.npz")
            kw.update(checkpoint=files[pipe], checkpoint_every=1)
        best, lines = _run(tim, pipeline=pipe, **kw)
        loop = _phases(lines, "gen-loop")
        assert [x["pipelined"] for x in loop] == [pipe]
        streams[pipe] = (best, tjsonl.strip_timing(lines))
    assert streams[True] == streams[False]
    if checkpoint:
        with np.load(files[True]) as a, np.load(files[False]) as b:
            assert int(a["generation"]) == kw.get("generations", 30)
            for k in ("slots", "rooms", "penalty", "hcv", "scv",
                      "generation", "best_seen", "torch_generators"):
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", [
    dict(kick_stall=1, post_pop_size=4),
    dict(quality=True, stall_window=1, stall_hamming=1.0,
         auto_kick_on_stall=True, islands=2),
    dict(post_lahc=5, time_limit=2.0, generations=20)])
def test_control_reads_serialize_the_loop(kw, tims):
    """A post config (its phase switch and stall kick read a chunk
    before choosing the next) and the quality auto-kick run the serial
    loop, as JAX's engine does (engine.py:1534-1538)."""
    _, lines = _run(tims["tiny"], **kw)
    assert [x["pipelined"] for x in _phases(lines, "gen-loop")] == [False]


def _spy_pipeline(monkeypatch):
    """Record each submit and each retire (with whether a chunk was in
    flight) of the engine's DispatchPipeline."""
    log = []
    real = tdcore.DispatchPipeline

    class Spy(real):
        def __init__(self, process, enabled):
            def logged(chunk, inflight=None):
                log.append(("retire", chunk.td0, inflight is not None))
                return process(chunk, inflight)
            super().__init__(logged, enabled)

        def submit(self, chunk):
            log.append(("submit", chunk.td0, None))
            super().submit(chunk)

    monkeypatch.setattr(tdcore, "DispatchPipeline", Spy)
    return log


def _order(log):
    ids = {}
    return [(kind, ids.setdefault(td0, len(ids)), infl)
            for kind, td0, infl in log]


def test_no_precompile_drains_until_measured(tims, monkeypatch):
    """With the probe (the default) chunk N retires with N+1 in flight;
    under --no-precompile there is no estimate, so chunk 0 retires
    before chunk 1 is enqueued, and the loop pipelines from then on (JAX
    engine.py:1970-1977). The records are the same."""
    probes = []
    real_probe = tengine.probe_sec_per_gen
    monkeypatch.setattr(tengine, "probe_sec_per_gen",
                        lambda *a: probes.append(1) or real_probe(*a))
    log = _spy_pipeline(monkeypatch)
    b0, l0 = _run(tims["tiny"])
    assert len(probes) == 1
    assert _order(log) == [
        ("submit", 0, None), ("submit", 1, None), ("retire", 0, True),
        ("submit", 2, None), ("retire", 1, True), ("retire", 2, False)]
    log.clear()
    b1, l1 = _run(tims["tiny"], precompile=False)
    assert len(probes) == 1
    assert _order(log) == [
        ("submit", 0, None), ("retire", 0, False), ("submit", 1, None),
        ("submit", 2, None), ("retire", 1, True), ("retire", 2, False)]
    assert (b0, tjsonl.strip_timing(l0)) == (b1, tjsonl.strip_timing(l1))


def test_sizing_reserves_the_chunk_in_flight(tims, monkeypatch):
    """A probe of 2 s a generation and a 36 s budget: the first chunk is
    a 10-generation epoch; pipelined, the second is sized with that
    chunk's predicted 20 s reserved (int((36 - 20 - e) / 2) = 7
    generations, e the few host seconds spent), while the serial loop
    retires it first and sizes from the measured estimate."""
    monkeypatch.setattr(tengine, "probe_sec_per_gen", lambda *a: 2.0)
    got = {}
    for pipe in (True, False):
        _, lines = _run(tims["tiny"], pipeline=pipe, time_limit=36.0)
        got[pipe] = [p["gens"] for p in _phases(lines, "dispatch")]
    assert got[True][:2] == [10, 7]
    assert got[False][:2] == [10, 10]
    assert sum(got[False]) == 30


def test_checkpoint_folds_the_chunk_in_flight(tims, tmp_path):
    """Two 5-generation chunks checkpointed every epoch: pipelined, the
    one save happens at the first chunk's fence and covers the second,
    in flight, whose improvement is folded into the saved floor (JAX
    engine.py:1866-1890); the file equals the serial run's, whose save
    follows the second chunk."""
    files, floors = {}, {}
    for pipe in (True, False):
        files[pipe] = str(tmp_path / f"{pipe}.npz")
        _, lines = _run(tims["tiny"], pipeline=pipe, generations=10,
                        migration_period=5, checkpoint_every=1,
                        checkpoint=files[pipe])
        assert len(_phases(lines, "checkpoint")) == (1 if pipe else 2)
        floors[pipe] = min(x["logEntry"]["best"] for x in lines
                           if "logEntry" in x)
        # the second chunk improves the best
        gens, last = 0, None
        for x in lines:
            if "phase" in x and x["phase"]["name"] == "dispatch":
                gens += x["phase"]["gens"]
            if "logEntry" in x:
                last = gens
        assert last == 10
    with np.load(files[True]) as a, np.load(files[False]) as b:
        assert list(a["best_seen"]) == [floors[True]] == [floors[False]]
        for k in ("slots", "generation", "best_seen", "torch_generators"):
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_saves_as_many_as_jax(tims, tmp_path):
    """Pipelined, a save at chunk N's fence covers chunk N+1 in flight:
    three chunks checkpointed every epoch save twice (at 20 and 30
    generations); serial, three times. The JAX engine's counts on the
    same run, its sec/gen estimate warmed first as the port's probe
    seeds the port's."""
    from timetabling_ga_tpu.obs import metrics as jmetrics
    from timetabling_ga_tpu.runtime import engine as jengine
    from timetabling_ga_tpu_torch.obs.metrics import REGISTRY
    jengine.run(JRunConfig(**dict(_RUN, input=tims["tiny"])),
                out=io.StringIO())
    for pipe, want in ((True, 2), (False, 3)):
        kw = dict(_RUN, input=tims["tiny"], pipeline=pipe,
                  checkpoint_every=1)
        c0 = jmetrics.REGISTRY.counter("engine.checkpoints").value
        jengine.run(JRunConfig(checkpoint=str(tmp_path / f"j{pipe}.npz"),
                               **kw), out=io.StringIO())
        j = jmetrics.REGISTRY.counter("engine.checkpoints").value - c0
        t0 = REGISTRY.counter("engine.checkpoints").value
        _, lines = _run(tims["tiny"], pipeline=pipe, checkpoint_every=1,
                        checkpoint=str(tmp_path / f"t{pipe}.npz"))
        t = REGISTRY.counter("engine.checkpoints").value - t0
        assert t == j == want == len(_phases(lines, "checkpoint"))


def test_host_copy_and_fetch_on_the_host():
    """On CPU tensors a HostCopy is the tensor itself, and the control
    read and the telemetry read give the same array."""
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    c = tdcore.HostCopy(x)
    assert c.event is None
    np.testing.assert_array_equal(c.wait(), x.numpy())
    np.testing.assert_array_equal(tdcore.fetch(c), tdcore.fetch_leaf(x))
    st = tengine.ga.PopState(x, x + 1, x[:, 0], x[:, 1], x[:, 2])
    slots, rooms, hcv, scv = tdcore.fetch_final(st, 3, 1)
    assert slots.shape == (3, 1, 4) and list(hcv) == [1, 5, 9]
    host = tdcore.fetch_state(st)
    np.testing.assert_array_equal(host.rooms, (x + 1).numpy())


def test_pipeline_discipline():
    """submit / drain / abandon, enabled and not."""
    seen = []
    pipe = tdcore.DispatchPipeline(
        lambda c, inflight=None: seen.append((c, inflight)), True)
    pipe.submit("a")
    pipe.submit("b")
    assert seen == [("a", "b")] and pipe.pending == "b"
    assert pipe.abandon() == "b" and pipe.pending is None
    pipe.submit("c")
    pipe.drain()
    pipe.enabled = False
    pipe.submit("d")
    assert seen == [("a", "b"), ("c", None), ("d", None)]
