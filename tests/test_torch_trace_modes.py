"""`--trace-mode deltas|stats` in the port (parallel/islands.py
compress_trace / trace_events / moment rows, runtime/engine.py's decode)
against the JAX package's `_compress_trace`, `trace_events` and
`_moment_rows`, and the contract that the three modes give one record
stream.

Tolerances (float32 moments; the reduction orders of XLA, the plain
version and kernel K13 differ): events, counts, pass counts and record
streams exact; min and max exact, mean within a relative 1e-6, var
within 4 n 2^-24 mean(rep^2) (`moments_close`)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels import _trace, moments_close
from timetabling_ga_tpu.parallel import islands as jisl
from timetabling_ga_tpu.problem import dump_tim
from timetabling_ga_tpu_torch import cli as tcli
from timetabling_ga_tpu_torch.obs.metrics import REGISTRY
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.ops import lahc as tlahc
from timetabling_ga_tpu_torch.parallel import islands as tisl
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl

torch.set_num_threads(1)

BASE = ["-s", "3", "--backend", "cpu", "-t", "300", "--no-auto-tune",
        "--ls-mode", "sweep", "--ls-sweeps", "1", "--pop-size", "6",
        "--islands", "2", "--migration-period", "4", "--trace"]


@pytest.fixture
def both_caps(monkeypatch):
    def set_cap(k):
        monkeypatch.setattr(jisl, "TRACE_DELTAS_CAP", k)
        monkeypatch.setattr(tisl, "TRACE_DELTAS_CAP", k)
    return set_cap


@pytest.mark.parametrize("L,T", [(1, 1), (2, 8), (3, 33), (4, 64),
                                 (2, 200), (1, 1000)])
@pytest.mark.parametrize("cap", [1, 3, 64, 5000])
def test_compress_trace_plain_equals_jax(both_caps, L, T, cap):
    """Ties, long runs of equal rows, sentinel rows, overflow (K below
    the count), T = 1 and T not a multiple of 32; every row valid."""
    both_caps(cap)
    tr = _trace(L, T, 31 * T + cap, "cpu")
    K = min(T, cap)
    for mode in ("deltas", "stats"):
        want = np.asarray(jisl._compress_trace(jnp.asarray(tr.numpy()),
                                               None, mode))
        got = tisl.compress_trace_plain(tr, mode).numpy()
        assert got.shape == want.shape == (
            L, jisl.trace_leaf_width(T, mode))
        np.testing.assert_array_equal(got[:, :3 * K + 1],
                                      want[:, :3 * K + 1])
        if mode == "stats":
            rep = tisl.reported_f32(tr[..., 0], tr[..., 1]).numpy()
            moments_close(got[:, 3 * K + 1:].view(np.float32),
                          want[:, 3 * K + 1:].view(np.float32), rep)


def test_the_traces_overflow_and_tie():
    """The grid above reaches what it is for: overflow at the small caps,
    sentinel rows, and ties (equal rows that are not improvements)."""
    tr = _trace(2, 200, 31 * 200 + 3, "cpu")
    leaf = tisl.compress_trace_plain(tr, "deltas").numpy()
    assert (leaf[:, -1] > 3).all()
    t = tr.numpy()
    assert (t[..., 0] == tisl.SENTINEL).any()
    assert (np.diff(t, axis=1) == 0).all(-1).any()


@pytest.mark.parametrize("mode", ["full", "deltas", "stats"])
def test_trace_events_equals_jax(both_caps, mode):
    both_caps(4)
    tr = _trace(3, 40, 5, "cpu")
    leaf = tr.numpy() if mode == "full" else np.asarray(
        jisl._compress_trace(jnp.asarray(tr.numpy()), None, mode))
    want = jisl.trace_events(leaf, mode)
    got = tisl.trace_events(leaf, mode)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_moment_rows_plain_equals_jax():
    tr = _trace(4, 50, 9, "cpu")
    h, s = tr[..., 0], tr[..., 1]
    want = np.asarray(jisl._moment_rows(
        jisl._reported_f32(jnp.asarray(h.numpy()), jnp.asarray(s.numpy())),
        axis=1))
    got = tisl.moment_rows_plain(h, s).numpy()
    rep = tisl.reported_f32(h, s).numpy()
    moments_close(got.view(np.float32).T, want.view(np.float32).T, rep)
    # the flat form the polish takes (axis None): one row of all values
    flat = np.asarray(jisl._moment_rows(jisl._reported_f32(
        jnp.asarray(h.numpy().ravel()), jnp.asarray(s.numpy().ravel()))))
    got = tisl.moment_rows_plain(h.reshape(1, -1), s.reshape(1, -1))
    moments_close(got.numpy().view(np.float32).T,
                  flat.view(np.float32)[None], rep.reshape(1, -1))


def _gens(n, seed):
    return [torch.Generator().manual_seed(seed + i) for i in range(n)]


def test_polish_stats_rows(small_problem):
    """with_passes appends the pass count and the polished population's
    moments (JAX make_polish_runner's layout: (3 + 1 + 4, L * pop)) and
    leaves the trajectory as it was."""
    pa = load_tim(dump_tim(small_problem)).device_arrays("cpu")
    cfg = tga.GAConfig(pop_size=4, ls_mode="sweep", ls_sweeps=1)
    state = tisl.init_island_population(pa, _gens(2, 1), 4)
    st0, plain = tisl.polish(pa, _gens(2, 5), state, cfg, 3)
    st1, rows = tisl.polish(pa, _gens(2, 5), state, cfg, 3,
                            with_passes=True)
    assert rows.shape == (8, 8)
    assert all(torch.equal(a, b) for a, b in zip(st0, st1))
    assert torch.equal(rows[:3], plain)
    passes = rows[3].unique()
    assert passes.numel() == 1 and 1 <= int(passes) <= 3
    want = np.asarray(jisl._moment_rows(jisl._reported_f32(
        jnp.asarray(st1.hcv.numpy()), jnp.asarray(st1.scv.numpy()))))
    got = rows[4:].numpy().view(np.float32)
    assert (got == got[:, :1]).all()
    moments_close(got[:, 0][None], want.view(np.float32)[None],
                  tisl.reported_f32(st1.hcv, st1.scv).numpy()[None])


def test_lahc_stats_rows(small_problem):
    """with_moments appends each island's walkers' moments (JAX
    make_lahc_runners: (3 + 4, L)); the walk is the same."""
    pa = load_tim(dump_tim(small_problem)).device_arrays("cpu")
    cfg = tga.GAConfig(pop_size=3, ls_mode="sweep")
    state = tisl.init_island_population(pa, _gens(2, 2), 3)
    outs = []
    for wm in (False, True):
        ls = tlahc.init_lahc(pa, state.slots, state.rooms, 5)
        outs.append(tisl.lahc_run(pa, _gens(2, 7), ls, cfg, 6, 2,
                                  with_moments=wm))
    (l0, s0), (l1, s1) = outs
    assert s1.shape == (7, 2) and torch.equal(s1[:3], s0)
    assert torch.equal(l0.best_pen, l1.best_pen)
    bh, bs = l1.best_hcv.reshape(2, 3), l1.best_scv.reshape(2, 3)
    want = np.asarray(jisl._moment_rows(jisl._reported_f32(
        jnp.asarray(bh.numpy()), jnp.asarray(bs.numpy())), axis=1))
    moments_close(s1[3:].numpy().view(np.float32).T,
                  want.view(np.float32).T,
                  tisl.reported_f32(bh, bs).numpy())


@pytest.fixture(scope="module")
def tim(tmp_path_factory, small_problem):
    path = tmp_path_factory.mktemp("tm") / "small.tim"
    path.write_text(dump_tim(small_problem))
    return str(path)


def _run(tim, argv, capsys):
    assert tcli.main(["-i", tim] + BASE + argv) == 0
    out = capsys.readouterr()
    return [json.loads(x) for x in out.out.splitlines()], out.err


@pytest.mark.parametrize("argv", [
    ["--generations", "12"],
    # the initial polish, the post phase's switch and a kick
    ["--generations", "8", "--init-sweeps", "2", "--post-sweeps", "2",
     "--kick-stall", "1"]])
def test_deltas_and_stats_streams_equal_full(tim, capsys, argv):
    full, _ = _run(tim, argv, capsys)
    assert any("logEntry" in r for r in full)
    for mode in ("deltas", "stats"):
        recs, _ = _run(tim, argv + ["--trace-mode", mode], capsys)
        assert tjsonl.strip_timing(recs) == tjsonl.strip_timing(full), mode


def test_stats_mode_sets_the_gauges(tim, capsys):
    REGISTRY.reset()
    _run(tim, ["--generations", "8", "--init-sweeps", "2", "--trace-mode",
               "stats"], capsys)
    g = REGISTRY.snapshot()["gauges"]
    for name in ("engine.trace_best_mean", "engine.trace_best_min",
                 "engine.trace_best_max", "engine.polish_best_mean",
                 "engine.polish_best_min", "engine.polish_best_max"):
        assert name in g, name
    assert g["engine.trace_best_min"] <= g["engine.trace_best_mean"] <= \
        g["engine.trace_best_max"]
    assert 1 <= g["engine.polish_passes"] <= 2


def test_overflow_is_counted_and_warned_once(tim, capsys, monkeypatch):
    monkeypatch.setattr(tisl, "TRACE_DELTAS_CAP", 1)
    before = REGISTRY.counter("engine.trace_delta_overflow").value
    recs, err = _run(tim, ["--generations", "12", "--trace-mode",
                           "deltas"], capsys)
    dropped = REGISTRY.counter("engine.trace_delta_overflow").value - before
    assert dropped > 0
    assert err.count("--trace-mode deltas dropped") == 1
    assert "raise TT_TRACE_DELTAS_CAP" in err
    logs = [r["logEntry"]["best"] for r in recs if "logEntry" in r]
    assert logs
