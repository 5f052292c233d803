"""The port's quality telemetry in motion, on the CPU: the sweep's
accepted-move counts against JAX's `return_ops` (converged groups count
nothing more), one quality dispatch's packed block, and CLI runs whose
record streams are the same with `--quality` on and off, and whose stall
fixture writes the stall record and, with `--auto-kick-on-stall`, the
kick record, counting `engine.kicks`."""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_ga import _cfgs
from tests.test_torch_moves import (
    _population, arrays, jax_sweep_draws_fn, t32)
from timetabling_ga_tpu.ops import sweep as jsweep
from timetabling_ga_tpu.problem import dump_tim
from timetabling_ga_tpu_torch import cli as tcli
from timetabling_ga_tpu_torch.obs import quality as tq
from timetabling_ga_tpu_torch.obs.metrics import REGISTRY
from timetabling_ga_tpu_torch.ops import sweep as tsweep
from timetabling_ga_tpu_torch.ops.sweep import SweepDraws
from timetabling_ga_tpu_torch.parallel import islands as tisl
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl

torch.set_num_threads(1)

POP = 6


def _cat_draws(a: SweepDraws, b: SweepDraws) -> SweepDraws:
    """The draws of two row groups side by side (tie noise and allow are
    (n_steps, P, ...))."""
    def cat(x, y, dim):
        return None if x is None else torch.cat([x, y], dim)
    return SweepDraws(cat(a.a, b.a, 0), cat(a.b, b.b, 0),
                      cat(a.hot_noise, b.hot_noise, 0),
                      cat(a.tie_noise, b.tie_noise, 1),
                      cat(a.allow, b.allow, 1))


def test_sweep_return_ops_matches_jax(small_problem):
    """sweep_local_search's per-row accepted Move1/Move2/Move3 counts,
    summed, equal JAX's return_ops in fixed-pass and converge modes; with
    two groups that converge after different passes, each group's counts
    equal JAX's for that group alone (a converged group counts nothing
    more), and the rows equal the run without the counts."""
    jpa, tpa = arrays(small_problem)
    E, T = small_problem.n_events, small_problem.n_slots
    # sideways moves: a converged group would still accept some
    jcfg, tcfg = _cfgs(p3=0.3, ls_hot_k=0)
    kw = dict(swap_block=tcfg.ls_swap_block, hot_k=tcfg.ls_hot_k,
              p3=tcfg.p3, sideways=tcfg.ls_sideways)
    slots, rooms = _population(small_problem, POP, 21)
    keys = [jax.random.key(50), jax.random.key(51)]
    _, _, want = jsweep.jit_sweep_local_search(
        jpa, keys[0], slots, rooms, 2, return_ops=True, **kw)
    _, _, got = tsweep.sweep_local_search(
        tpa, jax_sweep_draws_fn(keys[0], POP, E, T, jcfg), t32(slots),
        t32(rooms), 2, return_ops=True, **kw)
    np.testing.assert_array_equal(np.asarray(want), got.sum(0).numpy())

    def jax_converge(key, s, r):
        return jsweep.jit_sweep_local_search(
            jpa, key, s, r, 6, converge=True, return_passes=True,
            return_ops=True, **kw)
    # group B starts from group A's rows after a converge search: it
    # converges after fewer passes
    s_b, r_b, _, _ = jax_converge(keys[1], slots, rooms)
    s_b, r_b = np.asarray(s_b), np.asarray(r_b)
    want, passes = [], []
    for g, (s, r) in enumerate(((slots, rooms), (s_b, r_b))):
        _, _, n, ops = jax_converge(keys[g], s, r)
        want.append(np.asarray(ops))
        passes.append(int(n))
    assert passes[0] != passes[1]
    fns = [jax_sweep_draws_fn(k, POP, E, T, jcfg) for k in keys]
    both = [t32(np.concatenate(x)) for x in ((slots, s_b), (rooms, r_b))]
    got_s, _, got = tsweep.sweep_local_search(
        tpa, lambda i: _cat_draws(fns[0](i), fns[1](i)), *both, 6,
        converge=True, groups=2, return_ops=True, **kw)
    np.testing.assert_array_equal(
        np.stack(want), got.reshape(2, POP, 3).sum(1).numpy())
    plain_s, _ = tsweep.sweep_local_search(
        tpa, lambda i: _cat_draws(fns[0](i), fns[1](i)), *both, 6,
        converge=True, groups=2, **kw)
    assert torch.equal(got_s, plain_s)


def test_run_epochs_quality_block(small_problem):
    """One quality dispatch: its event leaf decodes as a deltas leaf with
    every improvement of the full trace, its diversity rows are
    div_stats of the final population, its counters are bounded by what
    it bred, and the population equals the run without quality."""
    _, tpa = arrays(small_problem)
    _, tcfg = _cfgs(ls_mode="random", ls_steps=2, ls_candidates=3)
    L = 2
    out = {}
    for q in (False, True):
        gens = [torch.Generator().manual_seed(i) for i in range(L)]
        st = tisl.init_island_population(tpa, gens, POP)
        out[q] = tisl.run_epochs(tpa, gens, st, tcfg, 2, 3, "full", q)
    (st0, tr0), (st1, tr1) = out[False], out[True]
    assert all(torch.equal(a, b) for a, b in zip(st0, st1))
    assert tr1.shape == (L, tisl.trace_leaf_width(6, "full", True))
    ev_leaf, qrows = tisl.split_quality(tr1.numpy(), True)
    ev, counts, _ = tisl.trace_events(ev_leaf, "deltas")
    full_ev = tisl.trace_events(tr0.numpy(), "full")[0]
    for i in range(L):
        best, imp = (tisl.SENTINEL, tisl.SENTINEL), []
        for g, h, s in full_ev[i]:
            if (h, s) < best:
                best = (h, s)
                imp.append((g, h, s))
        assert ev[i] == imp and counts[i] == len(imp)
    np.testing.assert_array_equal(
        qrows[:, tq.OFF_DIV:], tisl.div_stats(tpa, st1, L).numpy())
    dec = tq.decode_rows(qrows)
    assert (dec["crossover_attempts"] <= 6 * POP).all()
    assert (dec["crossover_wins"] <= dec["crossover_attempts"]).all()
    assert (dec["mutation_wins"] <= dec["mutation_attempts"]).all()
    assert (dec["migration_gain"] >= 0).all()


# ------------------------------------------------------------- CLI runs

FAST = ["-s", "5", "--backend", "cpu", "-t", "300", "--no-auto-tune",
        "-m", "8", "--pop-size", "8", "--islands", "2",
        "--migration-period", "4", "--generations", "40", "--trace"]
SWEEP = ["-s", "3", "--backend", "cpu", "-t", "300", "--no-auto-tune",
         "--ls-mode", "sweep", "--ls-sweeps", "1", "--init-sweeps", "1",
         "--pop-size", "4", "--islands", "2", "--migration-period", "2",
         "--generations", "6", "--ls-swap-block", "3", "--trace"]
STALL = ["--quality", "--stall-window", "2", "--stall-hamming", "1.0"]


@pytest.fixture(scope="module")
def tim_path(tmp_path_factory, small_problem):
    path = tmp_path_factory.mktemp("tim") / "small.tim"
    path.write_text(dump_tim(small_problem))
    return str(path)


def _run(tim_path, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(["-i", tim_path] + argv) == 0
    return [json.loads(x) for x in buf.getvalue().splitlines()]


def _faults(records, action):
    return [r["faultEntry"] for r in records if "faultEntry" in r
            and r["faultEntry"]["action"] == action]


@pytest.mark.parametrize("flags,mode", [(FAST, "full"), (FAST, "deltas"),
                                        (SWEEP, "full")])
def test_quality_on_and_off_give_the_same_stream(tim_path, flags, mode):
    """--quality changes what the leaf carries, never the run: the record
    streams are equal under strip_timing (a quality-packed full trace
    keeps every improvement), and the counters reached the registry."""
    argv = flags + ["--trace-mode", mode]
    off = _run(tim_path, argv)
    before = REGISTRY.counter("quality.ops.crossover_attempts").value
    on = _run(tim_path, argv + ["--quality"])
    assert tjsonl.strip_timing(on) == tjsonl.strip_timing(off)
    assert REGISTRY.counter("quality.ops.crossover_attempts").value > before
    assert 0.0 <= REGISTRY.gauge("quality.diversity.hamming_min").value <= 1


def test_stall_detector_writes_a_stall_and_keeps_the_stream(tim_path):
    off = _run(tim_path, FAST)
    on = _run(tim_path, FAST + STALL)
    assert tjsonl.strip_timing(on) == tjsonl.strip_timing(off)
    stalls = _faults(on, "stall")
    assert stalls and stalls[0]["site"] == "quality"
    assert stalls[0]["streak"] >= 2 and "hamming" in stalls[0]
    assert stalls[0]["recovery"] == 0 and stalls[0]["level"] == 0
    assert not _faults(on, "kick")


def test_auto_kick_on_stall_kicks_and_counts(tim_path):
    before = REGISTRY.counter("engine.kicks").value
    recs = _run(tim_path, FAST + STALL + ["--auto-kick-on-stall"])
    stalls, kicks = _faults(recs, "stall"), _faults(recs, "kick")
    assert stalls and kicks and kicks[0]["moves"] >= 3
    assert kicks[0]["site"] == "quality"
    # the escalating depth of the shared kick routine
    assert [k["moves"] for k in kicks][:2] in ([3], [3, 6])
    kick_phases = [r["phase"] for r in recs if "phase" in r
                   and r["phase"]["name"] == "kick"]
    assert len(kick_phases) == len(kicks)
    assert REGISTRY.counter("engine.kicks").value - before == len(kicks)
    assert REGISTRY.gauge("engine.stalled").value in (0.0, 1.0)


