"""The port's quality telemetry (`--quality`, the stall detector and the
auto-kick) against the JAX package's, on the CPU: the operator counters
of one generation (sweep, delta, full-evaluation and NSGA-II searches,
on a padded instance too), the migration gain and the diversity rows,
exact except the float32 moments (held within the stated tolerance);
the leaf layout helpers, the host decode, the stall detector and the
flags. tests/test_torch_quality_runs.py holds the sweep's counts, a
whole quality dispatch and the CLI runs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ga import _cfgs, _island_state
from tests.test_torch_moves import (  # noqa: F401  (fixtures)
    _population, arrays, jax_breed_draws, jax_ls_draws, jax_sweep_draws_fn,
    padded_problem, t32)
from timetabling_ga_tpu.obs import quality as jq
from timetabling_ga_tpu.ops import ga as jga
from timetabling_ga_tpu.parallel import islands as jisl
from timetabling_ga_tpu.runtime import config as jconfig
from timetabling_ga_tpu_torch.convert import pop_state_from_numpy
from timetabling_ga_tpu_torch.obs import quality as tq
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.parallel import islands as tisl
from timetabling_ga_tpu_torch.runtime import config as tconfig

torch.set_num_threads(1)

POP = 6

GEN_CASES = {
    "sweep": dict(),
    "sweep-padded": dict(),
    "delta": dict(ls_mode="random", ls_steps=4, ls_candidates=3, p3=0.3),
    "full-eval": dict(ls_mode="random", ls_steps=4, ls_candidates=3,
                      ls_delta=False, p3=0.3),
    "nsga2": dict(ls_sweeps=1, multi_objective=True),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generation_quality_counters_match_jax(case, small_problem,
                                               padded_problem):
    """One generation with the counters on: the same population as JAX's
    `generation(with_quality=True)` and the same (N_OPS,) counters, on
    the draws mirrored from the JAX key; the population also equals the
    run without the counters (nothing new is drawn)."""
    problem = padded_problem if case == "sweep-padded" else small_problem
    jpa, tpa = arrays(problem)
    jcfg, tcfg = _cfgs(**GEN_CASES[case])
    slots, rooms = _population(problem, POP, 11)
    jstate = jga.evaluate(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    key = jax.random.key(27)
    want, want_q = jax.jit(functools.partial(
        jga.generation, cfg=jcfg, with_quality=True))(jpa, key, jstate)
    draws = jax_breed_draws(key, POP, problem.n_events, problem.n_slots,
                            jcfg)
    k_ls = jax.random.fold_in(key, 0x15)
    if tcfg.ls_mode == "sweep":
        ls_fn = jax_sweep_draws_fn(k_ls, POP, problem.n_events,
                                   problem.n_slots, jcfg)
    else:
        ls = jax_ls_draws(k_ls, tcfg.ls_steps, tcfg.ls_candidates, POP,
                          problem.n_events, problem.n_slots, tcfg.p1,
                          tcfg.p2, tcfg.p3)
        ls_fn = lambda _i: ls  # noqa: E731
    state = pop_state_from_numpy(jstate)
    qacc = torch.zeros((1, tq.N_OPS), dtype=torch.int32)
    got = tga.generation(tpa, draws, ls_fn, state, tcfg, qacc=qacc)
    plain = tga.generation(tpa, draws, ls_fn, state, tcfg)
    for w, g, p in zip(want, got, plain):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        assert torch.equal(g, p)
    np.testing.assert_array_equal(np.asarray(want_q), qacc[0].numpy())
    q = qacc[0].numpy()
    assert q[0] > 0 and q[2] > 0
    if tcfg.ls_mode == "sweep":
        assert q[4:].sum() > 0
    else:
        assert (q[4:] == 0).all()


@pytest.mark.parametrize("L", [1, 2, 4])
@pytest.mark.parametrize("pop", [2, 3, 6])
def test_migrate_gain_matches_jax(L, pop):
    """migrate(return_gain) against `_migrate(return_gain=True)` under
    shard_map with L local islands: the same population and (L,) gain."""
    from jax.sharding import PartitionSpec as Pspec
    from timetabling_ga_tpu.compat import shard_map
    st = _island_state(L, pop, 3)
    # some islands feasible, some not: both reported-value domains
    hcv = np.asarray(st.hcv) * (np.arange(L * pop) % 3 != 0)
    st = st._replace(hcv=jnp.asarray(hcv.astype(np.int32)))
    spec = jga.PopState(*(Pspec(jisl.AXIS),) * 5)
    mig = jax.jit(functools.partial(
        shard_map, mesh=jisl.make_mesh(1), in_specs=(spec,),
        out_specs=(spec, Pspec(jisl.AXIS)))(
            lambda s: jisl._migrate(s, L, L=L, return_gain=True)))
    want, want_gain = mig(st)
    got, gain = tisl.migrate(pop_state_from_numpy(st), L, return_gain=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    np.testing.assert_array_equal(np.asarray(want_gain), gain.numpy())
    plain = tisl.migrate(pop_state_from_numpy(st), L)
    assert all(torch.equal(a, b) for a, b in zip(plain, got))


def test_migrate_gain_on_a_crafted_exchange():
    """JAX's hand-computed exchange (tests/test_quality.py): island 0
    (bests 100, 110, ...) takes island 1's 5 and 6 -> gain 95; island 1
    keeps its best -> gain 0."""
    scv = np.array([100, 110, 120, 130, 5, 6, 7, 8], np.int32)
    E = 4
    st = tga.PopState(t32(np.tile(np.arange(E), (8, 1))),
                      t32(np.zeros((8, E))), t32(scv), t32(np.zeros(8)),
                      t32(scv))
    out, gain = tisl.migrate(st, 2, return_gain=True)
    assert gain.tolist() == [95, 0]
    assert out.scv.tolist() == [5, 6, 100, 110, 5, 6, 100, 110]


def div_moments_close(got, want, x):
    """The stated tolerance of the diversity moments (float32 mean, var,
    min, max of float32 values x, JAX's min-shifted formula): min and
    max exact; the mean within a relative 1e-6 of the shifted mean plus
    one float32 spacing of the mean (the shift back rounds to it); the
    var within 4 n 2^-24 mean(c^2), c = x - min."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    x = np.asarray(x, np.float32).astype(np.float64)
    c = x - x.min()
    np.testing.assert_array_equal(got[2:], want[2:])
    tol = 1e-6 * abs(c.mean()) + float(np.spacing(np.abs(want[0])))
    assert abs(float(got[0]) - float(want[0])) <= tol, (got, want)
    tol = 4 * len(x) * 2.0 ** -24 * (c * c).mean()
    assert abs(float(got[1]) - float(want[1])) <= tol, (got, want)


def _div_case(E, L, pop, seed):
    """L islands of `pop` rows: slots with repeated rows (so pairs can
    agree), penalties mixing the feasible and the infeasible domains (up
    to ~9e6, past float32's 2^24), scv in a small range."""
    g = np.random.default_rng(seed)
    base = g.integers(0, 45, (L * pop, E))
    same = g.random((L * pop, E)) < 0.6
    slots = np.where(same, base[:1], base).astype(np.int32)
    hcv = g.integers(0, 9, L * pop) * (g.random(L * pop) < 0.5)
    scv = g.integers(0, 200, L * pop).astype(np.int32)
    pen = np.where(hcv > 0, 1_000_000 * hcv + scv + 7, scv).astype(np.int32)
    return slots, pen, scv


@pytest.mark.parametrize("pop", [1, 2, 3, 6, 33])
def test_div_stats_plain_matches_jax(pop, padded_problem):
    """div_stats_plain against `_div_stats` per island, on a padded
    instance's event_mask (padded events never count): min, max and the
    Hamming sample bit for bit, the moments within the stated
    tolerance."""
    jpa, tpa = arrays(padded_problem)
    E, L = padded_problem.n_events, 2
    slots, pen, scv = _div_case(E, L, pop, pop)
    got = tisl.div_stats_plain(tpa.event_mask, t32(slots), t32(pen),
                               t32(scv), L).numpy()
    assert got.shape == (L, tq.N_DIV)
    for i in range(L):
        r = slice(i * pop, (i + 1) * pop)
        want = np.asarray(jisl._div_stats(jpa.event_mask, slots[r], pen[r],
                                          scv[r]))
        np.testing.assert_array_equal(got[i, 8], want[8])
        gf, wf = got[i].view(np.float32), want.view(np.float32)
        div_moments_close(gf[:4], wf[:4], pen[r].astype(np.float32))
        div_moments_close(gf[4:8], wf[4:8], scv[r].astype(np.float32))
    assert tisl.hamming_stride(pop) == jisl._hamming_stride(pop)


def test_leaf_layout_matches_jax(monkeypatch):
    """trace_leaf_width, effective_trace_mode, split_quality and the
    compress_trace cap against JAX's: a quality-packed full trace is
    uncapped, a user's deltas trace keeps its cap."""
    for n in (1, 7, 100):
        for mode in ("full", "deltas", "stats"):
            for q in (False, True):
                assert tisl.effective_trace_mode(mode, q) == \
                    jisl.effective_trace_mode(mode, q)
                if mode != "full" or q:
                    assert tisl.trace_leaf_width(n, mode, q) == \
                        jisl.trace_leaf_width(n, mode, q)
    rows = np.arange(2 * 40, dtype=np.int32).reshape(2, 40)
    for q in (False, True):
        for a, b in zip(tisl.split_quality(rows, q),
                        jisl.split_quality(rows, q)):
            np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(jisl, "TRACE_DELTAS_CAP", 3)
    monkeypatch.setattr(tisl, "TRACE_DELTAS_CAP", 3)
    tr = np.stack([np.arange(9, 1, -1), np.zeros(8)],
                  axis=1)[None].astype(np.int32)
    for mode in ("deltas", "stats"):
        for cap in (None, 8):
            want = np.asarray(jisl._compress_trace(jnp.asarray(tr), None,
                                                   mode, cap=cap))
            got = tisl.compress_trace(t32(tr), mode, cap).numpy()
            np.testing.assert_array_equal(want, got)


def test_decode_aggregate_and_stall_detector_match_jax():
    assert (tq.N_GA, tq.N_SWEEP, tq.N_OPS, tq.N_MIG, tq.N_DIV,
            tq.QUALITY_WIDTH, tq.OFF_GA, tq.OFF_SWEEP, tq.OFF_MIG,
            tq.OFF_DIV, tq.HAMMING_PAIRS) == (
        jq.N_GA, jq.N_SWEEP, jq.N_OPS, jq.N_MIG, jq.N_DIV,
        jq.QUALITY_WIDTH, jq.OFF_GA, jq.OFF_SWEEP, jq.OFF_MIG,
        jq.OFF_DIV, jq.HAMMING_PAIRS)
    g = np.random.default_rng(4)
    rows = g.integers(0, 50, (3, tq.QUALITY_WIDTH)).astype(np.int32)
    rows[:, tq.OFF_DIV:] = g.random((3, tq.N_DIV)).astype(
        np.float32).view(np.int32)
    a, b = tq.decode_rows(rows), jq.decode_rows(rows)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert tq.aggregate(a) == jq.aggregate(b)
    assert tq.entry_payload(tq.aggregate(a), dispatch=3) == \
        jq.entry_payload(jq.aggregate(b), dispatch=3)
    with pytest.raises(ValueError):
        tq.decode_rows(rows[:, 1:])
    feed = [(100, 0.5), (100, 0.5), (100, 0.01), (100, 0.01), (90, 0.01),
            (90, 0.0), (90, 0.0), (90, 0.0)]
    for window in (0, 2, 3):
        det_t = tq.StallDetector(window, 0.05)
        det_j = jq.StallDetector(window, 0.05)
        for i, (best, ham) in enumerate(feed):
            assert det_t.update(best, ham) == det_j.update(best, ham)
            assert det_t.streak == det_j.streak
            if i == 6:
                det_t.reset()
                det_j.reset()
            assert det_t.stalled == det_j.stalled


@pytest.mark.parametrize("argv", [
    ["--auto-kick-on-stall"], ["--quality", "--stall-window", "-1"],
    ["--quality", "--stall-hamming", "1.5"]])
def test_quality_flag_validation_matches_jax(argv):
    msgs = []
    for mod in (jconfig, tconfig):
        with pytest.raises(SystemExit) as e:
            mod.parse_args(["-i", "x.tim"] + argv)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "not yet ported" not in msgs[1]


def test_quality_flags_parse_as_jax():
    argv = ["-i", "x.tim", "--quality", "--stall-window", "3",
            "--stall-hamming", "0.2", "--auto-kick-on-stall"]
    j, t = jconfig.parse_args(argv), tconfig.parse_args(argv)
    for f in ("quality", "stall_window", "stall_hamming",
              "auto_kick_on_stall"):
        assert getattr(j, f) == getattr(t, f)
    d = tconfig.parse_args(["-i", "x.tim"])
    dj = jconfig.parse_args(["-i", "x.tim"])
    assert (d.quality, d.stall_window, d.stall_hamming,
            d.auto_kick_on_stall) == (dj.quality, dj.stall_window,
                                      dj.stall_hamming,
                                      dj.auto_kick_on_stall)
    for flag in ("--quality", "--stall-window", "--stall-hamming",
                 "--auto-kick-on-stall"):
        assert flag in tconfig._FLAG_MAP or flag in tconfig._BOOL_FLAGS
