"""The serve path's telemetry in the port: `serve --trace-mode
deltas|stats` and `serve --quality` (B13's remaining device forms, K13's
and K14's lane forms) against the JAX package on the CPU.

  - compress_trace with an (L,) n_valid against JAX `_compress_trace(
    trace, n_valid, mode, cap)`: deltas and stats, cap None and T,
    counts 0, T and between;
  - div_stats with a mask row a lane against `jax.vmap(_div_stats)` over
    three padded lanes of one bucket;
  - the lane generation with quality against `jga.generation(...,
    with_quality=True)` on mirrored draws (each lane's counters and
    rows, bit for bit);
  - lane_run's quality block under drop-out: counts (5, 0, 3, 5), each
    lane's leaf and block equal to that lane run alone, the idle lane's
    counters zero and its moments (0, 0, +inf, -inf);
  - the port's serve record stream under --trace-mode deltas, stats and
    --quality equal to full's under strip_timing, and the quality.*
    family names equal to JAX's on the same request file; an event cap
    below the improvements counts serve.trace_delta_overflow.

Tolerances: events, counts, counters and the Hamming sample exact;
trace moments as tests/test_torch_kernels.py `masked_moments_close`
(min and max exact, mean within a relative 1e-6, var within 4 n 2^-24
mean(rep^2), n a lane's valid count; an empty lane's moments exact);
diversity moments as `div_moments_close`.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels import (
    _trace, div_case, div_moments_close, lane_counts, lane_masks,
    masked_moments_close)
from tests.test_torch_moves import jax_breed_draws, jax_ls_draws
from tests.test_torch_serve_lanes import (  # noqa: F401  (fixture)
    CHUNK, K, POP, ROUNDS, _cat_breed, _jax_state, _lane_state, lanes)
from timetabling_ga_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
from timetabling_ga_tpu.ops import ga as jga
from timetabling_ga_tpu.parallel import islands as jisl
from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.runtime import config as jconfig
from timetabling_ga_tpu.serve.service import serve_stream as jax_serve
from timetabling_ga_tpu_torch.convert import pop_state_from_numpy
from timetabling_ga_tpu_torch.obs import quality as tq
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
from timetabling_ga_tpu_torch.ops import delta
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.parallel import islands as tisl
from timetabling_ga_tpu_torch.problem import LaneProblems
from timetabling_ga_tpu_torch.runtime import config as tconfig
from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
from timetabling_ga_tpu_torch.serve.service import serve_stream

torch.set_num_threads(1)


@pytest.fixture
def both_caps(monkeypatch):
    def set_cap(k):
        monkeypatch.setattr(jisl, "TRACE_DELTAS_CAP", k)
        monkeypatch.setattr(tisl, "TRACE_DELTAS_CAP", k)
    return set_cap


# ------------------------------------------------- K13's lane form

@pytest.mark.parametrize("L,T", [(1, 1), (3, 8), (4, 33), (2, 64),
                                 (3, 200)])
@pytest.mark.parametrize("cap", [2, 64])
def test_compress_trace_lanes_plain_equals_jax(both_caps, L, T, cap):
    """Every lane's leaf against JAX's per-lane valid mask, with the
    user's cap (overflow at 2) and uncapped (K = T, a quality-packed
    full trace); a lane with count 0 and one with count T."""
    both_caps(cap)
    tr = _trace(L, T, 17 * T + cap, "cpu")
    nv = lane_counts(L, T, T + cap)
    rep = tisl.reported_f32(tr[..., 0], tr[..., 1]).numpy()
    for mode in ("deltas", "stats"):
        for c in (None, T):
            K = min(T, cap if c is None else c)
            want = np.asarray(jisl._compress_trace(
                jnp.asarray(tr.numpy()), jnp.asarray(nv), mode, cap=c))
            got = tisl.compress_trace_plain(tr, mode, c,
                                            torch.from_numpy(nv)).numpy()
            assert got.shape == want.shape
            np.testing.assert_array_equal(got[:, :3 * K + 1],
                                          want[:, :3 * K + 1])
            if mode == "stats":
                masked_moments_close(got[:, 3 * K + 1:].view(np.float32),
                                     want[:, 3 * K + 1:].view(np.float32),
                                     rep, nv)
    assert nv[0] == 0 and (L == 1 or nv[-1] == T)


def test_the_lane_counts_mask_improvements():
    """Rows past a lane's count are not improvements even when they
    would be: a falling trace cut at 3 of 8 rows ships 3 events."""
    tr = torch.stack([torch.zeros(8, dtype=torch.int32),
                      torch.arange(80, 0, -10, dtype=torch.int32)],
                     -1)[None].repeat(2, 1, 1)
    nv = torch.tensor([3, 8], dtype=torch.int32)
    leaf = tisl.compress_trace_plain(tr, "deltas", 8, nv).numpy()
    assert leaf[:, -1].tolist() == [3, 8]
    events, counts, _ = tisl.trace_events(leaf, "deltas")
    assert [len(e) for e in events] == [3, 8]


# ------------------------------------------------- K14's lane form

def test_div_stats_lanes_plain_equals_jax_vmap(lanes):
    """div_stats over three padded lanes of one bucket, each under its
    own event mask, against JAX's vmap of `_div_stats` over the lanes'
    masks: the Hamming sample bit for bit, the moments within the stated
    tolerance; the masks differ from lane to lane."""
    padded, jpas, lp = lanes
    E, L = padded[0].n_events, len(lp)
    masks = np.stack([np.asarray(j.event_mask) for j in jpas])
    assert len({m.sum() for m in masks}) == L
    for pop in (1, 2, 5, 33):
        slots, pen, scv = (x.numpy() for x in div_case(E, L, pop, pop))
        want = np.asarray(jax.vmap(jisl._div_stats)(
            jnp.asarray(masks), slots.reshape(L, pop, E),
            pen.reshape(L, pop), scv.reshape(L, pop)))
        state = tga.PopState(*(torch.from_numpy(x) for x in (
            slots, slots, pen, pen, scv)))
        got = tisl.div_stats(lp, state, L).numpy()
        np.testing.assert_array_equal(got[:, 8], want[:, 8])
        for i in range(L):
            r = slice(i * pop, (i + 1) * pop)
            gf, wf = got[i].view(np.float32), want[i].view(np.float32)
            div_moments_close(gf[:4], wf[:4], pen[r].astype(np.float32))
            div_moments_close(gf[4:8], wf[4:8], scv[r].astype(np.float32))


def test_div_stats_lane_masks_stack_once(lanes):
    _, _, lp = lanes
    m = lp.event_masks
    assert m.shape == (len(lp), lp.n_events) and m is lp.event_masks
    assert torch.equal(m[1], lp.pas[1].event_mask)
    masks = lane_masks(3, 30, 4)
    slots, pen, scv = div_case(30, 3, 4, 6)
    rows = tisl.div_stats_plain(masks, slots, pen, scv, 3)
    for i in range(3):
        r = slice(i * 4, (i + 1) * 4)
        assert torch.equal(rows[i], tisl.div_stats_plain(
            masks[i], slots[r], pen[r], scv[r], 1)[0])


# ------------------------------------------- the lane generation, quality

def test_lane_generation_with_quality_matches_jax(lanes):
    """`jga.generation(..., with_quality=True)` a lane, on its padded
    problem with its mirrored draws, against the port's generation over
    the three lanes with an (L, N_OPS) accumulator: each lane's rows and
    operator counters bit for bit."""
    padded, jpas, lp = lanes
    jcfg = jga.GAConfig(pop_size=POP, ls_steps=ROUNDS, ls_candidates=K)
    tcfg = tga.GAConfig(pop_size=POP, ls_steps=ROUNDS, ls_candidates=K)
    E, T = padded[0].n_events, padded[0].n_slots
    gen = jax.jit(jga.generation, static_argnums=(3,),
                  static_argnames=("with_quality",))
    want, wq, states, breed, ls = [], [], [], [], []
    for lane, (p, jpa) in enumerate(zip(padded, jpas)):
        st = _jax_state(p, jpa, 50 + lane)
        states.append(st)
        k = jax.random.fold_in(jax.random.fold_in(
            jax.random.key(17 + lane), CHUNK), 1)
        w, q = gen(jpa, k, st, jcfg, with_quality=True)
        want.append(w)
        wq.append(np.asarray(q))
        breed.append(jax_breed_draws(k, POP, E, T, jcfg))
        ls.append(jax_ls_draws(jax.random.fold_in(k, 0x15), ROUNDS, K, POP,
                               E, T))
    draws = _cat_breed(breed)
    ls_draws = delta.LSDraws(*(torch.cat([d[i] for d in ls], 2)
                               for i in range(3)))
    state = tga.PopState(*(torch.cat(x) for x in zip(
        *(pop_state_from_numpy(st) for st in states))))
    qacc = torch.zeros((len(lp), tq.N_OPS), dtype=torch.int32)
    got = tga.generation(lp, draws, lambda _i: ls_draws, state, tcfg,
                         groups=len(lp), qacc=qacc)
    for f, name in enumerate(tga.PopState._fields):
        w = np.concatenate([np.asarray(x[f]) for x in want])
        np.testing.assert_array_equal(w, got[f].numpy(), err_msg=name)
    np.testing.assert_array_equal(qacc.numpy(), np.stack(wq))
    assert qacc[:, 0].sum() > 0          # crossovers were attempted


# ------------------------------------------------- lane_run, dropping out

def _improvements(events):
    """The strict lexicographic improvements of a lane's full-trace
    events, from the sentinel."""
    best, out = (tisl.SENTINEL, tisl.SENTINEL), []
    for g, h, s in events:
        if (h, s) < best:
            best = (h, s)
            out.append((g, h, s))
    return out


@pytest.mark.parametrize("mode", ["full", "deltas", "stats"])
def test_lane_run_quality_under_drop_out(lanes, mode):
    """Counts (5, 0, 3, 5) on four lanes (the fourth on the first lane's
    problem): each lane's leaf and quality block equal that lane run
    alone; the idle lane counts nothing, ships no event and, in stats
    mode, the exact empty moments; the event leaf decodes to the events
    of the full trace."""
    _, _, lp3 = lanes
    lp = LaneProblems(lp3.pas + [lp3.pas[0]])
    cfg = tga.GAConfig(pop_size=POP, ls_steps=ROUNDS, ls_candidates=K)
    counts = [5, 0, 3, 5]
    seeds = [3, 4, 5, 6]
    state = _lane_state(lp, 70)

    def rngs(which):
        return [tisl.lane_generator("cpu", seeds[i], 0)
                if counts[i] else None for i in which]

    out, leaf = tisl.lane_run(lp, rngs(range(4)), state, counts, cfg, 5,
                              trace_mode=mode, quality=True)
    _, full = tisl.lane_run(lp, rngs(range(4)), state, counts, cfg, 5)
    leaf = leaf.numpy()
    assert leaf.shape == (4, tisl.trace_leaf_width(5, mode, True))
    ev_leaf, q = tisl.split_quality(leaf, True)
    ev_mode = tisl.effective_trace_mode(mode, True)
    assert tisl.trace_events(ev_leaf, ev_mode)[0] == [
        _improvements(lane_ev)
        for lane_ev in tisl.trace_events(full.numpy(), "full")[0]]
    dec = tq.decode_rows(q)
    assert dec["crossover_attempts"][1] == 0
    assert all(dec[k][1] == 0 for k in ("mutation_attempts",
                                        "crossover_wins"))
    assert (dec["migration_gain"] == 0).all()
    assert ev_leaf[1, -1 - (4 if ev_mode == "stats" else 0)] == 0
    if ev_mode == "stats":
        np.testing.assert_array_equal(
            ev_leaf[1, -4:], np.array([0, 0, np.inf, -np.inf],
                                      np.float32).view(np.int32))
    for lane in range(4):
        rows = slice(lane * POP, (lane + 1) * POP)
        alone_state, alone = tisl.lane_run(
            lp.select([lane]), rngs([lane]),
            tga.PopState(*(x[rows] for x in state)), [counts[lane]], cfg,
            5, trace_mode=mode, quality=True)
        np.testing.assert_array_equal(leaf[lane], alone.numpy()[0])
        for x, y in zip(out, alone_state):
            assert torch.equal(x[rows], y)
    assert dec["crossover_attempts"][0] > dec["crossover_attempts"][2] > 0


# ------------------------------------------------- the serve stream

_ARGV = ["--backend", "cpu", "--lanes", "4", "--quantum", "3",
         "--pop-size", "4", "-m", "8"]


def _requests():
    """Three jobs of the (32, 4, 4, 32) bucket and one of the next
    (round-robin; different budgets, so lanes drop out mid-quantum)."""
    tims = [dump_tim(random_instance(30 + i, n_events=n, n_rooms=r,
                                     n_features=3, n_students=s,
                                     attend_prob=0.12))
            for i, (n, r, s) in enumerate([(20, 3, 16), (28, 4, 24),
                                           (32, 4, 30), (45, 4, 30)])]
    return [json.dumps({"submit": {"id": f"q{i}", "tim": t, "seed": i,
                                   "generations": 7 + 2 * i}})
            for i, t in enumerate(tims)] + [json.dumps({"drain": True})]


def _run_port(extra):
    reg = MetricsRegistry()
    out = io.StringIO()
    serve_stream(tconfig.parse_serve_args(_ARGV + list(extra)),
                 io.StringIO("\n".join(_requests())), out, registry=reg)
    return [json.loads(x) for x in out.getvalue().splitlines()], reg


@pytest.fixture(scope="module")
def full_stream():
    return _run_port([])


@pytest.mark.parametrize("extra", [
    ["--trace-mode", "deltas"], ["--trace-mode", "stats"], ["--quality"],
    ["--quality", "--trace-mode", "deltas"],
    ["--quality", "--trace-mode", "stats"]])
def test_serve_streams_equal_full(full_stream, extra):
    """The record stream is the same in every trace mode, with and
    without quality; quality counts each job's generations' operators
    and sets the diversity gauges."""
    full, _ = full_stream
    recs, reg = _run_port(extra)
    assert strip_timing(recs) == strip_timing(full)
    assert sum(1 for r in recs if "logEntry" in r) > 4
    snap = reg.snapshot()
    quality = "--quality" in extra
    assert ("quality.ops.crossover_attempts" in snap["counters"]) == quality
    if quality:
        assert snap["counters"]["quality.ops.crossover_attempts"] > 0
        assert snap["counters"]["quality.migration.gain"] == 0
        assert 0.0 <= snap["gauges"]["quality.diversity.hamming_min"] <= 1.0


def test_serve_quality_names_match_jax():
    """The quality.* counters and gauges the port's serve path sets are
    the ones JAX's sets on the same request file."""
    lines = _requests()[:2] + [json.dumps({"drain": True})]
    jax_serve(jconfig.parse_serve_args(
        ["--backend", "cpu", "--lanes", "4", "--quantum", "3",
         "--pop-size", "4", "-m", "8", "--mesh-devices", "1",
         "--no-usage", "--quality"]),
        io.StringIO("\n".join(lines)), io.StringIO())
    jsnap = JAX_REGISTRY.snapshot()
    reg = MetricsRegistry()
    serve_stream(tconfig.parse_serve_args(_ARGV + ["--quality"]),
                 io.StringIO("\n".join(lines)), io.StringIO(),
                 registry=reg)
    tsnap = reg.snapshot()
    for kind in ("counters", "gauges"):
        want = {k for k in jsnap[kind] if k.startswith("quality.")}
        got = {k for k in tsnap[kind] if k.startswith("quality.")}
        assert got == want and got, kind


def test_serve_event_overflow_is_counted(monkeypatch, full_stream):
    """A deltas cap of 1 ships each quantum's last improvement only: the
    dropped ones count serve.trace_delta_overflow, and each job's
    logEntry values are a subsequence of full's ending at its best."""
    monkeypatch.setattr(tisl, "TRACE_DELTAS_CAP", 1)
    recs, reg = _run_port(["--trace-mode", "deltas"])
    assert reg.snapshot()["counters"]["serve.trace_delta_overflow"] > 0
    full, _ = full_stream
    for jid in ("q0", "q1", "q2", "q3"):
        def logs(rs):
            return [r["logEntry"]["best"] for r in rs
                    if "logEntry" in r and r["logEntry"]["job"] == jid]
        got, want = logs(recs), logs(full)
        assert set(got) <= set(want) and got[-1] == want[-1], jid
