"""The CUDA kernels K1-K14 against their plain PyTorch versions.

This file imports neither JAX nor the JAX package and needs no conftest
fixture, so it also runs on a machine with the card but without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

The `cuda` tests skip where there is no CUDA device (the kernels have
no CPU mode); the rest check, on any machine, the kernel build's
bookkeeping and that a CPU tensor takes the plain version.
"""

import ctypes
import dataclasses
import os

import numpy as np
import pytest
import torch

from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import (
    delta, fitness, ga, lahc, local_search, moves, nsga, rooms, sweep)
from timetabling_ga_tpu_torch.parallel import islands
from timetabling_ga_tpu_torch.problem import (
    LaneProblems, derive, itc_like_instance, load_tim_file,
    make_problem_arrays, random_instance)

COMP01S = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures", "comp01s.tim")

torch.set_num_threads(1)


def padded_arrays(problem, n_pad_events=5, n_pad_rooms=2, device="cpu"):
    """ProblemArrays of `problem` padded with masked-out events and rooms
    (zero attendance and capacity, suitable nowhere)."""
    E, R = problem.n_events, problem.n_rooms
    Ep, Rp = E + n_pad_events, R + n_pad_rooms
    attends = np.zeros((problem.n_students, Ep), np.int8)
    attends[:, :E] = problem.attends
    feats = np.zeros((Ep, problem.n_features), np.int8)
    feats[:E] = problem.event_features
    room_feats = np.zeros((Rp, problem.n_features), np.int8)
    room_feats[:R] = problem.room_features
    size = np.zeros(Rp, np.int32)
    size[:R] = problem.room_size
    p = derive(Ep, Rp, problem.n_features, problem.n_students, size,
               attends, room_feats, feats)
    possible = np.array(p.possible)
    possible[E:, :] = False
    possible[:, R:] = False
    return make_problem_arrays(
        attends=p.attends, conflict=p.conflict, possible=possible,
        student_count=p.student_count, room_size=p.room_size,
        event_mask=(np.arange(Ep) < E).astype(np.float32),
        room_mask=np.arange(Rp) < R, anchor_slots=np.zeros(Ep, np.int32),
        anchor_w=np.zeros(Ep, np.int32), n_days=5, slots_per_day=9,
        device=device)


def _instances(device):
    comp = itc_like_instance(3, n_events=120, n_rooms=6, n_students=80)
    medium = random_instance(2, n_events=80, n_rooms=8, n_features=5,
                             n_students=60, attend_prob=0.08)
    anchored = make_problem_arrays(
        **{k: getattr(comp.device_arrays(), k).numpy() for k in (
            "attends", "conflict", "possible", "student_count",
            "room_size", "event_mask", "room_mask")},
        anchor_slots=np.arange(120, dtype=np.int32) % 45,
        anchor_w=np.arange(120, dtype=np.int32) % 3, n_days=5,
        slots_per_day=9, device=device)
    return [comp.device_arrays(device), medium.device_arrays(device),
            padded_arrays(medium, device=device), anchored]


def _one_room(device):
    """A 40-event instance with one room, unsuitable for every third
    event."""
    p = random_instance(6, n_events=40, n_rooms=1, n_features=2,
                        n_students=30, attend_prob=0.1).device_arrays()
    possible = p.possible.numpy().copy()
    possible[::3] = False
    return make_problem_arrays(
        **{k: getattr(p, k).numpy() for k in (
            "attends", "conflict", "student_count", "room_size",
            "event_mask", "room_mask")},
        possible=possible, anchor_slots=np.zeros(40, np.int32),
        anchor_w=np.zeros(40, np.int32), n_days=5, slots_per_day=9,
        device=device)


def _matching_instances(device):
    """The greedy matcher's degenerate cases: a 120-event instance, one
    room (R = 1), and padded events and rooms."""
    comp = itc_like_instance(3, n_events=120, n_rooms=6, n_students=80)
    medium = random_instance(2, n_events=80, n_rooms=8, n_features=5,
                             n_students=60, attend_prob=0.08)
    return [comp.device_arrays(device), _one_room(device),
            padded_arrays(medium, device=device)]


def _degenerate_slots(pa, P, seed):
    """(P, E) slots with degenerate slot buckets: row 0 every event in
    the last slot, row 1 every event in slot 0 or the last (the rest
    empty), row 2 half the events in slot 3; the others random."""
    g = torch.Generator(device=pa.device).manual_seed(seed)
    slots = torch.randint(0, pa.n_slots, (P, pa.n_events), generator=g,
                          device=pa.device, dtype=torch.int32)
    last = pa.n_slots - 1
    slots[0] = last
    slots[1] = torch.where(slots[1] % 2 == 0, 0, last)
    slots[2, :pa.n_events // 2] = 3
    return slots


def _state(pa, P, seed):
    g = torch.Generator(device=pa.device).manual_seed(seed)
    slots = torch.randint(0, pa.n_slots, (P, pa.n_events), generator=g,
                          device=pa.device, dtype=torch.int32)
    return delta.init_state(pa, slots, rooms.assign_rooms_plain(pa, slots))


def _breed_case(pa, device, groups, pop, seed, slots=None):
    """(pop, cfg, parents, draws) of one breeding: parents with random
    rooms (not their slots' matching, so a child without crossover shows
    whether it kept parent A's rooms) and (penalty, scv) in {0, 1, 2}^2,
    so tournaments tie; crossover on for even children, mutation off for
    every third. Random parent slots unless `slots` are given."""
    P = groups * pop
    st = _state(pa, P, seed)
    if slots is not None:
        st = st._replace(slots=slots)
    g = torch.Generator(device=device).manual_seed(seed)
    rms = torch.randint(0, pa.n_rooms, st.rooms.shape, generator=g,
                        device=device, dtype=torch.int32)
    tie = torch.randint(0, 3, (2, P), generator=g, device=device,
                        dtype=torch.int32)
    par = ga.PopState(st.slots, rms, tie[0], tie[0] + 5, tie[1])
    cfg = ga.GAConfig(pop_size=pop, p3=0.4)
    draws = ga.make_breed_draws([g] * groups, pop, pa.n_events, pa.n_slots,
                                cfg, device)
    i = torch.arange(P, device=device)
    draws = draws._replace(do_x=i % 2 == 0, do_m=i % 3 != 0)
    return pop, cfg, par, draws


def _island_state(L, pop, seed, device="cpu", E=7):
    """L islands of `pop` sorted rows with (penalty, scv) in {0, 1, 2}^2."""
    g = torch.Generator(device=device).manual_seed(seed)
    ps = torch.randint(0, 3, (2, L, pop), generator=g, device=device,
                       dtype=torch.int32)
    st = ga.survivors_plain(ga.PopState(
        *(torch.zeros((L * pop, E), dtype=torch.int32, device=device),) * 2,
        ps[0].reshape(-1), ps[0].reshape(-1) * 2,
        ps[1].reshape(-1)), groups=L)
    rows = torch.arange(L * pop, dtype=torch.int32, device=device)
    slots = rows[:, None] * 10 + torch.arange(E, dtype=torch.int32,
                                              device=device)
    return st._replace(slots=slots, rooms=slots + seed)


def _lane_problems(n_lanes, device="cpu"):
    """LaneProblems of `n_lanes` (1 to 4) different instances of the
    (32, 4, 4, 32) bucket, padded by serve.bucket: a full-size lane with
    the group's largest event (max_ev_students), a small lane padded in
    events and rooms with the shortest CSR, an anchored lane padded in
    events, and an ITC-like lane padded in events."""
    from timetabling_ga_tpu_torch.serve.bucket import pad_problem
    full = random_instance(11, n_events=32, n_rooms=4, n_features=4,
                           n_students=32, attend_prob=0.3)
    small = random_instance(12, n_events=20, n_rooms=3, n_features=2,
                            n_students=12, attend_prob=0.08)
    itc = itc_like_instance(13, n_events=27, n_rooms=4, n_features=4,
                            n_students=24)
    rng = np.random.default_rng(14)
    anchored = dataclasses.replace(
        random_instance(14, n_events=30, n_rooms=4, n_features=3,
                        n_students=28, attend_prob=0.15),
        anchor_slots=rng.integers(0, 45, 30).astype(np.int32),
        anchor_w=rng.integers(0, 4, 30).astype(np.int32))
    pas = [pad_problem(p).device_arrays(device)
           for p in (full, small, anchored, itc)[:n_lanes]]
    return LaneProblems(pas)


def _lane_case(lp, device, pop, seed):
    """(cfg, parents, breed draws, LS rows, LS draws) of a lane dispatch:
    each lane's parents random slots with random rooms and tied
    (penalty, scv), its LS rows scored on its own problem."""
    L = len(lp)
    g = torch.Generator(device=device).manual_seed(seed)
    parts = [_state(pa, pop, seed + i) for i, pa in enumerate(lp.pas)]
    slots = torch.cat([st.slots for st in parts])
    rms = torch.randint(0, lp.n_rooms, slots.shape, generator=g,
                        device=device, dtype=torch.int32)
    tie = torch.randint(0, 3, (2, L * pop), generator=g, device=device,
                        dtype=torch.int32)
    par = ga.PopState(slots, rms, tie[0], tie[0] + 5, tie[1])
    cfg = ga.GAConfig(pop_size=pop, p3=0.4)
    draws = ga.make_breed_draws([g] * L, pop, lp.n_events, lp.n_slots, cfg,
                                device)
    i = torch.arange(L * pop, device=device)
    draws = draws._replace(do_x=i % 2 == 0, do_m=i % 3 != 0)
    rows = delta.LSRows(*(torch.cat(x) for x in zip(*(
        delta.init_rows(pa, st.slots, st.rooms)
        for pa, st in zip(lp.pas, parts)))))
    ls = delta.make_ls_draws([g], L * pop, 3, 4, lp.n_events, lp.n_slots,
                             1.0, 1.0, 0.5, device)
    return cfg, par, draws, rows, ls


def k6_lanes_equal_plain(lp, cfg, par, draws, mo=None, rooms_mode="scan"):
    """K6 with the lane table against its lane-looped plain version, the
    children and their base parents; returns the children."""
    got, gp = ga.make_children_kernel(lp, draws, par, len(lp), mo,
                                      rooms_mode, with_parent=True)
    want, wp = ga.make_children_lanes_plain(
        lp, draws, par, dataclasses.replace(cfg, rooms_mode=rooms_mode),
        mo, with_parent=True)
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    assert torch.equal(wp, gp)
    return got


def k8_lanes_equal_plain(lp, ls, rows):
    """K8 with the lane table against its lane-looped plain version."""
    got = delta.random_local_search_kernel(lp, ls, rows)
    want = delta.random_ls_lanes_plain(lp, ls, rows)
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    return got


def _ls_draws(pa, device, P, n_rounds, K, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return delta.make_ls_draws([g], P, n_rounds, K, pa.n_events, pa.n_slots,
                               1.0, 1.0, 0.5, device)


# K11's edge cases: (islands, rows an island, objectives, row width E,
# the rows' offset in ints into their buffers). Island sizes 33, 64 and
# 70 take two or three dominator words (66-140 with the children);
# "chain" is a strict chain in shuffled row order (every row its own
# front), "equal" one front with every range 0 (taken as 1); E = 7 and
# rows off 16 bytes take the 4-byte copy, E = 8 aligned the 16-byte one.
K11_CASES = [(1, 33, "random", 7, 0), (2, 64, "random", 8, 1),
             (1, 70, "random", 8, 0), (1, 40, "chain", 7, 0),
             (2, 20, "chain", 8, 2), (2, 12, "equal", 8, 0),
             (3, 5, "random", 7, 3)]


def _k11_island(L, pop, kind, seed, base=0, E=7, offset=0, device="cpu"):
    """L islands of `pop` rows for K11 with objectives `kind` ("random":
    hcv in 0..4 and scv in 0..11, so duplicates and shared fronts are
    common; "chain": hcv = base + a permutation, scv = 2 hcv; "equal"),
    penalties in few values (the kept order ties), and distinct rows of
    E int32 starting `offset` ints into their buffers."""
    g = torch.Generator().manual_seed(seed)
    n = L * pop
    if kind == "random":
        hcv = torch.randint(0, 5, (n,), generator=g)
        scv = torch.randint(0, 12, (n,), generator=g)
    elif kind == "chain":
        hcv = torch.randperm(n, generator=g) + base
        scv = 2 * hcv
    else:
        hcv, scv = torch.full((n,), 3), torch.full((n,), 7)
    buf = torch.arange(2 * (offset + n * E), dtype=torch.int32) + 1000 * seed

    def rows(k):
        start = k * (offset + n * E) + offset
        return buf[start:start + n * E].view(n, E).to(device)
    i32 = dict(dtype=torch.int32, device=device)
    return ga.PopState(rows(0), rows(1), (hcv % 3 + scv % 2).to(**i32),
                       hcv.to(**i32), scv.to(**i32))


def _k11_equal_plain(case, device, seed=0):
    """K11's two entries against their plain versions on `case` (a
    K11_CASES entry): ranks, and crowding as float32 bits, of the
    parents; survivors of parents + children at keep = pop, 1 and all."""
    L, pop, kind, E, offset = case
    par = _k11_island(L, pop, kind, seed + 1, 0, E, offset, device)
    ch = _k11_island(L, pop, kind, seed + 2, L * pop, E, offset, device)
    got = nsga.rank_crowd_kernel(par.hcv, par.scv, L)
    want = nsga.rank_crowd_plain(par.hcv, par.scv, L)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    for keep in (pop, 1, 2 * pop):
        got = nsga.survivors_kernel(par, ch, L, keep)
        want = nsga.survivors_plain(par, ch, L, keep)
        assert all(torch.equal(w, x) for w, x in zip(want, got))
    return want


def _wide_rooms(device):
    """A 60-event instance with 32 rooms: a suitability word's every
    bit."""
    return random_instance(8, n_events=60, n_rooms=32, n_features=3,
                           n_students=40, attend_prob=0.1).device_arrays(
                               device)


def _chained_augments(device, shift=0):
    """(pa, slots, rooms, want) of a slot where a second round of
    length-3 augments follows a round that grabbed no free room: rooms
    0-4 of capacity ranks 0-4; event 0 suits {0, 3}, event 1 {1, 4},
    event 2 {0}, event 3 {0, 1}, all in slot 0, from rooms (0, 1, 0, 0).
    Round 1: events 2 and 3 find no free room; both bid for room 0 (its
    owner 0 can move to 3), event 2 wins. Round 2: event 3 evicts event
    1 (to 4) from room 1. With `shift`, `shift` smaller rooms that suit
    no event come first, and every room and rank above is `shift` more
    (at 32, the whole matching lies in the second word of ranks)."""
    possible = np.zeros((4, shift + 5), dtype=bool)
    possible[:, shift:] = [[1, 0, 0, 1, 0], [0, 1, 0, 0, 1],
                           [1, 0, 0, 0, 0], [1, 1, 0, 0, 0]]
    pa = make_problem_arrays(
        attends=np.zeros((1, 4), np.float32),
        conflict=np.zeros((4, 4), np.float32), possible=possible,
        student_count=np.zeros(4, np.int32),
        room_size=np.r_[np.ones(shift), np.arange(2, 7)].astype(np.int32),
        event_mask=np.ones(4, np.float32),
        room_mask=np.ones(shift + 5, bool),
        anchor_slots=np.zeros(4, np.int32), anchor_w=np.zeros(4, np.int32),
        n_days=5, slots_per_day=9, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return (pa, torch.zeros((1, 4), **i32),
            torch.tensor([[0, 1, 0, 0]], **i32) + shift,
            torch.tensor([[3, 4, 0, 1]], **i32) + shift)


def _matcher_equals_plain(pa, device, seed):
    """K9 (augment_rooms from random rooms at 0, 1 and 4 rounds, and
    parallel_assign_rooms) and K6's parallel matcher (crossover on for
    every child, off for every child, and mixed) against their plain
    versions on degenerate slot buckets (`_degenerate_slots`: a slot
    with every event, more than 32)."""
    slots = _degenerate_slots(pa, 4, seed)
    g = torch.Generator(device=device).manual_seed(seed)
    rms = torch.randint(0, pa.n_rooms, slots.shape, generator=g,
                        device=device, dtype=torch.int32)
    for n in (0, 1, 4):
        assert torch.equal(rooms.augment_rooms_kernel(pa, slots, rms, n),
                           rooms.augment_rooms_plain(pa, slots, rms, n))
    assert torch.equal(rooms.augment_rooms_kernel(pa, slots, None),
                       rooms.augment_rooms_plain(
                           pa, slots, rooms.best_fit_rooms(pa, 4)))
    _, _, par, draws = _breed_case(pa, device, 1, 4, seed + 1, slots)
    cfg = ga.GAConfig(pop_size=4, p3=0.4, rooms_mode="parallel")
    for do_x in (True, False, None):
        d = draws if do_x is None else draws._replace(
            do_x=torch.full_like(draws.do_x, do_x))
        got = ga.make_children_kernel(pa, d, par, 1, None, "parallel")
        want = ga.make_children_plain(pa, d, par, cfg, 1)
        assert all(torch.equal(w, x) for w, x in zip(want, got))


# rooms past one warp: each lane of a room choice takes rooms l, l + 32,
# ..., and the parallel matcher's ranks are two or three words an event
WIDE_R = (33, 80)


def _past_one_warp(R, device):
    """A 40-event instance of R rooms, room sizes drawn so that events of
    many students fit only the larger rooms: a matching reaches ranks 32
    and beyond, and ties fall across a lane's rooms."""
    return random_instance(40 + R, n_events=40, n_rooms=R, n_features=3,
                           n_students=30, attend_prob=0.1).device_arrays(
                               device)


def k1_k6_wide_equal_plain(pa, device, seed):
    """K1 on degenerate slot buckets (a slot of every event: two chunks
    of 32), K6 in its greedy and crowded modes and its relocation entry,
    against their plain versions."""
    slots = _degenerate_slots(pa, 4, seed)
    assert torch.equal(rooms.assign_rooms_kernel(pa, slots),
                       rooms.assign_rooms_plain(pa, slots))
    _, cfg, par, draws = _breed_case(pa, device, 2, 3, seed + 1)
    mo = nsga.rank_crowd_plain(par.hcv, par.scv, 2)
    for stats in (None, mo):
        got = ga.make_children_kernel(pa, draws, par, 2, stats)
        want = ga.make_children_plain(pa, draws, par, cfg, 2, stats)
        assert all(torch.equal(w, g) for w, g in zip(want, got))
    st = _state(pa, 6, seed + 2)
    g = torch.Generator(device=device).manual_seed(seed + 3)
    d = moves.make_move_draws([g] * 3, 6, pa.n_events, pa.n_slots, 1.0,
                              1.0, 1.0, device)
    chain = moves.MoveDraws(*(x.reshape((3, 6) + x.shape[1:]) for x in d))
    got = moves.relocation_chain_kernel(pa, chain, st.slots, st.rooms, 3)
    want = moves.relocation_chain_plain(pa, chain, st.slots, st.rooms, 3)
    assert all(torch.equal(w, g) for w, g in zip(want, got))


def k4_wide_equal_plain(pa, device, seed, k4=None):
    """K4's own launch on sampled candidates against delta_one_plain;
    `k4(pa, state, evs, new_slots, active)` launches it (None: the
    delta_one wrapper, which launches it on a CUDA tensor)."""
    P, C = 3, 9
    st = _state(pa, P, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    d = moves.make_move_draws([g], P * C, pa.n_events, pa.n_slots, 1.0,
                              1.0, 1.0, device)
    evs, ns, act = moves.sample_move(pa, d,
                                     st.slots.repeat_interleave(C, 0))
    evs, ns, act = (x.reshape(P, C, 3) for x in (evs, ns, act))
    got = (k4 or (lambda pa, st, *m: delta.delta_one(
        pa, st.slots, st.rooms, st.att, st.occ, *m)))(pa, st, evs, ns, act)
    want = delta.delta_one_plain(pa, st.slots, st.rooms, st.att, st.occ,
                                 evs, ns, act)
    assert all(torch.equal(w, x) for w, x in zip(want, got))


def k8_k12_wide_equal_plain(pa, device, seed, K=4, cluster=None):
    """K8 (pre-pass and chain) and K12 (from the pre-pass) against their
    plain versions, rows and penalty terms."""
    rows = delta.init_rows(pa, *_state(pa, 3, seed)[:2])
    draws = _ls_draws(pa, device, 3, 3, K, seed + 1)
    got = delta.random_local_search_kernel(pa, draws, rows)
    want = delta.random_local_search_plain(pa, draws, rows)
    assert all(torch.equal(w, x) for w, x in zip(want, got))
    got = local_search.batch_local_search_kernel(pa, draws, rows, cluster)
    want = local_search.batch_local_search_plain(pa, draws, rows)
    assert all(torch.equal(w, x) for w, x in zip(want, got))


def k10_wide_equal_plain(pa, device, seed, k_cands=4, Lh=3):
    """K8's pre-pass and K10 on a copy of a start state against
    lahc_steps_plain, every field."""
    st = _state(pa, 3, seed)
    ls0 = lahc.init_lahc(pa, st.slots, st.rooms, Lh)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    draws = lahc.make_lahc_draws([g], 3, 5, k_cands, pa.n_events,
                                 pa.n_slots, 1.0, 1.0, 0.5, device)
    ls1 = lahc.LahcState(lahc.LSState(*(x.clone() for x in ls0.ls)),
                         *(x.clone() for x in ls0[1:]))
    got = lahc.lahc_steps_kernel(pa, draws, ls1)
    want = lahc.lahc_steps_plain(pa, draws, ls0)
    assert all(torch.equal(w, x) for w, x in zip(want.ls, got.ls))
    assert all(torch.equal(w, x) for w, x in zip(want[1:], got[1:]))


# K13's shapes: islands, trace lengths (T not a multiple of 32 too) and
# event caps below, equal to and above the improvement counts
K13_L = (1, 4, 16)
K13_T = (1, 8, 33, 64, 200, 1000)
K13_CAPS = (1, 3, 64, 5000)


def _trace(L, T, seed, device):
    """(L, T, 2) int32 per-generation (hcv, scv) traces with planted ties
    and long runs of equal rows: a falling staircase with repeats,
    rows equal to an earlier best, a few sentinel rows and random
    rows."""
    g = np.random.default_rng(seed)
    h = np.maximum(0, 6 - np.cumsum(g.random((L, T)) < 0.05, 1))
    s = np.maximum(0, 400 - np.cumsum(g.integers(0, 3, (L, T)), 1))
    run = g.random((L, T)) < 0.5          # long runs: repeat the last row
    for t in range(1, T):
        h[:, t] = np.where(run[:, t], h[:, t - 1], h[:, t])
        s[:, t] = np.where(run[:, t], s[:, t - 1], s[:, t])
    wild = g.random((L, T)) < 0.1
    h = np.where(wild, g.integers(0, 9, (L, T)), h)
    s = np.where(wild, g.integers(0, 900, (L, T)), s)
    sent = g.random((L, T)) < 0.02
    h = np.where(sent, islands.SENTINEL, h)
    s = np.where(sent & (g.random((L, T)) < 0.5), islands.SENTINEL, s)
    return torch.tensor(np.stack([h, s], -1), dtype=torch.int32,
                        device=device)


def moments_close(got, want, rep):
    """The stated tolerance of K13's moments against the plain version
    (and of the plain version against JAX): min and max exact, mean
    within a relative 1e-6, var within 4 n 2^-24 mean(rep^2), where n
    values `rep` (..., n) gave each row of (..., 4) float32 moments."""
    got = np.asarray(got, np.float32).reshape(-1, 4)
    want = np.asarray(want, np.float32).reshape(-1, 4)
    rep = np.asarray(rep, np.float64).reshape(got.shape[0], -1)
    n = rep.shape[1]
    np.testing.assert_array_equal(got[:, 2:], want[:, 2:])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6, atol=0)
    tol = 4 * n * 2.0 ** -24 * (rep * rep).mean(1)
    assert (np.abs(got[:, 1].astype(np.float64) - want[:, 1]) <= tol).all()


def k13_equals_plain(trace, mode):
    """compress_trace's kernel against its plain version on one trace:
    events and counts exactly, the moments (stats) within the stated
    tolerance. Returns the plain leaf."""
    got = islands.compress_trace_kernel(trace, mode).cpu().numpy()
    want = islands.compress_trace_plain(trace, mode).cpu().numpy()
    assert got.shape == want.shape
    K = min(trace.shape[1], islands.TRACE_DELTAS_CAP)
    np.testing.assert_array_equal(got[:, :3 * K + 1], want[:, :3 * K + 1])
    if mode == "stats":
        t = trace.cpu()
        rep = islands.reported_f32(t[..., 0], t[..., 1]).numpy()
        moments_close(got[:, 3 * K + 1:].view(np.float32),
                      want[:, 3 * K + 1:].view(np.float32), rep)
    return want


def masked_moments_close(got, want, rep, n_valid):
    """moments_close on each island's first n_valid[l] values (n their
    count); an island with none has (0, 0, +inf, -inf) in both, bit for
    bit."""
    got = np.asarray(got, np.float32).reshape(-1, 4)
    want = np.asarray(want, np.float32).reshape(-1, 4)
    rep = np.asarray(rep, np.float64).reshape(got.shape[0], -1)
    empty = np.array([0, 0, np.inf, -np.inf], np.float32).view(np.int32)
    for lane, n in enumerate(n_valid):
        if n == 0:
            np.testing.assert_array_equal(got[lane].view(np.int32), empty)
            np.testing.assert_array_equal(want[lane].view(np.int32), empty)
        else:
            moments_close(got[lane:lane + 1], want[lane:lane + 1],
                          rep[lane:lane + 1, :n])


def lane_counts(L, T, seed):
    """(L,) valid counts of a lane trace: 0, T and values between."""
    g = np.random.default_rng(seed)
    nv = g.integers(0, T + 1, L)
    nv[0] = 0
    if L > 1:
        nv[-1] = T
    return nv.astype(np.int32)


def k13_lanes_equal_plain(trace, mode, n_valid, cap=None):
    """compress_trace's lane form (an (L,) n_valid) against its plain
    version: events and counts exactly, the moments over each lane's
    valid rows within the stated tolerance. Returns the plain leaf."""
    nv = torch.tensor(np.asarray(n_valid), dtype=torch.int32,
                      device=trace.device)
    kernels.reset_launches()
    got = islands.compress_trace_kernel(trace, mode, cap, nv).cpu().numpy()
    assert kernels.LAUNCHES["compress_trace_lanes"] == 1
    assert kernels.LAUNCHES["compress_trace"] == 0
    want = islands.compress_trace_plain(trace, mode, cap, nv).cpu().numpy()
    assert got.shape == want.shape
    T = trace.shape[1]
    K = min(T, islands.TRACE_DELTAS_CAP if cap is None else cap)
    np.testing.assert_array_equal(got[:, :3 * K + 1], want[:, :3 * K + 1])
    if mode == "stats":
        t = trace.cpu()
        rep = islands.reported_f32(t[..., 0], t[..., 1]).numpy()
        masked_moments_close(got[:, 3 * K + 1:].view(np.float32),
                             want[:, 3 * K + 1:].view(np.float32), rep,
                             np.asarray(n_valid))
    return want


def lane_masks(L, E, seed, device="cpu"):
    """(L, E) float32 event masks of lanes padded to E events: each a
    live prefix of its own length (one lane every event, one a single
    event), as a bucket's padded problems have."""
    g = np.random.default_rng(seed)
    live = g.integers(1, E + 1, L)
    live[0] = E
    if L > 1:
        live[1] = 1
    m = (np.arange(E)[None, :] < live[:, None]).astype(np.float32)
    return torch.tensor(m, device=device)


def k14_div_lanes_equal_plain(masks, L, pop, seed):
    """K14's div_stats lane form (a mask row a lane) against its plain
    version: min, max and the Hamming sample exactly, the moments within
    the stated tolerance; and each lane's row equal to the shared-mask
    form on that lane alone. Returns the plain rows."""
    E = masks.shape[1]
    slots, pen, scv = div_case(E, L, pop, seed, masks.device)
    kernels.reset_launches()
    got = islands.div_stats_kernel(masks, slots, pen, scv, L).cpu().numpy()
    assert kernels.LAUNCHES["div_stats_lanes"] == 1
    assert kernels.LAUNCHES["div_stats"] == 0
    want = islands.div_stats_plain(masks, slots, pen, scv, L).cpu().numpy()
    assert got.shape == want.shape == (L, 9)
    np.testing.assert_array_equal(got[:, 8], want[:, 8])
    for i in range(L):
        r = slice(i * pop, (i + 1) * pop)
        gf, wf = got[i].view(np.float32), want[i].view(np.float32)
        div_moments_close(gf[:4], wf[:4], pen[r].cpu().float().numpy())
        div_moments_close(gf[4:8], wf[4:8], scv[r].cpu().float().numpy())
        one = islands.div_stats_plain(masks[i], slots[r], pen[r], scv[r],
                                      1).cpu().numpy()
        np.testing.assert_array_equal(want[i], one[0])
    return want


def moment_rows_equal_plain(hcv, scv):
    got = islands.moment_rows_kernel(hcv, scv).cpu().numpy()
    want = islands.moment_rows_plain(hcv, scv).cpu().numpy()
    rep = islands.reported_f32(hcv.cpu(), scv.cpu()).numpy()
    moments_close(got.view(np.float32).T, want.view(np.float32).T, rep)


# ----------------------------------------------------------- the quality
# telemetry: K14's two entries and the new outputs of K5, K6 and K7, with
# their helpers shared by the card tests below and the CPU stand-in
# (tests/test_torch_cuda_emu.py), which calls the *_kernel wrappers.


def k5_ops_equal_plain(pa, st, draws, case, clusters=(None,)):
    """K5 with its move counts on, added to a given ops_in: the counts
    equal sweep_pass_plain's, every other output equals the pass with
    them off (kernel and plain). Returns the pass's counts."""
    P, dev = st.slots.shape[0], st.slots.device
    g = torch.Generator(device=dev).manual_seed(P)
    ops0 = torch.randint(0, 4, (P, 3), generator=g, device=dev,
                         dtype=torch.int32)
    want = sweep.sweep_pass_plain(pa, draws, st, *case, ops=ops0)
    off = sweep.sweep_pass_plain(pa, draws, st, *case)
    assert all(torch.equal(w, o) for w, o in zip(want[0], off[0]))
    assert torch.equal(want[1], off[1])
    for cs in clusters:
        got = sweep.sweep_pass_kernel(pa, draws, st, *case, cluster=cs,
                                      ops=ops0)
        ref = sweep.sweep_pass_kernel(pa, draws, st, *case, cluster=cs)
        assert len(got) == 4 and len(ref) == 3
        for w, g2, r in zip(want[0], got[0], ref[0]):
            assert torch.equal(w, g2) and torch.equal(r, g2), f"cluster {cs}"
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
        assert torch.equal(got[3], want[2]), f"cluster {cs}"
    return want[2] - ops0


K6_MODES = ("greedy", "crowded", "parallel")


def k6_parents_equal_plain(pa, device, seed, mode,
                           shapes=((1, 16), (3, 5))):
    """K6 with its base parents on, in one tournament and matching mode,
    at each (islands, pop) of `shapes`: the parents equal
    make_children_plain's (tournament A's winners), the children and
    their scores equal the breeding with them off."""
    for groups, pop in shapes:
        _, cfg, par, draws = _breed_case(pa, device, groups, pop, seed)
        mo = (nsga.rank_crowd_plain(par.hcv, par.scv, groups)
              if mode == "crowded" else None)
        rm = "parallel" if mode == "parallel" else "scan"
        cfg = dataclasses.replace(cfg, rooms_mode=rm,
                                  multi_objective=mo is not None)
        got, parent = ga.make_children_kernel(pa, draws, par, groups, mo,
                                              rm, with_parent=True)
        off = ga.make_children_kernel(pa, draws, par, groups, mo, rm)
        want, want_parent = ga.make_children_plain(
            pa, draws, par, cfg, groups, mo, with_parent=True)
        assert all(torch.equal(w, g) and torch.equal(o, g)
                   for w, g, o in zip(want, got, off))
        assert torch.equal(parent, want_parent)
        assert (parent // pop == torch.arange(
            groups * pop, device=device) // pop).all()


def _gain_state(L, pop, E, device):
    """_island_state with island l's penalties raised by 3 (L - 1 - l)
    and hcv = penalty (feasible where 0), so every island but the last
    takes a better second-best from its next neighbour."""
    st = _island_state(L, pop, 1, device, E)
    isl = torch.arange(L * pop, device=device) // pop
    pen = (st.penalty + 3 * (L - 1 - isl)).to(torch.int32)
    return st._replace(penalty=pen, hcv=pen.clone())


def k7_gain_equal_plain(L, pop, E, device):
    """K7's migrate with its gain on: the population equals the exchange
    with it off, the gain migrate_plain's. Returns the gain."""
    st = _gain_state(L, pop, E, device)
    got, gain = islands.migrate_kernel(st, L, return_gain=True)
    off = islands.migrate_kernel(st, L)
    want, want_gain = islands.migrate_plain(st, L, return_gain=True)
    assert all(torch.equal(w, g) and torch.equal(o, g)
               for w, g, o in zip(want, got, off))
    assert torch.equal(gain, want_gain)
    return gain


def _quality_ops_case(L, pop, seed, device, with_sweep=True):
    """One generation's flags and scores for K14's quality_ops: parents
    drawn within each island, penalties in a small range (ties are no
    win), an accumulator already holding counts."""
    g = torch.Generator(device=device).manual_seed(seed)
    P = L * pop
    i32 = torch.int32

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=device,
                             dtype=i32)
    base = torch.arange(P, device=device, dtype=i32) // pop * pop
    return dict(
        do_x=torch.rand(P, generator=g, device=device) < 0.6,
        do_m=torch.rand(P, generator=g, device=device) < 0.5,
        parent=(base + ints(pop, (P,))).to(i32),
        child_pen=ints(5, (P,)), parent_pen=ints(5, (P,)),
        sweep_ops=ints(40, (P, 3)) if with_sweep else None,
        acc=ints(100, (L, 7)), L=L)


def k14_ops_equal_plain(L, pop, seed, device, with_sweep=True):
    """K14's quality_ops against its plain version, exactly."""
    case = _quality_ops_case(L, pop, seed, device, with_sweep)
    want = ga.quality_ops_plain(**{**case, "acc": case["acc"].clone()})
    got = ga.quality_ops_kernel(**{**case, "acc": case["acc"].clone()})
    assert torch.equal(want, got)
    return want - case["acc"]


def div_case(E, L, pop, seed, device="cpu"):
    """(slots, penalty, scv) of L islands of `pop` rows: slots with
    repeated values (so pairs can agree), penalties mixing the feasible
    and the infeasible domains (to ~9e6, past float32's 2^24), scv in a
    small range."""
    g = np.random.default_rng(seed)
    base = g.integers(0, 45, (L * pop, E))
    same = g.random((L * pop, E)) < 0.6
    slots = np.where(same, base[:1], base).astype(np.int32)
    hcv = g.integers(0, 9, L * pop) * (g.random(L * pop) < 0.5)
    scv = g.integers(0, 200, L * pop).astype(np.int32)
    pen = np.where(hcv > 0, 1_000_000 * hcv + scv + 7, scv).astype(np.int32)
    return tuple(torch.tensor(x, device=device) for x in (slots, pen, scv))


def div_moments_close(got, want, x):
    """The stated tolerance of the diversity moments (float32 mean, var,
    min, max of the float32 values x by JAX's min-shifted formula): min
    and max exact; the mean within a relative 1e-6 of the shifted mean
    plus one float32 spacing of the mean (the shift back rounds to it);
    the var within 4 n 2^-24 mean(c^2), c = x - min."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    x = np.asarray(x, np.float32).astype(np.float64)
    c = x - x.min()
    np.testing.assert_array_equal(got[2:], want[2:])
    tol = 1e-6 * abs(c.mean()) + float(np.spacing(np.abs(want[0])))
    assert abs(float(got[0]) - float(want[0])) <= tol, (got, want)
    tol = 4 * len(x) * 2.0 ** -24 * (c * c).mean()
    assert abs(float(got[1]) - float(want[1])) <= tol, (got, want)


def k14_div_equal_plain(pa, L, pop, seed):
    """K14's div_stats against its plain version: min, max and the
    Hamming sample exactly, the moments within the stated tolerance.
    Returns the plain rows."""
    slots, pen, scv = div_case(pa.n_events, L, pop, seed, pa.device)
    args = (pa.event_mask, slots, pen, scv, L)
    got = islands.div_stats_kernel(*args).cpu().numpy()
    want = islands.div_stats_plain(*args).cpu().numpy()
    assert got.shape == want.shape == (L, 9)
    np.testing.assert_array_equal(got[:, 8], want[:, 8])
    for i in range(L):
        r = slice(i * pop, (i + 1) * pop)
        gf, wf = got[i].view(np.float32), want[i].view(np.float32)
        div_moments_close(gf[:4], wf[:4], pen[r].cpu().float().numpy())
        div_moments_close(gf[4:8], wf[4:8], scv[r].cpu().float().numpy())
    return want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_assign_rooms_equals_plain(cuda):
    for pa in _instances(cuda):
        st = _state(pa, 37, 1)
        assert torch.equal(rooms.assign_rooms(pa, st.slots),
                           rooms.assign_rooms_plain(pa, st.slots))


@pytest.mark.cuda
def test_k1_k6_match_degenerate_buckets(cuda):
    """K1 and K6's crossover matching on degenerate slot buckets (every
    event in one slot, two slots and the rest empty, R = 1, padded events
    and rooms) equal their plain versions."""
    for i, pa in enumerate(_matching_instances(cuda)):
        slots = _degenerate_slots(pa, 8, 200 + i)
        assert torch.equal(rooms.assign_rooms(pa, slots),
                           rooms.assign_rooms_plain(pa, slots))
        _, cfg, par, draws = _breed_case(pa, cuda, 2, 4, 210 + i, slots)
        for do_x in (True, None):
            d = draws if do_x is None else draws._replace(
                do_x=torch.ones_like(draws.do_x))
            got = ga.make_children(pa, d, par, cfg, 2)
            want = ga.make_children_plain(pa, d, par, cfg, 2)
            assert all(torch.equal(w, g) for w, g in zip(want, got))


@pytest.mark.cuda
def test_k2_batch_penalty_equals_plain(cuda):
    """K2 at the wrapper's cluster size and at every size it takes."""
    for pa in _instances(cuda):
        st = _state(pa, 33, 2)
        r = torch.randint(0, pa.n_rooms, st.rooms.shape, device=cuda,
                          dtype=torch.int32)
        for rm in (st.rooms, r):
            want = fitness.batch_penalty_plain(pa, st.slots, rm)
            got = fitness.batch_penalty(pa, st.slots, rm)
            for w, g in zip(want, got):
                assert torch.equal(w, g)
            for cs in (1, 2, 4, 8):
                got = fitness.batch_penalty_kernel(pa, st.slots, rm, cs)
                for w, g in zip(want, got):
                    assert torch.equal(w, g)


@pytest.mark.cuda
def test_k6_k8_fused_scores_equal_plain(cuda):
    """The scores K6 writes for its children (greedy and parallel
    matching, crowded tournament) and K8 for its rows equal
    batch_penalty_plain of the rows they wrote."""
    for i, pa in enumerate(_instances(cuda)):
        _, cfg, par, draws = _breed_case(pa, cuda, 2, 8, 240 + i)
        mo = nsga.rank_crowd_plain(par.hcv, par.scv, 2)
        for stats, mode in ((None, "scan"), (None, "parallel"),
                            (mo, "scan")):
            got = ga.make_children_kernel(pa, draws, par, 2, stats, mode)
            want = fitness.batch_penalty_plain(pa, got.slots, got.rooms)
            assert all(torch.equal(w, g) for w, g in zip(want, got[2:]))
        st = delta.init_rows(pa, *_state(pa, 6, 250 + i)[:2])
        got = delta.random_local_search(pa, _ls_draws(pa, cuda, 6, 5, 8,
                                                      260 + i), st)
        want = fitness.batch_penalty_plain(pa, got.slots, got.rooms)
        assert all(torch.equal(w, g) for w, g in zip(want, got[2:]))


@pytest.mark.cuda
def test_k3_move1_sweep_equals_plain(cuda):
    for pa in _instances(cuda):
        st = _state(pa, 9, 3)
        piv = torch.randint(0, pa.n_events, (9, 3), device=cuda,
                            dtype=torch.int32)
        got = sweep.move1_sweep(pa, st.slots, st.rooms, st.att, st.occ, piv)
        want = sweep.move1_sweep_plain(pa, st.slots, st.rooms, st.att,
                                       st.occ, piv)
        for w, g in zip(want, got):
            assert torch.equal(w, g)


@pytest.mark.cuda
def test_k4_delta_one_equals_plain(cuda):
    for pa in _instances(cuda):
        P, C = 7, 11
        st = _state(pa, P, 4)
        g = torch.Generator(device=cuda).manual_seed(5)
        d = moves.make_move_draws([g], P * C, pa.n_events, pa.n_slots,
                                  1.0, 1.0, 1.0, cuda)
        evs, ns, act = moves.sample_move(
            pa, d, st.slots.repeat_interleave(C, 0))
        evs, ns, act = (x.reshape(P, C, 3) for x in (evs, ns, act))
        # a duplicate-event candidate, as a hot-mode self-swap makes
        evs[0, 0, 1] = evs[0, 0, 0]
        got = delta.delta_one(pa, st.slots, st.rooms, st.att, st.occ, evs,
                              ns, act)
        want = delta.delta_one_plain(pa, st.slots, st.rooms, st.att,
                                     st.occ, evs, ns, act)
        for w, g2 in zip(want, got):
            assert torch.equal(w, g2)


# (swap_block, block_events, sideways, hot_k, p3) of the sweep passes K5
# is held against: the CPU sweep tests' PASS_CASES; hot pivots whose K is
# no multiple of B, with 3-cycles; no partners at all; hot_k >= E (the
# full permutation); the comp-scale repair and post passes
K5_CASES = [(4, 1, 0.5, 12, 0.3), (3, 2, 0.0, 0, 0.0),
            (3, 1, 0.25, 10, 0.0), (2, 3, 0.25, 10, 0.5),
            (0, 1, 0.0, 7, 0.0), (5, 1, 0.3, 500, 0.2),
            (8, 1, 0.25, 48, 0.0), (64, 1, 0.25, 0, 0.0)]


def _k5_equals_plain(pa, st, draws, case, clusters=(None,)):
    """K5 at each cluster size (None: the wrapper's own choice) and
    sweep_pass_plain on the same state and draws: every state field,
    strict_rows and the pivots, exactly."""
    want, want_rows = sweep.sweep_pass_plain(pa, draws, st, *case)
    sb, be, _, hot, p3 = case
    sh = sweep.sweep_shape(pa.n_events, pa.n_slots, sb, be, hot, p3)
    want_piv = (sweep.hot_pivots(pa, st, draws.hot_noise, sh.K)
                if sh.use_hot else sweep._perms(draws, pa.n_events,
                                                st.slots.device))
    for cs in clusters:
        got, rows, piv = sweep.sweep_pass_kernel(pa, draws, st, *case,
                                                 cluster=cs)
        for w, g in zip(want, got):
            assert torch.equal(w, g), f"cluster {cs}"
        assert torch.equal(want_rows, rows), f"cluster {cs}"
        assert torch.equal(want_piv, piv), f"cluster {cs}"


def _half_feasible(st):
    """The state with every other row's hcv set to 0 (and pen to its
    scv), so hot mode takes the feasible (scv) heat on those rows."""
    zero = torch.arange(st.hcv.shape[0], device=st.hcv.device) % 2 == 1
    hcv = torch.where(zero, 0, st.hcv)
    pen = torch.where(zero, st.scv, st.pen)
    return st._replace(pen=pen.to(torch.int32), hcv=hcv.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", K5_CASES)
def test_k5_sweep_pass_equals_plain(cuda, case):
    sb, be, side, hot, p3 = case
    for i, pa in enumerate(_instances(cuda)):
        P = 6
        st = _state(pa, P, 8 + i)
        sh = sweep.sweep_shape(pa.n_events, pa.n_slots, sb, be, hot, p3)
        g = torch.Generator(device=cuda).manual_seed(9 + i)
        draws = sweep.make_sweep_draws([g], P, sh, pa.n_events, side, cuda)
        _k5_equals_plain(pa, st, draws, case, CLUSTERS)
        _k5_equals_plain(pa, _half_feasible(st), draws, case, CLUSTERS)


# K5's cluster sizes held against the plain pass: the wrapper's own
# choice, then every power of two it may take
CLUSTERS = (None, 1, 2, 4, 8)
COMP05S = os.path.join(os.path.dirname(COMP01S), "comp05s.tim")


def _witness_state(pa, path, P, seed):
    """P copies of the instance's planted zero-penalty witness, row i
    with i % 4 of three spread events moved to random slots: feasible
    rows and nearly feasible ones."""
    import json
    with open(path.replace(".tim", ".witness.json")) as f:
        w = json.load(f)
    dev = pa.conflict.device
    E = pa.n_events
    g = torch.Generator(device=dev).manual_seed(seed)
    slots = torch.tensor(w["slots"], dtype=torch.int32,
                         device=dev).repeat(P, 1)
    rms = torch.tensor(w["rooms"], dtype=torch.int32, device=dev).repeat(P, 1)
    ev = (torch.randint(0, E, (P, 1), generator=g, device=dev)
          + torch.tensor([0, E // 3, 2 * E // 3], device=dev)) % E
    to = torch.randint(0, pa.n_slots, (P, 3), generator=g, device=dev,
                       dtype=torch.int32)
    moved = (torch.arange(3, device=dev)[None, :]
             < (torch.arange(P, device=dev) % 4)[:, None])
    slots.scatter_(1, ev, torch.where(moved, to, slots.gather(1, ev)))
    return delta.init_state(pa, slots, rms)


def _k5_at_comp_scale(cuda, path, phase, P, flags=()):
    """K5 at one of a path's sweep shapes (its repair or post config on
    the instance at `path`) from a random and a witness start, at every
    cluster size."""
    from timetabling_ga_tpu_torch.runtime import config, engine
    pa = load_tim_file(path).device_arrays(cuda)
    cfg = config.parse_args(["-i", path, *flags]).apply_tuned_defaults(
        pa.n_events)
    gc = engine.build_ga_config(cfg)
    if phase == "post":
        gc = engine.build_post_config(cfg, gc)
    case = (gc.ls_swap_block, gc.ls_block_events, gc.ls_sideways,
            gc.ls_hot_k, gc.p3)
    sh = sweep.sweep_shape(pa.n_events, pa.n_slots, *case[:2], *case[3:])
    g = torch.Generator(device=cuda).manual_seed(13 + P)
    draws = sweep.make_sweep_draws([g], P, sh, pa.n_events, case[2], cuda)
    for st in (_state(pa, P, 12), _witness_state(pa, path, P, 14)):
        _k5_equals_plain(pa, st, draws, case, CLUSTERS)
        _k5_equals_plain(pa, _half_feasible(st), draws, case, CLUSTERS)


@pytest.mark.cuda
@pytest.mark.parametrize("phase,P", [("repair", 16), ("repair", 256),
                                     ("post", 4)])
def test_k5_equals_plain_at_comp01s(cuda, phase, P):
    """The main path's repair (P=16 and 256) and post (P=4) passes on
    comp01s."""
    _k5_at_comp_scale(cuda, COMP01S, phase, P)


@pytest.mark.cuda
@pytest.mark.parametrize("phase,P", [("repair", 16), ("post", 4)])
def test_k5_equals_plain_at_comp05s_nsga_shapes(cuda, phase, P):
    """The nsga path's (--nsga2 --rooms-mode parallel) repair (P=16) and
    post (P=4) passes on comp05s."""
    _k5_at_comp_scale(cuda, COMP05S, phase, P,
                      ("--nsga2", "--rooms-mode", "parallel"))


@pytest.mark.cuda
def test_k5_converge_local_search_equals_plain(cuda, monkeypatch):
    pa = _instances(cuda)[0]
    st = _state(pa, 8, 10)
    sh = sweep.sweep_shape(pa.n_events, pa.n_slots, 3, 1, 10, 0.0)

    def draws_fn(i):
        g = torch.Generator(device=cuda).manual_seed(100 + i)
        return sweep.make_sweep_draws([g], 8, sh, pa.n_events, 0.25, cuda)

    def run():
        return sweep.sweep_local_search(
            pa, draws_fn, st.slots, st.rooms, n_sweeps=6, swap_block=3,
            converge=True, sideways=0.25, hot_k=10, groups=2,
            return_passes=True)

    kernels.reset_launches()
    got = run()
    assert kernels.LAUNCHES["sweep_pass"] == got[2]
    monkeypatch.setattr(sweep, "sweep_pass", sweep.sweep_pass_plain)
    want = run()
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert want[2] == got[2]


@pytest.mark.cuda
def test_k5_shared_memory_count_matches_the_kernel(cuda):
    kernels.build()
    fn = kernels._LIBS["sweep_pass"][0].tt_sweep_pass_smem_bytes
    fn.argtypes = [ctypes.c_int] * 9
    fn.restype = ctypes.c_int
    for pa in _instances(cuda):
        for sb, be, _, hot, p3 in K5_CASES:
            sh = sweep.sweep_shape(pa.n_events, pa.n_slots, sb, be, hot, p3)
            assert fn(pa.n_events, pa.n_rooms, pa.n_students, pa.n_slots,
                      sh.K, sh.n_cand, int(sh.use_hot), pa.max_ev_students,
                      pa.conflict_bits.shape[1]) == \
                sweep.sweep_pass_smem_bytes(pa, sh)


@pytest.mark.cuda
@pytest.mark.parametrize("n_lanes", [1, 3, 4])
def test_k6_k8_lane_tables_equal_plain(cuda, n_lanes):
    """K6 (both tournament modes, both matchers) and K8's chain with a
    lane table against their lane-looped plain versions, each lane a
    different instance of one bucket (padded, anchored, the largest and
    the shortest CSR), and the K8 chain's rows re-scored per lane."""
    lp = _lane_problems(n_lanes, cuda)
    cfg, par, draws, rows, ls = _lane_case(lp, cuda, 6, 90 + n_lanes)
    kernels.reset_launches()
    k6_lanes_equal_plain(lp, cfg, par, draws)
    k6_lanes_equal_plain(lp, cfg, par, draws, rooms_mode="parallel")
    k6_lanes_equal_plain(lp, cfg, par, draws,
                         nsga.rank_crowd_plain(par.hcv, par.scv, n_lanes))
    got = k8_lanes_equal_plain(lp, ls, rows)
    assert kernels.LAUNCHES["breed_lanes"] == 3
    assert kernels.LAUNCHES["random_ls_lanes"] == 1
    assert kernels.LAUNCHES["breed"] == kernels.LAUNCHES["random_ls"] == 0
    for lane, pa in enumerate(lp.pas):
        r = slice(lane * 6, (lane + 1) * 6)
        full = fitness.batch_penalty_plain(pa, got.slots[r], got.rooms[r])
        assert all(torch.equal(w, g[r]) for w, g in zip(full, got[2:]))


@pytest.mark.cuda
def test_k6_k8_null_table_unchanged(cuda):
    """With a null table K6 and K8's chain are the one-problem kernels:
    a LaneProblems of one lane equals the ProblemArrays form bit for
    bit."""
    lp = _lane_problems(1, cuda)
    cfg, par, draws, rows, ls = _lane_case(lp, cuda, 8, 97)
    a = ga.make_children_kernel(lp, draws, par, 1)
    b = ga.make_children_kernel(lp.first, draws, par, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = delta.random_local_search_kernel(lp, ls, rows)
    b = delta.random_local_search_kernel(lp.first, ls, rows)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_k6_breed_and_relocate_equal_plain(cuda):
    for i, pa in enumerate(_instances(cuda)):
        for groups, pop in ((1, 16), (3, 5)):
            _, cfg, par, draws = _breed_case(pa, cuda, groups, pop, 60 + i)
            got = ga.make_children(pa, draws, par, cfg, groups)
            want = ga.make_children_plain(pa, draws, par, cfg, groups)
            assert all(torch.equal(w, g) for w, g in zip(want, got))
        st = _state(pa, 9, 70 + i)
        d = moves.make_move_draws([torch.Generator(device=cuda)
                                   .manual_seed(i)] * 4, 9, pa.n_events,
                                  pa.n_slots, 1.0, 1.0, 1.0, cuda)
        chain = moves.MoveDraws(*(x.reshape((4, 9) + x.shape[1:])
                                  for x in d))
        for n in (1, 3):
            got = moves.relocation_chain(pa, chain, st.slots, st.rooms, n)
            want = moves.relocation_chain_plain(pa, chain, st.slots,
                                                st.rooms, n)
            assert all(torch.equal(w, g) for w, g in zip(want, got))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 2, 4, 16])
@pytest.mark.parametrize("pop", [2, 3, 16])
def test_k7_survivors_and_migrate_equal_plain(cuda, L, pop):
    """K7's grid of blocks an island, with rows of E = 7 (4-byte copies)
    and E = 400 (16-byte ones)."""
    for E in (7, 400):
        par = _island_state(L, pop, 1, cuda, E)
        ch = _island_state(L, pop, 2, cuda, E)
        for b, keep in ((ch, pop), (None, None)):
            got = ga.survivors(par, b, groups=L, keep=keep)
            want = ga.survivors_plain(par, b, groups=L, keep=keep)
            assert all(torch.equal(w, g) for w, g in zip(want, got))
        got = islands.migrate(want, L)
        assert all(torch.equal(w, g)
                   for w, g in zip(islands.migrate_plain(want, L), got))


# K14's grid: islands x rows an island (pop 1 has no Hamming pair; 33
# rows more than the 32 pairs)
K14_L = (1, 4, 16)
K14_POP = (1, 2, 3, 4, 10, 16, 33)


@pytest.mark.cuda
def test_k14_quality_ops_and_div_stats_equal_plain(cuda):
    for i, pa in enumerate(_instances(cuda)):
        for L in K14_L:
            for pop in K14_POP:
                k14_ops_equal_plain(L, pop, 10 * L + pop + i, cuda,
                                    with_sweep=pop % 2 == 0)
                k14_div_equal_plain(pa, L, pop, 10 * L + pop + i)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K5_CASES)
def test_k5_move_counts_equal_plain(cuda, case):
    sb, be, side, hot, p3 = case
    n = torch.zeros(3, dtype=torch.int32, device=cuda)
    for i, pa in enumerate(_instances(cuda)):
        P = 6
        st = _state(pa, P, 40 + i)
        sh = sweep.sweep_shape(pa.n_events, pa.n_slots, sb, be, hot, p3)
        g = torch.Generator(device=cuda).manual_seed(41 + i)
        draws = sweep.make_sweep_draws([g], P, sh, pa.n_events, side, cuda)
        n += k5_ops_equal_plain(pa, st, draws, case, CLUSTERS).sum(0)
        n += k5_ops_equal_plain(pa, _half_feasible(st), draws, case,
                                CLUSTERS).sum(0)
    assert n[0] > 0 and (n[1] > 0 or sb == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K6_MODES)
def test_k6_base_parents_equal_plain(cuda, mode):
    for i, pa in enumerate(_instances(cuda)):
        k6_parents_equal_plain(pa, cuda, 90 + i, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("pop", [3, 8, 16])
@pytest.mark.parametrize("D,L", [(2, 1), (2, 2), (4, 2)])
def test_k7_halo_form_equals_plain(cuda, D, L, pop):
    """K7's halo form on a mesh of D shards of the card (L islands each):
    every shard's migrate with its halo rows equals migrate_plain with
    them, gain included, rows of E = 7 and E = 400; one launch a shard,
    counted as migrate_halo."""
    from timetabling_ga_tpu_torch.parallel import comm
    for E in (7, 400):
        full = _gain_state(D * L, pop, E, cuda)
        mesh = islands.Mesh([cuda] * D, comm.SOLO)
        states = [ga.PopState(*(x[s * L * pop:(s + 1) * L * pop]
                                for x in full)) for s in range(D)]
        to_next = [islands.halo_row(st, (L - 1) * pop) for st in states]
        to_prev = [islands.halo_row(st, 1) for st in states]
        fwd, bwd = mesh.halo(to_next, to_prev)
        kernels.reset_launches()
        for s, st in enumerate(states):
            got, gain = islands.migrate_kernel(st, L, True, fwd[s], bwd[s])
            want, wgain = islands.migrate_plain(st, L, True, fwd[s], bwd[s])
            assert all(torch.equal(w, g) for w, g in zip(want, got))
            assert torch.equal(gain, wgain)
        assert kernels.LAUNCHES["migrate_halo"] == D
        assert kernels.LAUNCHES["migrate"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 2, 4, 16])
@pytest.mark.parametrize("pop", [2, 3, 16])
def test_k7_migrate_gain_equal_plain(cuda, L, pop):
    for E in (7, 400):
        gain = k7_gain_equal_plain(L, pop, E, cuda)
        assert (gain.sum() > 0) == (L > 1 and pop >= 3)


@pytest.mark.cuda
def test_k8_random_ls_equals_plain(cuda):
    for i, pa in enumerate(_instances(cuda)):
        st = delta.init_rows(pa, *_state(pa, 6, 80 + i)[:2])
        for K in (8, 3, 20):
            draws = _ls_draws(pa, cuda, 6, 5, K, 90 + i)
            got = delta.random_local_search(pa, draws, st)
            want = delta.random_local_search_plain(pa, draws, st)
            assert all(torch.equal(w, g) for w, g in zip(want, got))
            # the full re-evaluation form (K6 relocate + K2) agrees
            full = local_search.batch_local_search(pa, draws, st.slots,
                                                   st.rooms)
            assert torch.equal(full[0], got.slots)
            assert torch.equal(full[1], got.rooms)


@pytest.mark.cuda
def test_k8_events_pre_pass_and_chunks_equal_plain(cuda):
    """K8's pre-pass equals its plain version (moves.top3 of every draw
    row) with ties among the uniforms, and the chain equals the plain
    search when its rounds span several chunks of events (K = 40: 51
    rounds a chunk)."""
    pa = _instances(cuda)[0]
    st = delta.init_rows(pa, *_state(pa, 3, 95)[:2])
    for P, n_rounds, K in ((3, 60, 40), (1, 1, 1), (7, 4, 9)):
        draws = _ls_draws(pa, cuda, P, n_rounds, K, 96)
        # ties: a few distinct values, so top_k's lower-index rule decides
        tied = draws._replace(u=(draws.u * 4).floor() / 4)
        for d in (draws, tied):
            assert torch.equal(delta.random_ls_events_kernel(d),
                               delta.random_ls_events_plain(d))
    draws = _ls_draws(pa, cuda, 3, 60, 40, 97)
    got = delta.random_local_search(pa, draws, st)
    want = delta.random_local_search_plain(pa, draws, st)
    assert all(torch.equal(w, g) for w, g in zip(want, got))


def _offset_uniforms(draws, E, offset, seed):
    """`draws` with uniforms of width E that start `offset` floats into
    their buffer (off a 16-byte boundary when offset % 4 != 0)."""
    n_rounds, K, P = draws.mtype.shape
    g = torch.Generator(device=draws.u.device).manual_seed(seed)
    buf = torch.rand(offset + n_rounds * K * P * E, generator=g,
                     device=draws.u.device)
    return draws._replace(u=buf[offset:].view(n_rounds, K, P, E))


@pytest.mark.cuda
def test_k8_events_pre_pass_on_unaligned_rows_and_tied_top3(cuda):
    """K8's pre-pass (one streaming pass: float4 bodies, scalar heads and
    tails) equals its plain version at E = 400, 397 and 7, on rows that
    start off a 16-byte boundary, and where a row's top three tie."""
    pa = _instances(cuda)[0]
    base = _ls_draws(pa, cuda, 10, 25, 8, 98)
    for E, offset in ((400, 0), (400, 1), (397, 0), (397, 2), (7, 3)):
        d = _offset_uniforms(base, E, offset, 99 + E + offset)
        u = d.u.clone()
        for i in (E - 1, 33 % E, 2):
            u[..., i] = 2.0
        for x in (d, d._replace(u=u), d._replace(u=(d.u * 8).floor() / 8)):
            assert torch.equal(delta.random_ls_events_kernel(x),
                               delta.random_ls_events_plain(x))


@pytest.mark.cuda
def test_k12_full_eval_ls_equals_plain(cuda):
    """K12 (K8's pre-pass, then one launch) equals
    batch_local_search_plain in rows and penalty terms, at K = 8 (a
    candidate a CTA), 3 and 12 (K > CS: a CTA takes several), at the
    wrapper's cluster size and at 1 and 2; its terms are a full
    evaluation of its rows."""
    for i, pa in enumerate(_instances(cuda)):
        rows = delta.init_rows(pa, *_state(pa, 6, 600 + i)[:2])
        for K in (8, 3, 12):
            draws = _ls_draws(pa, cuda, 6, 5, K, 610 + i)
            want = local_search.batch_local_search_plain(pa, draws, rows)
            for cs in (None, 1, 2):
                kernels.reset_launches()
                got = local_search.batch_local_search_kernel(pa, draws,
                                                             rows, cs)
                assert kernels.LAUNCHES["full_eval_ls"] == 1
                assert kernels.LAUNCHES["random_ls_events"] == 1
                assert all(torch.equal(w, g) for w, g in zip(want, got))
            full = fitness.batch_penalty_plain(pa, got.slots, got.rooms)
            assert all(torch.equal(w, g) for w, g in zip(full, got[2:]))


@pytest.mark.cuda
def test_k12_shared_memory_count_matches_the_kernel(cuda):
    kernels.build()
    fn = kernels._LIBS["full_eval_ls"][0].tt_full_eval_ls_smem_bytes
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_int
    for pa in _instances(cuda):
        for K in (1, 8, 40):
            assert fn(pa.n_events, pa.n_rooms, pa.n_students, pa.n_slots, K,
                      pa.conflict_bits.shape[1], pa.stu_ev.numel()) == \
                local_search.full_eval_ls_smem_bytes(pa, K)


@pytest.mark.cuda
def test_k8_shared_memory_count_matches_the_kernel(cuda):
    kernels.build()
    fn = kernels._LIBS["random_ls"][0].tt_random_ls_smem_bytes
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    for pa in _instances(cuda):
        for K in (1, 8, 40):
            assert fn(pa.n_events, pa.n_rooms, pa.n_students, pa.n_slots, K,
                      pa.conflict_bits.shape[1]) == \
                delta.random_ls_smem_bytes(pa, K)


@pytest.mark.cuda
@pytest.mark.parametrize("R", WIDE_R)
def test_k1_k6_k9_past_one_warp_equal_plain(cuda, R):
    """K1, K6 (greedy, crowded, parallel, relocation) and K9 at 33 and
    80 rooms equal their plain versions."""
    pa = _past_one_warp(R, cuda)
    k1_k6_wide_equal_plain(pa, cuda, 800 + R)
    _matcher_equals_plain(pa, cuda, 804 + R)


@pytest.mark.cuda
@pytest.mark.parametrize("R", WIDE_R)
def test_k4_k8_k10_k12_past_one_warp_equal_plain(cuda, R):
    """K4's own launch, K8, K10 and K12 (the K4 body's room choice and
    K12's relocation) at 33 and 80 rooms equal their plain versions."""
    pa = _past_one_warp(R, cuda)
    k4_wide_equal_plain(pa, cuda, 810 + R)
    k8_k12_wide_equal_plain(pa, cuda, 820 + R, K=8)
    k10_wide_equal_plain(pa, cuda, 830 + R, k_cands=16, Lh=5000)


@pytest.mark.cuda
def test_k5_past_one_warp_equals_plain(cuda):
    """K5's hot-pivot and permutation passes at 80 and 300 rooms, every
    cluster size: the K4 body's choice over several rooms a lane and the
    candidates' rooms in their 12-bit packing beside hcv (past 255 in
    the high word)."""
    for R in (80, 300):
        pa = _past_one_warp(R, cuda)
        st = _state(pa, 4, 840)
        if R > 256:
            # every event starts in a room past the candidate's low word
            st = delta.init_state(pa, st.slots, torch.randint(
                256, R, st.rooms.shape, device=cuda, dtype=torch.int32,
                generator=torch.Generator(device=cuda).manual_seed(842)))
        for case in (K5_CASES[0], (8, 1, 0.25, 12, 0.0),
                     (16, 1, 0.25, 0, 0.2)):
            sh = sweep.sweep_shape(pa.n_events, pa.n_slots, *case[:2],
                                   *case[3:])
            draws = sweep.make_sweep_draws(
                [torch.Generator(device=cuda).manual_seed(841)], 4, sh,
                pa.n_events, case[2], cuda)
            _k5_equals_plain(pa, st, draws, case, clusters=CLUSTERS)


@pytest.mark.cuda
def test_k9_parallel_rooms_equals_plain(cuda):
    for i, pa in enumerate(_instances(cuda)):
        st = _state(pa, 9, 140 + i)
        slots = st.slots.clone()
        slots[:, ::2] %= 3
        rms = torch.randint(0, pa.n_rooms, slots.shape, device=cuda,
                            dtype=torch.int32,
                            generator=torch.Generator(device=cuda)
                            .manual_seed(i))
        for n in (1, 2, 4):
            assert torch.equal(rooms.augment_rooms(pa, slots, rms, n),
                               rooms.augment_rooms_plain(pa, slots, rms, n))
        assert torch.equal(
            rooms.parallel_assign_rooms(pa, slots),
            rooms.augment_rooms_plain(pa, slots, rooms.best_fit_rooms(pa, 9)))


@pytest.mark.cuda
def test_k6_crowded_tournament_and_parallel_rooms_equal_plain(cuda):
    for i, pa in enumerate(_instances(cuda)):
        for groups, pop in ((1, 16), (3, 5)):
            _, _, par, draws = _breed_case(pa, cuda, groups, pop, 150 + i)
            for mo, mode in ((True, "scan"), (False, "parallel"),
                             (True, "parallel")):
                cfg = ga.GAConfig(pop_size=pop, p3=0.4, rooms_mode=mode,
                                  multi_objective=mo)
                stats = (nsga.rank_crowd(par.hcv, par.scv, groups) if mo
                         else None)
                got = ga.make_children(pa, draws, par, cfg, groups, stats)
                want = ga.make_children_plain(pa, draws, par, cfg, groups,
                                              stats)
                assert all(torch.equal(w, g) for w, g in zip(want, got))


@pytest.mark.cuda
@pytest.mark.parametrize("L,pop", [(1, 8), (2, 20), (4, 16), (1, 512)])
def test_k11_nsga_equals_plain(cuda, L, pop):
    g = torch.Generator(device=cuda).manual_seed(pop)

    def state(seed):
        st = _island_state(L, pop, seed, cuda)
        hcv = torch.randint(0, 4, (L * pop,), generator=g, device=cuda,
                            dtype=torch.int32)
        return st._replace(hcv=hcv, scv=torch.randint(
            0, 6, (L * pop,), generator=g, device=cuda, dtype=torch.int32))
    par, ch = state(1), state(2)
    got = nsga.rank_crowd(par.hcv, par.scv, L)
    want = nsga.rank_crowd_plain(par.hcv, par.scv, L)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    got = nsga.survivors(par, ch, L, pop)
    want = nsga.survivors_plain(par, ch, L, pop)
    assert all(torch.equal(w, x) for w, x in zip(want, got))


@pytest.mark.cuda
@pytest.mark.parametrize("case", K11_CASES)
def test_k11_nsga_edge_cases_equal_plain(cuda, case):
    """K11 on several dominator words, n fronts, one front with empty
    ranges, keep = 1 and keep = n, and 4-byte and 16-byte row copies."""
    _k11_equal_plain(case, cuda)


@pytest.mark.cuda
def test_k11_without_dominator_words_equals_plain(cuda):
    """An island whose dominator words do not fit in shared memory (n =
    1,400: 245 KB of words) peels without them and equals the plain
    version."""
    _k11_equal_plain((1, 700, "random", 8, 0), cuda)
    par = _k11_island(1, 1400, "random", 5, device=cuda)
    got = nsga.rank_crowd_kernel(par.hcv, par.scv)
    want = nsga.rank_crowd_plain(par.hcv, par.scv)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.cuda
def test_k9_k6_parallel_matcher_edge_cases(cuda):
    """The parallel matcher on a slot holding every event (more than
    32), R = 1, R = 32 and padded events and rooms, at 0, 1 and 4
    rounds, in K9 and in K6 with crossover on, off and mixed."""
    for i, pa in enumerate(_matching_instances(cuda) + [_wide_rooms(cuda)]):
        _matcher_equals_plain(pa, cuda, 260 + i)
    pa, slots, rms, want = _chained_augments(cuda)
    for n in (2, 4):
        assert torch.equal(rooms.augment_rooms_plain(pa, slots, rms, n), want)
        assert torch.equal(rooms.augment_rooms(pa, slots, rms, n), want)
    assert torch.equal(rooms.parallel_assign_rooms(pa, slots), want)


def test_suitability_words_encode_the_problem():
    """suit_rank bit k of word j is possible[e, the room of capacity rank
    32j + k], every bit past R clear, and room_of_rank inverts cap_rank,
    on a padded instance, on R = 32 (one word) and on R = 80 (three)."""
    for pa in (padded_arrays(random_instance(4, n_events=50, n_rooms=4,
                                             n_features=3, n_students=40,
                                             attend_prob=0.1)),
               _wide_rooms("cpu"), _past_one_warp(80, "cpu")):
        R = pa.n_rooms
        assert torch.equal(pa.cap_rank[pa.room_of_rank.long()],
                           torch.arange(R, dtype=torch.int32))
        words = pa.suit_rank.numpy().view(np.uint32)
        assert words.shape == (pa.n_events, -(-R // 32))
        k = np.arange(32 * words.shape[1])
        dec = (words[:, k // 32] >> (k % 32).astype(np.uint32)) & 1
        assert not dec[:, R:].any()
        dec = dec[:, :R]
        np.testing.assert_array_equal(
            dec.astype(bool), pa.possible.numpy()[:, pa.room_of_rank.numpy()])


def _lahc_copy(state):
    """A copy of a LahcState, for K10 to update in place."""
    return lahc.LahcState(lahc.LSState(*(x.clone() for x in state.ls)),
                          *(x.clone() for x in state[1:]))


def _tied_lahc_draws(draws):
    """Every candidate's top three uniforms tied at 2.0, and row 0's
    largest tied at 3.0 twice and its third with a later index."""
    u = draws.u.clone()
    E = u.shape[-1]
    for i in (E - 1, 33 % E, 2):
        u[..., i] = 2.0
    u.view(-1, E)[0, [40 % E, 5 % E]] = 3.0
    u.view(-1, E)[0, E - 2] = 2.0
    return draws._replace(u=u)


@pytest.mark.cuda
def test_k10_lahc_equals_plain(cuda):
    """K8's pre-pass and K10, one launch each, against lahc_steps_plain
    in every field: K 1, 16, 5 and 40 (more candidates than warps),
    histories of 3, 5, 1,000, 1 (the entry read is the one the step
    before wrote) and 30,000 (the ring in global memory), tied
    uniforms, walkers at different ring positions with rings spread
    around their costs, on the ITC-like, medium, padded and anchored
    instances."""
    for i, pa in enumerate(_instances(cuda)):
        st = _state(pa, 4, 160 + i)
        for K, Lh, tied in ((1, 3, False), (16, 5, False),
                            (5, 1000, False), (16, 1, False),
                            (40, 3, False), (16, 30_000, False),
                            (16, 5, True)):
            l0 = lahc.init_lahc(pa, st.slots, st.rooms, Lh)
            g = torch.Generator(device=cuda).manual_seed(170 + i)
            jitter = torch.randint(-2, 3, (2, 4, Lh), generator=g,
                                   device=cuda, dtype=torch.int32)
            l0 = l0._replace(
                hist_pen=l0.hist_pen + jitter[0],
                hist_scv=l0.hist_scv + jitter[1],
                step=torch.arange(4, dtype=torch.int32, device=cuda) * 7)
            draws = lahc.make_lahc_draws([g], 4, 12, K, pa.n_events,
                                         pa.n_slots, 1.0, 1.0, 0.5, cuda)
            if tied:
                draws = _tied_lahc_draws(draws)
            l1 = _lahc_copy(l0)
            kernels.reset_launches()
            got = lahc.lahc_steps(pa, draws, l1)
            want = lahc.lahc_steps_plain(pa, draws, l0)
            assert kernels.LAUNCHES["random_ls_events"] == 1
            assert kernels.LAUNCHES["lahc"] == 1
            assert all(torch.equal(w, x) for w, x in zip(want.ls, got.ls))
            assert all(torch.equal(w, x) for w, x in zip(want[1:], got[1:]))
            # the kernel writes the walkers' state in place
            assert got.step.data_ptr() == l1.step.data_ptr()
            assert got.ls.slots.data_ptr() == l1.ls.slots.data_ptr()


@pytest.mark.cuda
def test_k10_shared_memory_count_matches_the_kernel(cuda):
    kernels.build()
    fn = kernels._LIBS["lahc"][0].tt_lahc_smem_bytes
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_int
    for pa in _instances(cuda) + [load_tim_file(COMP01S)
                                  .device_arrays(cuda)]:
        for K in (1, 16, 40):
            for Lh in (1, 5, 5000, 30_000):
                assert fn(pa.n_events, pa.n_rooms, pa.n_students,
                          pa.n_slots, K, pa.conflict_bits.shape[1],
                          Lh) == lahc.lahc_smem_bytes(pa, K, Lh)


@pytest.mark.cuda
def test_launch_counters_count_launches(cuda):
    pa = _instances(cuda)[1]
    st = _state(pa, 4, 6)
    kernels.reset_launches()
    fitness.batch_penalty(pa, st.slots, st.rooms)
    rooms.assign_rooms(pa, st.slots)
    assert kernels.LAUNCHES["batch_penalty"] == 1
    assert kernels.LAUNCHES["assign_rooms"] == 1
    assert kernels.LAUNCHES["delta_one"] == 0


def test_cpu_tensors_take_the_plain_version():
    pa = random_instance(2, n_events=40, n_rooms=5, n_features=3,
                         n_students=30, attend_prob=0.1).device_arrays()
    st = _state(pa, 3, 7)
    kernels.reset_launches()
    got = fitness.batch_penalty(pa, st.slots, st.rooms)
    want = fitness.batch_penalty_plain(pa, st.slots, st.rooms)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(rooms.assign_rooms(pa, st.slots),
                       rooms.assign_rooms_plain(pa, st.slots))
    assert sum(kernels.LAUNCHES.values()) == 0


def k13_grid(device, mode, set_cap):
    """K13 against its plain version over K13_L x K13_T, each trace at
    the caps K13_CAPS and at its islands' least and largest improvement
    counts (K below, equal to and above the counts). `set_cap(k)` sets
    islands.TRACE_DELTAS_CAP. Returns the number of traces compared and
    of them with an island over its cap."""
    n = over = 0
    for L in K13_L:
        for T in K13_T:
            tr = _trace(L, T, L * T, device)
            set_cap(T)
            counts = k13_equals_plain(tr, mode)[:, 3 * T]
            for cap in sorted({*K13_CAPS, int(counts.min()),
                               int(counts.max())}):
                set_cap(cap)
                leaf = k13_equals_plain(tr, mode)
                n += 1
                over += bool((counts > min(T, cap)).any())
                assert (leaf[:, 3 * min(T, cap)] == counts).all()
    return n, over


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["deltas", "stats"])
def test_k13_compress_trace_equals_plain(cuda, monkeypatch, mode):
    """Events and counts exact, moments within the tolerance."""
    n, over = k13_grid(cuda, mode, lambda k: monkeypatch.setattr(
        islands, "TRACE_DELTAS_CAP", k))
    assert n > len(K13_L) * len(K13_T) and over > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["deltas", "stats"])
def test_k13_compress_trace_lanes_equals_plain(cuda, monkeypatch, mode):
    """The lane form: counts 0, T and between, cap None (below and above
    the counts) and T (a quality-packed full trace)."""
    for L in K13_L:
        for T in K13_T:
            tr = _trace(L, T, 13 * T + L, cuda)
            nv = lane_counts(L, T, T + L)
            for k in (3, 64):
                monkeypatch.setattr(islands, "TRACE_DELTAS_CAP", k)
                k13_lanes_equal_plain(tr, mode, nv)
            k13_lanes_equal_plain(tr, mode, nv, cap=T)


@pytest.mark.cuda
def test_k14_div_stats_lanes_equals_plain(cuda):
    for L in K14_L:
        for pop in K14_POP:
            for E in (40, 400):
                k14_div_lanes_equal_plain(lane_masks(L, E, E + L, cuda), L,
                                          pop, 10 * L + pop)


@pytest.mark.cuda
def test_k13_moment_rows_equals_plain(cuda):
    for L, n in ((1, 64), (4, 16), (16, 4), (2, 1), (1, 1000)):
        tr = _trace(L, n, n, cuda)
        moment_rows_equal_plain(tr[..., 0].contiguous(),
                                tr[..., 1].contiguous())


def test_lane_tables_on_cpu_tensors_take_the_lane_loops():
    """On CPU tensors make_children and the random search take a
    LaneProblems through their lane-looped plain versions: no launch."""
    lp = _lane_problems(3)
    cfg, par, draws, rows, ls = _lane_case(lp, "cpu", 4, 5)
    kernels.reset_launches()
    a = ga.make_children(lp, draws, par, cfg, 3)
    b = delta.random_local_search(lp, ls, rows)
    assert sum(kernels.LAUNCHES.values()) == 0
    assert all(torch.equal(x, y) for x, y in zip(
        a, ga.make_children_lanes_plain(lp, draws, par, cfg)))
    assert all(torch.equal(x, y) for x, y in zip(
        b, delta.random_ls_lanes_plain(lp, ls, rows)))
    # each lane's block is the one-problem plain version on its problem
    for lane, pa in enumerate(lp.pas):
        r = slice(lane * 4, (lane + 1) * 4)
        one = delta.random_local_search_plain(
            pa, delta.LSDraws(*(x[:, :, r] for x in ls)),
            delta.LSRows(*(x[r] for x in rows)))
        assert all(torch.equal(x[r], y) for x, y in zip(b, one))


def test_lane_table_columns_match_the_kernels():
    """problem.LANE_FIELDS is csrc/common.cuh's TT_LANE_* order, and a
    table row holds each lane's field addresses, then its scalars."""
    import re
    from timetabling_ga_tpu_torch import problem
    text = (kernels.CSRC / "common.cuh").read_text()
    body = re.search(r"enum \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"TT_LANE_(\w+)", body)
    assert names[-1] == "FIELDS"
    want = [f.upper().removesuffix("_U8") for f in problem.LANE_POINTERS]
    assert names[:-1] == want + ["DIAG", "ANCHORED"]
    lp = _lane_problems(4)
    assert tuple(lp.table.shape) == (4, len(problem.LANE_FIELDS))
    for row, pa in zip(lp.table.tolist(), lp.pas):
        assert row[:len(problem.LANE_POINTERS)] == [
            getattr(pa, f).data_ptr() for f in problem.LANE_POINTERS]
        assert row[-2:] == [pa.conflict_diag, int(pa.anchored)]
    sub = lp.select([2, 0])
    assert sub.pas == [lp.pas[2], lp.pas[0]]
    assert torch.equal(sub.table, lp.table[[2, 0]])


def test_trace_compression_on_cpu_tensors_takes_the_plain_version():
    kernels.reset_launches()
    tr = _trace(2, 40, 0, "cpu")
    leaf = islands.compress_trace(tr, "stats")
    assert torch.equal(leaf, islands.compress_trace_plain(tr, "stats"))
    rows = islands.moment_rows(tr[..., 0], tr[..., 1])
    assert rows.shape == (4, 2)
    assert kernels.LAUNCHES["compress_trace"] == 0
    assert kernels.LAUNCHES["moment_rows"] == 0


def test_lane_trace_forms_on_cpu_tensors_take_the_plain_versions():
    """compress_trace with n_valid and div_stats with a mask row a lane
    launch nothing on CPU tensors; an n_valid of T everywhere is the
    unmasked leaf, and a shared mask expanded to rows is the shared-mask
    form."""
    kernels.reset_launches()
    tr = _trace(3, 40, 2, "cpu")
    for mode in ("deltas", "stats"):
        full = torch.full((3,), 40, dtype=torch.int32)
        assert torch.equal(islands.compress_trace(tr, mode, n_valid=full),
                           islands.compress_trace_plain(tr, mode))
    masks = lane_masks(3, 20, 1)
    slots, pen, scv = div_case(20, 3, 4, 5)
    lanes = islands.div_stats_plain(masks[:1].expand(3, -1), slots, pen,
                                    scv, 3)
    assert torch.equal(lanes, islands.div_stats_plain(masks[0], slots, pen,
                                                      scv, 3))
    assert sum(kernels.LAUNCHES.values()) == 0


def test_sweep_pass_smem_bytes_at_comp01s():
    """K5's shared memory per CTA on comp01s (E=400, R=10, S=200, T=45,
    W=13): att 18,000 B, conflict bits 20,800, slots and rooms 3,200,
    the bitsets amask 1,600 and slot_ev 2,352 (2,340 rounded up), occ
    912, the rest pivots, heat and scratch."""
    pa = load_tim_file(COMP01S).device_arrays()
    repair = sweep.sweep_shape(400, 45, 8, 1, 48, 0.0)
    post = sweep.sweep_shape(400, 45, 64, 1, 0, 0.0)
    assert sweep.sweep_pass_smem_bytes(pa, repair) == 50_336
    assert sweep.sweep_pass_smem_bytes(pa, post) == 51_040


def test_room_kernels_refuse_only_by_shared_memory(monkeypatch):
    """K1, K6 (both matchers, its relocation entry) and K9 take any
    R < 4096: where the occupancy or the matcher's scratch does not fit
    one block (the (45, R) int32 occupancy is 234,000 bytes at 1,300
    rooms, past the 232,448 a block can have; at 400 rooms the
    relocation entry's four rows are 288,096), the same sizes choose the
    global-memory branch and get as far as the CPU tensor the kernel
    cannot take, launching nothing. What is still refused is refused by
    the bytes one block needs, named, before anything launches (a
    layout pushed past the limit)."""
    for R, glob in ((1300, ("assign_rooms", "breed", "parallel_rooms",
                            "relocate")), (400, ("relocate",))):
        pa = random_instance(3, n_events=12, n_rooms=R, n_features=2,
                             n_students=10,
                             attend_prob=0.2).device_arrays()
        stages = {"assign_rooms": rooms.assign_rooms_stage(pa),
                  "breed": ga.breed_stage(pa, False),
                  "parallel_rooms": rooms.parallel_rooms_stage(pa),
                  "relocate": moves.relocate_stage(pa)}
        assert all(v[0] <= kernels.SMEM_LIMIT for v in stages.values())
        full = {"assign_rooms": 1, "breed": 7, "parallel_rooms": 3,
                "relocate": 4}
        assert {k for k, v in stages.items()
                if v[1] != full[k]} == set(glob)
        assert moves.relocate_stage(pa)[1] == (0 if R == 1300 else 2)
        st = _state(pa, 2, 1)
        _, _, par, draws = _breed_case(pa, "cpu", 1, 2, 2)
        chain = moves.MoveDraws(*(x[None] for x in draws.move))
        calls = {
            "assign_rooms": lambda: rooms.assign_rooms_kernel(pa,
                                                              st.slots),
            "breed": lambda: ga.make_children_kernel(pa, draws, par),
            "parallel_rooms": lambda: rooms.augment_rooms_kernel(
                pa, st.slots, None),
            "relocate": lambda: moves.relocation_chain_kernel(
                pa, chain, st.slots, st.rooms, 1)}
        kernels.reset_launches()
        for name in glob:
            with pytest.raises(ValueError, match="CUDA device"):
                calls[name]()
        assert sum(kernels.LAUNCHES.values()) == 0
    monkeypatch.setattr(rooms, "assign_rooms_stage",
                        lambda pa: (kernels.SMEM_LIMIT + 16, 1, 0))
    with pytest.raises(ValueError, match=f"{kernels.SMEM_LIMIT + 16} "
                                         f"bytes of shared"):
        rooms.assign_rooms_kernel(pa, st.slots)
    assert sum(kernels.LAUNCHES.values()) == 0


def _sized(E, R, S, T=45):
    """A stand-in of ProblemArrays with just the sizes the kernels'
    layout functions read (no data: `meta` tensors): an event of every
    student (the most the Move1 masks can take) and 7 events a student's
    CSR."""
    import types
    return types.SimpleNamespace(
        n_events=E, n_rooms=R, n_students=S, n_slots=T,
        conflict_bits=torch.empty((E, -(-E // 32)), dtype=torch.int32,
                                  device="meta"),
        max_ev_students=S,
        stu_ev=torch.empty(7 * S, dtype=torch.int32, device="meta"))


def _layouts(pa):
    """(name, bytes a block, what it stages) of every kernel that stages
    per-individual state, at the paths' shapes: K5's repair (hot-K 48)
    and post (swap block 64) passes, K8 at K 8, K10 at K 16 and Lh
    5,000, K12 at K 8, K1, K9, K6's breeding in both matchers and its
    relocation entry, and K2."""
    E, T = pa.n_events, pa.n_slots
    out = []
    for tag, c in (("repair", (8, 1, 48)), ("post", (64, 1, 0))):
        sh = sweep.sweep_shape(E, T, c[0], c[1], c[2], 0.0)
        smem, bits, stage = sweep.sweep_pass_layout(pa, sh)
        out.append((f"sweep_pass {tag}", smem, (stage, bits)))
    smem, bits, stage, _ = delta.random_ls_layout(pa, 8)
    out.append(("random_ls", smem, (stage, bits)))
    smem, bits, ring, stage = lahc.lahc_layout(pa, 16, 5000)
    out.append(("lahc", smem, (stage, bits, ring)))
    smem, occ, table, csr = local_search.full_eval_ls_layout(pa, 8)
    out.append(("full_eval_ls", smem, (occ, table, csr)))
    smem, stage, _ = rooms.assign_rooms_stage(pa)
    out.append(("assign_rooms", smem, stage))
    smem, stage, _ = rooms.parallel_rooms_stage(pa)
    out.append(("parallel_rooms", smem, stage))
    for par in (False, True):
        smem, stage, _ = ga.breed_stage(pa, par)
        out.append((f"breed {par}", smem, stage))
    smem, rows, _ = moves.relocate_stage(pa)
    out.append(("relocate", smem, rows))
    smem, occ = fitness.batch_penalty_stage(pa)
    out.append(("batch_penalty", smem, occ))
    return out


@pytest.mark.parametrize("E", [400, 2400, 4095])
def test_no_layout_exceeds_shared_memory_at_any_size(E):
    """At every corner of E < 4096 (400, 2,400, 4,095), R < 4096 (10, 80,
    400, 1,300, 4,095) and S <= 50,000 (200, 2,300, 10,000, 50,000), no
    kernel's block needs more shared memory than SMEM_LIMIT: what does
    not fit is read and written in global memory, so check_smem raises
    for none of them. On comp01s every kernel stages what it staged
    before the global branches (every region; the bytes are pinned by
    the *_smem_bytes_at_comp01s tests)."""
    for R in (10, 80, 400, 1300, 4095):
        for S in (200, 2300, 10_000, 50_000):
            for name, smem, _ in _layouts(_sized(E, R, S)):
                assert smem <= kernels.SMEM_LIMIT, (name, E, R, S, smem)
    comp = dict((n, st) for n, _, st in
                _layouts(load_tim_file(COMP01S).device_arrays()))
    assert comp == {
        "sweep_pass repair": (15, True), "sweep_pass post": (15, True),
        "random_ls": (7, True), "lahc": (7, True, True),
        "full_eval_ls": (True, True, True), "assign_rooms": 1,
        "parallel_rooms": 3, "breed False": 7, "breed True": 7,
        "relocate": 4, "batch_penalty": True}


def _past_smem(which, device):
    """Small instances past shared memory: 40 events and 2,700 students
    (an individual's attendance is 243,000 bytes: K5, K8 and K10 keep it
    in global memory), or 40 events and 1,300 rooms (a (45, R) int32
    occupancy is 234,000 bytes: K1, K2, K6, K9 and K12 keep theirs, and
    the matcher its words and rows, in global memory)."""
    if which == "students":
        return random_instance(61, n_events=40, n_rooms=10, n_features=3,
                               n_students=2700,
                               attend_prob=0.02).device_arrays(device)
    return random_instance(62, n_events=40, n_rooms=1300, n_features=3,
                           n_students=30,
                           attend_prob=0.1).device_arrays(device)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["students", "rooms", "forced"])
def test_kernels_past_shared_memory_equal_plain(cuda, monkeypatch, which):
    """Every kernel with a global-memory branch against its plain version
    on the card, exactly, where the sizes choose that branch (2,700
    students; 1,300 rooms) and with every such region forced into global
    memory (STAGE_LIMIT 0) on the anchored instance: K1, K6 (greedy,
    crowded, parallel, relocation), K9, K8, K12, K10, K2 at every
    cluster size and K5 at the repair and post shapes, every cluster
    size."""
    if which == "forced":
        monkeypatch.setattr(kernels, "STAGE_LIMIT", 0)
        pa = _instances(cuda)[3]
    else:
        pa = _past_smem(which, cuda)
    seed = {"students": 960, "rooms": 970, "forced": 980}[which]
    if which == "students":
        assert not delta.random_ls_layout(pa, 4)[2] & 4
    if which == "rooms":
        assert rooms.assign_rooms_stage(pa)[1] == 0
        assert not local_search.full_eval_ls_layout(pa, 4)[1]
    k1_k6_wide_equal_plain(pa, cuda, seed)
    _matcher_equals_plain(pa, cuda, seed + 1)
    k8_k12_wide_equal_plain(pa, cuda, seed + 2)
    k10_wide_equal_plain(pa, cuda, seed + 3)
    g = torch.Generator(device=cuda).manual_seed(seed + 4)
    slots = torch.randint(0, pa.n_slots, (5, pa.n_events), generator=g,
                          device=cuda, dtype=torch.int32)
    rms = torch.randint(0, pa.n_rooms, (5, pa.n_events), generator=g,
                        device=cuda, dtype=torch.int32)
    want = fitness.batch_penalty_plain(pa, slots, rms)
    for cs in fitness.K2_CLUSTERS:
        got = fitness.batch_penalty_kernel(pa, slots, rms, cs)
        assert all(torch.equal(w, x) for w, x in zip(want, got)), cs
    st = _state(pa, 2, seed + 5)
    for case in (K5_CASES[6], K5_CASES[7]):
        sb, be, side, hot, p3 = case
        sh = sweep.sweep_shape(pa.n_events, pa.n_slots, sb, be, hot, p3)
        draws = sweep.make_sweep_draws([g], 2, sh, pa.n_events, side, cuda)
        _k5_equals_plain(pa, st, draws, case, (None, 1, 2, 4, 8))


def test_random_ls_smem_bytes_at_comp01s():
    """K8's shared memory per individual on comp01s at K = 8: slots and
    rooms 3,200, two buffers of candidate records 1,152, the bitsets
    amask 1,600 and slot_ev 2,352, occ 912, att 18,000, a chunk of 256
    rounds' events 12,288, the epilogue's live-event words and reduction
    scratch 320 and the conflict bits 20,800."""
    pa = load_tim_file(COMP01S).device_arrays()
    assert delta.random_ls_smem_bytes(pa, 8) == 60_624


def test_full_eval_ls_smem_bytes_at_comp01s():
    """K12's shared memory per CTA on comp01s at K = 8: the current row
    and its candidate copy 14,704 (slots and rooms 3,200, int32
    occupancy 1,800, slot bitsets 2,352, each twice), reduction scratch
    256, two inboxes 1,024, a chunk of 109 rounds' draws 12,208, the
    per-event arrays 10,400 (four of 1,600 and the suitable rooms'
    4,000), the conflict bits 20,800 and the students' CSR 11,104."""
    pa = load_tim_file(COMP01S).device_arrays()
    assert local_search.full_eval_ls_smem_bytes(pa, 8) == 70_496


def test_full_eval_ls_refuses_before_it_launches(monkeypatch):
    """K12's wrapper refuses a cluster outside 1..min(K, 8) and a state
    above the shared-memory limit before anything launches; within them
    it gets as far as the CPU tensor the kernel cannot take."""
    pa = load_tim_file(COMP01S).device_arrays()
    rows = delta.init_rows(pa, *_state(pa, 2, 1)[:2])
    draws = _ls_draws(pa, "cpu", 2, 2, 4, 3)
    ev = delta.random_ls_events_plain(draws)
    kernels.reset_launches()
    for cs in (0, 5, 9):
        with pytest.raises(ValueError, match="cluster"):
            local_search.full_eval_ls_chain(pa, draws, rows, ev, cs)
    with pytest.raises(ValueError, match="CUDA device"):
        local_search.full_eval_ls_chain(pa, draws, rows, ev, 4)
    monkeypatch.setattr(local_search, "full_eval_ls_smem_bytes",
                        lambda pa, K: kernels.SMEM_LIMIT + 16)
    with pytest.raises(ValueError, match="shared memory"):
        local_search.full_eval_ls_chain(pa, draws, rows, ev)
    assert sum(kernels.LAUNCHES.values()) == 0


def test_lahc_smem_bytes_at_comp01s():
    """K10's shared memory per walker on comp01s at K = 16 and the lahc
    path's history of 5,000: slots, rooms and the best snapshot's 6,400,
    two buffers of candidate records 2,304, the bitsets amask 1,600 and
    slot_ev 2,352, occ 912, att 18,000, two chunks of 51 steps' draws
    (240 bytes a step) 24,480, the conflict bits 20,800 and the two
    history rings 40,000; at 30,000 the rings stay in global memory."""
    pa = load_tim_file(COMP01S).device_arrays()
    assert lahc.lahc_smem_bytes(pa, 16, 5000) == 116_848
    assert lahc.lahc_smem_bytes(pa, 16, 30_000) == 76_848


def test_sweep_pass_kernel_raises_above_the_shared_memory_limit(
        monkeypatch):
    """2,700 students x 45 slots of int16 attendance is 243,000 bytes:
    K5 keeps it in global memory (its one copy an individual, in the
    out rows) and gets as far as the CPU tensor the kernel cannot take,
    as a small instance does; a layout past the limit is refused by the
    bytes, before anything launches."""
    big = random_instance(5, n_events=12, n_rooms=3, n_features=2,
                          n_students=2700, attend_prob=0.05).device_arrays()
    small = random_instance(5, n_events=12, n_rooms=3, n_features=2,
                            n_students=20, attend_prob=0.2).device_arrays()
    for pa in (big, small):
        st = _state(pa, 2, 1)
        sh = sweep.sweep_shape(pa.n_events, pa.n_slots, 2, 1, 0, 0.0)
        draws = sweep.make_sweep_draws([torch.Generator().manual_seed(0)],
                                       2, sh, pa.n_events, 0.0, "cpu")
        smem, _, stage = sweep.sweep_pass_layout(pa, sh)
        assert smem <= sweep.SMEM_LIMIT
        # att in global memory at 2,700 students, every region staged at 20
        assert stage == (sweep.K5_STAGE_MASKS | 3 if pa is big else 15)
        kernels.reset_launches()
        with pytest.raises(ValueError, match="CUDA device"):
            sweep.sweep_pass_kernel(pa, draws, st, 2)
        assert sum(kernels.LAUNCHES.values()) == 0
    monkeypatch.setattr(sweep, "sweep_pass_layout",
                        lambda pa, sh: (sweep.SMEM_LIMIT + 16, False, 15))
    with pytest.raises(ValueError, match="shared memory"):
        sweep.sweep_pass_kernel(pa, draws, st, 2)
    assert sum(kernels.LAUNCHES.values()) == 0


def test_k2_cluster_size_choice():
    """K2's CTAs per individual: the largest power of two up to 8 whose
    P x CS CTAs fit one to an SM (132 on an H100 SXM); sizes other than
    1, 2, 4 and 8 are refused before anything launches."""
    assert fitness.penalty_cluster_size(4, 132) == 8    # the post phase
    assert fitness.penalty_cluster_size(16, 132) == 8   # the repair phase
    assert fitness.penalty_cluster_size(10, 132) == 8   # the reference
    assert fitness.penalty_cluster_size(33, 132) == 4
    assert fitness.penalty_cluster_size(66, 132) == 2
    assert fitness.penalty_cluster_size(67, 132) == 1
    assert fitness.penalty_cluster_size(256, 132) == 1
    pa = load_tim_file(COMP01S).device_arrays()
    st = _state(pa, 2, 1)
    kernels.reset_launches()
    for cs in (0, 3, 16):
        with pytest.raises(ValueError, match="cluster"):
            fitness.batch_penalty_kernel(pa, st.slots, st.rooms, cs)
    assert sum(kernels.LAUNCHES.values()) == 0


def test_k2_student_split_balances_the_csr_entries():
    """ProblemArrays.stu_split: for CS = 1, 2, 4, 8 the students split
    into CS contiguous ranges that cover them all, each range's CSR
    entries within one student's of nnz / CS."""
    pa = load_tim_file(COMP01S).device_arrays()
    split = pa.stu_split.tolist()
    ptr = pa.stu_ptr.tolist()
    nnz, S = ptr[-1], pa.n_students
    most = max(b - a for a, b in zip(ptr, ptr[1:]))
    off = 0
    for cs in (1, 2, 4, 8):
        st, en = split[off:off + cs + 1], split[off + cs + 1:off + 2 * cs + 2]
        off += 2 * (cs + 1)
        assert st[0] == 0 and st[-1] == S and st == sorted(st)
        assert en == [ptr[s] for s in st]
        assert all(b - a <= -(-nnz // cs) + most for a, b in zip(en, en[1:]))
    assert off == len(split)
    assert pa.stu_split.device.type == "cpu"


def test_k5_cluster_size_choice():
    """K5's CTAs per individual: a warp for each Move2/Move3 candidate of
    a step, as a power of two, capped at 8 and at the SMs per individual
    (132 on an H100 SXM)."""
    assert sweep.cluster_size(64, 4, 132) == 4      # the post pass
    assert sweep.cluster_size(8, 16, 132) == 1      # the repair pass
    assert sweep.cluster_size(8, 256, 132) == 1
    assert sweep.cluster_size(0, 1, 132) == 1       # Move1 only
    assert sweep.cluster_size(17, 1, 132) == 2
    assert sweep.cluster_size(400, 1, 132) == 8
    assert sweep.cluster_size(64, 40, 132) == 3     # 132 // 40 SMs each
    pa = load_tim_file(COMP01S).device_arrays()
    post = sweep.sweep_shape(400, 45, 64, 1, 0, 0.0)
    assert post.n_cand - post.B * pa.n_slots == 64
    st = _state(pa, 2, 1)
    draws = sweep.make_sweep_draws([torch.Generator().manual_seed(0)], 2,
                                   post, 400, 0.25, "cpu")
    for cs in (0, 9):
        with pytest.raises(ValueError, match="cluster"):
            sweep.sweep_pass_kernel(pa, draws, st, 64, 1, 0.25, 0, 0.0,
                                    cluster=cs)


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port, and not chip_smoke.py, has an import of
    jax or of timetabling_ga_tpu (a grep of the sources)."""
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|timetabling_ga_tpu)"
                     r"(?:\.|\s|$)", re.M)
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root,
                                            "timetabling_ga_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad


def test_signatures_match_the_c_entry_points():
    """Each SIGNATURES entry binds its C entry point's parameters, in
    order, as pointers or ints, then the stream: a missing int would pass
    the stream pointer through an int slot (a grep of the sources)."""
    import re
    for name, (sym, argtypes, src) in kernels.SIGNATURES.items():
        text = (kernels.CSRC / f"{src}.cu").read_text()
        m = re.search(r'extern "C" int ' + sym + r"\((.*?)\)\s*\{", text,
                      re.S)
        assert m, name
        kinds = ["P" if "*" in p else "I" for p in m.group(1).split(",")]
        bound = ["P" if a is ctypes.c_void_p else "I" for a in argtypes]
        assert kinds == bound, name


def test_library_paths_are_keyed_by_source_hash():
    paths = {s: kernels._lib_path(s) for s in kernels.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for src, path in paths.items():
        assert path.parent == kernels.BUILD_DIR
        assert path.name.startswith(src + "-")
        assert (kernels.CSRC / f"{src}.cu").exists()
    assert sorted(n for ns in kernels.SOURCES.values() for n in ns) == \
        sorted(kernels.SIGNATURES)
    assert kernels.SOURCES["breed"] == ["breed", "relocate"]
    assert kernels.SOURCES["survivors"] == ["survivors", "migrate"]
    assert kernels.SOURCES["random_ls"] == ["random_ls_events", "random_ls"]
    assert kernels.SOURCES["full_eval_ls"] == ["full_eval_ls"]
    assert kernels.SOURCES["nsga"] == ["nsga_rank", "nsga_survivors"]
    assert kernels.SOURCES["trace_compress"] == ["compress_trace",
                                                 "moment_rows"]
    assert kernels.SOURCES["quality"] == ["quality_ops", "div_stats"]
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    # every local header a source includes is part of its key
    assert [p.name for p in kernels._sources("sweep_pass")] == [
        "sweep_pass.cu", "sweep_dev.cuh", "common.cuh"]
    assert [p.name for p in kernels._sources("lahc")] == [
        "lahc.cu", "sweep_dev.cuh", "rooms_dev.cuh", "common.cuh"]
    # the full evaluation's body: K2's own launch, K6's and K8's epilogues
    assert [p.name for p in kernels._sources("random_ls")] == [
        "random_ls.cu", "penalty_dev.cuh", "sweep_dev.cuh", "rooms_dev.cuh",
        "common.cuh"]
    assert [p.name for p in kernels._sources("full_eval_ls")] == [
        "full_eval_ls.cu", "penalty_dev.cuh", "rooms_dev.cuh", "common.cuh"]
    assert [p.name for p in kernels._sources("breed")] == [
        "breed.cu", "penalty_dev.cuh", "rooms_dev.cuh", "common.cuh"]
    assert [p.name for p in kernels._sources("batch_penalty")] == [
        "batch_penalty.cu", "penalty_dev.cuh", "common.cuh"]
    # K7's row copy, also K11's
    assert [p.name for p in kernels._sources("survivors")] == [
        "survivors.cu", "rows_dev.cuh", "common.cuh"]
    assert [p.name for p in kernels._sources("nsga")] == [
        "nsga.cu", "rows_dev.cuh", "common.cuh"]
    assert [p.name for p in kernels._sources("trace_compress")] == [
        "trace_compress.cu", "common.cuh"]
    assert [p.name for p in kernels._sources("quality")] == [
        "quality.cu", "common.cuh"]


def test_conflict_bits_and_csr_encode_the_problem():
    pa = padded_arrays(random_instance(4, n_events=50, n_rooms=4,
                                       n_features=3, n_students=40,
                                       attend_prob=0.1))
    bits = pa.conflict_bits.numpy().view(np.uint32)
    E = pa.n_events
    dec = ((bits[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1)
    dec = dec.reshape(E, -1)[:, :E].astype(bool)
    np.testing.assert_array_equal(dec, pa.conflict.numpy() > 0.5)
    att = pa.attends.numpy() > 0.5
    ptr, ev = pa.stu_ptr.numpy(), pa.stu_ev.numpy()
    for s in range(pa.n_students):
        assert ev[ptr[s]:ptr[s + 1]].tolist() == np.nonzero(att[s])[0].tolist()
    ptr, st = pa.ev_ptr.numpy(), pa.ev_stu.numpy()
    for e in range(E):
        assert st[ptr[e]:ptr[e + 1]].tolist() == \
            np.nonzero(att[:, e])[0].tolist()
    assert pa.max_ev_students == int(att.sum(0).max())
