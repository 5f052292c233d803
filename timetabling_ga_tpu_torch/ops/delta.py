"""Delta candidate evaluation (port of timetabling_ga_tpu/ops/delta.py:50-208).

Maintained per-individual tensors:

    att (P, S, T) int16   per-(student, slot) attended-event counts
    occ (P, T, R) int16   per-(slot, room) occupancy counts

A candidate is a padded 3-relocation (events, new slots, active flags).
`delta_one` is the wrapper of kernel K4 (csrc/delta_one.cu), batched
over `(P, C)` candidates; `delta_one_plain` is its plain version, the
JAX `_delta_one` written out over the same batch. `apply_moves`
commits one accepted candidate per individual.

`batch_local_search_delta` is the random-candidate local search (JAX
delta.py:212): rounds of K random candidates per individual, scored by
delta, the first least penalty accepted on a strict improvement.
`random_local_search` is the wrapper of kernel K8 (csrc/random_ls.cu):
a pre-pass that takes every candidate's events
(`random_ls_events_kernel`), then all rounds in one launch
(`random_ls_chain`);
`random_local_search_plain` is its plain version, a Python loop over
the rounds. Both take and return `LSRows`
(assignments and penalty terms; K8 builds att and occ itself) and take
their draws as `LSDraws`.

On the serve path the search takes a `problem.LaneProblems` in place of
the ProblemArrays, each lane a block of equal rows with its own problem:
K8's chain reads each lane's problem from the lane table, and the plain
version runs each lane's rows on its own ProblemArrays.

`slot_bitsets` is the plain version of the two bitsets K5, K8 and K10
keep beside att in shared memory (a student's attended slots, each
slot's events), and `apply_bitsets` of how their apply keeps them up to
date.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from timetabling_ga_tpu_torch import kernels, work
from timetabling_ga_tpu_torch.obs import prof as obs_prof
from timetabling_ga_tpu_torch.ops import fitness
from timetabling_ga_tpu_torch.ops.fitness import gather_rows
from timetabling_ga_tpu_torch.ops.moves import (
    MoveDraws, move_probs, sample_move, top3)
from timetabling_ga_tpu_torch.ops.rooms import choose_room, occupancy
from timetabling_ga_tpu_torch.problem import LaneProblems


class LSState(NamedTuple):
    """Per-population local-search state (all leading-axis P)."""

    slots: torch.Tensor   # (P, E) int32
    rooms: torch.Tensor   # (P, E) int32
    att: torch.Tensor     # (P, S, T) int16
    occ: torch.Tensor     # (P, T, R) int16
    pen: torch.Tensor     # (P,) int32
    hcv: torch.Tensor     # (P,) int32
    scv: torch.Tensor     # (P,) int32


class LSRows(NamedTuple):
    """A population's rows as the random-candidate search takes and
    returns them: the assignments and their penalty terms."""

    slots: torch.Tensor   # (P, E) int32
    rooms: torch.Tensor   # (P, E) int32
    pen: torch.Tensor     # (P,) int32
    hcv: torch.Tensor     # (P,) int32
    scv: torch.Tensor     # (P,) int32


def attendance_counts(pa, slots) -> torch.Tensor:
    """(P, S, T) int32 attendance counts by index arithmetic."""
    P, E = slots.shape
    S = pa.n_students
    att = torch.zeros((P, S, pa.n_slots), dtype=torch.int32,
                      device=slots.device)
    src = pa.attends_u8.to(torch.int32)[None].expand(P, S, E)
    att.scatter_add_(2, slots.long()[:, None, :].expand(P, S, E), src)
    return att


def init_rows(pa, slots, rooms, scores=None) -> LSRows:
    """A population's rows with their penalty terms: `scores` (penalty,
    hcv, scv) where the caller holds them (the children K6 scored), else
    K2's."""
    if scores is None:
        scores = fitness.batch_penalty(pa, slots, rooms)
    return LSRows(slots, rooms, *scores)


def state_of(pa, rows: LSRows) -> LSState:
    """The maintained tensors of scored rows."""
    att = attendance_counts(pa, rows.slots).to(torch.int16)
    occ = occupancy(pa, rows.slots, rows.rooms).to(torch.int16)
    return LSState(slots=rows.slots, rooms=rows.rooms, att=att, occ=occ,
                   pen=rows.pen, hcv=rows.hcv, scv=rows.scv)


@obs_prof.scope("tt.delta")
def init_state(pa, slots, rooms, scores=None) -> LSState:
    """Maintained tensors + baseline fitness for a population (`scores`
    as init_rows takes them)."""
    return state_of(pa, init_rows(pa, slots, rooms, scores))


def slot_bitsets(pa, slots, att):
    """The two bitsets K5, K8 and K10 keep beside att in shared memory:
    amask (P, S) int64, bit t of student s set iff att[s, t] > 0, and
    slot_ev (P, T, W) int32, bit f % 32 of word f // 32 of row t set iff
    slots[f] == t (W = the conflict bitset's words per row). The plain
    version of their prologue's build (csrc/sweep_dev.cuh)."""
    P, E = slots.shape
    T, W = pa.n_slots, pa.conflict_bits.shape[1]
    dev = slots.device
    i64 = torch.int64
    one = torch.ones((), dtype=i64, device=dev)
    bit_t = torch.bitwise_left_shift(one, torch.arange(T, device=dev))
    amask = ((att > 0).to(i64) * bit_t).sum(-1)
    in_slot = torch.zeros((P, W * 32, T), dtype=i64, device=dev)
    in_slot[:, :E] = (slots.long()[..., None]
                      == torch.arange(T, device=dev)).to(i64)
    bit_f = torch.bitwise_left_shift(one, torch.arange(32, device=dev))
    words = (in_slot.view(P, W, 32, T) * bit_f[:, None]).sum(2)  # (P, W, T)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return amask, words.transpose(1, 2).to(torch.int32).contiguous()


def apply_bitsets(pa, amask, slot_ev, att, slots, evs, new_slots, accept):
    """amask and slot_ev kept up to date through one apply_moves of the
    candidate (P, 3) where `accept` (P,) holds, as K5's, K8's and K10's
    apply keeps them: `att` is the attendance after the move, `slots`
    the slots before it. Only the students of the events that change slot
    have their bits of those events' old and new slots recomputed, and
    each such event's bit moves from its old slot's row of slot_ev to its
    new one's. The plain version of csrc/sweep_dev.cuh
    tt_apply_move_bits_block's bookkeeping."""
    P, S = amask.shape
    T, W = pa.n_slots, slot_ev.shape[2]
    i64 = torch.int64
    evl = evs.long()
    old = gather_rows(slots, evs).long()
    ns = new_slots.long()
    moving = accept[:, None] & (old != ns)                    # (P, 3)
    cols = pa.attends_u8.t()[evl] > 0                         # (P, 3, S)
    one = torch.ones((), dtype=i64, device=amask.device)
    amask = amask.clone()
    for m in range(3):
        touched = moving[:, m, None] & cols[:, m]             # (P, S)
        for t in (old[:, m], ns[:, m]):
            on = att.gather(2, t[:, None, None].expand(P, S, 1))[..., 0] > 0
            b = torch.bitwise_left_shift(one, t)[:, None]
            amask = torch.where(touched, torch.where(on, amask | b,
                                                     amask & ~b), amask)
    words = slot_ev.reshape(P, T * W).clone()
    w = evl // 32
    b = torch.bitwise_left_shift(torch.ones((), dtype=torch.int32,
                                            device=amask.device),
                                 (evl % 32).to(torch.int32))
    for m in range(3):
        for row, keep in ((old, lambda x, y: x & ~y), (ns, torch.bitwise_or)):
            idx = row[:, m:m + 1] * W + w[:, m:m + 1]
            cur = words.gather(1, idx)
            words.scatter_(1, idx, torch.where(
                moving[:, m:m + 1], keep(cur, b[:, m:m + 1]), cur))
    return amask, words.view(P, T, W)


def _day_scv(b: torch.Tensor) -> torch.Tensor:
    """scv of boolean day attendance (..., S, spd) -> (...,): runs of
    >= 3 (+1 per extra class) and single-class days."""
    consec = (b[..., 2:] & b[..., 1:-1] & b[..., :-2]).to(
        torch.int32).sum((-2, -1))
    single = (b.sum(-1) == 1).to(torch.int32).sum(-1)
    return consec + single


def delta_one_plain(pa, slots, rooms, att, occ, evs, new_slots, active):
    """Plain version of K4: candidates evs/new_slots (P, C, 3) int32 and
    active (P, C, 3) bool on individuals (P, ...) -> d_hcv (P, C),
    d_scv (P, C), new_rooms (P, C, 3), all int32."""
    P, C, _ = evs.shape
    T, R, S, spd = pa.n_slots, pa.n_rooms, pa.n_students, pa.slots_per_day
    dev = slots.device
    pi = torch.arange(P, device=dev)[:, None].expand(P, C)
    ci = torch.arange(C, device=dev)[None, :].expand(P, C)
    evl = evs.long()
    old_slots = gather_rows(slots, evs)
    old_rooms = gather_rows(rooms, evs)
    act = active.to(torch.int32) * pa.live[evl]

    # ---- room-pair clashes + greedy re-rooming, replayed on occ
    occ32 = occ.to(torch.int32)[:, None].expand(P, C, T, R).clone()
    pair_d = torch.zeros((P, C), dtype=torch.int32, device=dev)
    for m in range(3):
        idx = (pi, ci, old_slots[..., m].long(), old_rooms[..., m].long())
        pair_d -= act[..., m] * (occ32[idx] - 1)
        occ32[idx] -= act[..., m]
    new_rooms = []
    for m in range(3):
        ns = new_slots[..., m].long()
        r_choice = choose_room(pa, occ32[pi, ci, ns], evs[..., m],
                               pa.cap_rank)
        r_new = torch.where(active[..., m], r_choice, old_rooms[..., m])
        idx = (pi, ci, ns, r_new.long())
        pair_d += act[..., m] * occ32[idx]
        occ32[idx] += act[..., m]
        new_rooms.append(r_new)
    new_rooms = torch.stack(new_rooms, -1)

    # ---- unsuitable-room delta
    unsuit_d = ((~pa.possible[evl, new_rooms.long()]).to(torch.int32)
                - (~pa.possible[evl, old_rooms.long()]).to(torch.int32)
                ).sum(-1)

    # ---- correlation delta: moved x unmoved rows, then moved x moved
    E = slots.shape[1]
    in_m = torch.zeros((P, C, E), dtype=torch.float32, device=dev)
    in_m.scatter_(2, evl, 1.0)
    corr_d = torch.zeros((P, C), dtype=torch.float32, device=dev)
    s_b = slots[:, None, :]
    for m in range(3):
        row = pa.conflict[evl[..., m]] * (1.0 - in_m)
        eq_new = (s_b == new_slots[..., m, None]).to(torch.float32)
        eq_old = (s_b == old_slots[..., m, None]).to(torch.float32)
        corr_d += (row * (eq_new - eq_old)).sum(-1)
    for m in range(3):
        for mm in range(m + 1, 3):
            c = pa.conflict[evl[..., m], evl[..., mm]]
            corr_d += c * (
                (new_slots[..., m] == new_slots[..., mm]).to(torch.float32)
                - (old_slots[..., m] == old_slots[..., mm]).to(
                    torch.float32))
    d_hcv = pair_d + unsuit_d + corr_d.to(torch.int32)

    # ---- scv: last-slot term
    sc = pa.student_count[evl]
    last_d = (torch.where(new_slots % spd == spd - 1, sc, 0)
              - torch.where(old_slots % spd == spd - 1, sc, 0)).sum(-1)

    # ---- scv: affected days (<= 6, deduplicated)
    days = torch.cat([old_slots // spd, new_slots // spd], -1)  # (P, C, 6)
    j = torch.arange(spd, device=dev)
    att32 = att.to(torch.int32)
    cols = pa.attends_u8.to(torch.int32).t()[evl]        # (P, C, 3, S)
    scv_days = torch.zeros((P, C), dtype=torch.int32, device=dev)
    for i in range(6):
        d = days[..., i]
        unique = (days[..., :i] != d[..., None]).all(-1)
        tidx = (d[..., None] * spd + j).long()           # (P, C, spd)
        before = att32[pi[..., None, None],
                       torch.arange(S, device=dev)[None, None, :, None],
                       tidx[:, :, None, :]]               # (P, C, S, spd)
        patch = before.clone()
        for m in range(3):
            oh_old = ((j == (old_slots[..., m, None] % spd))
                      & ((old_slots[..., m] // spd) == d)[..., None])
            oh_new = ((j == (new_slots[..., m, None] % spd))
                      & ((new_slots[..., m] // spd) == d)[..., None])
            patch += cols[:, :, m, :, None] * (
                oh_new.to(torch.int32) - oh_old.to(torch.int32))[:, :, None]
        dlt = _day_scv(patch > 0) - _day_scv(before > 0)
        scv_days += torch.where(unique, dlt, 0)
    d_scv = last_d + scv_days
    return d_hcv.to(torch.int32), d_scv.to(torch.int32), new_rooms


@obs_prof.scope("tt.delta")
def delta_one(pa, slots, rooms, att, occ, evs, new_slots, active):
    """Delta of padded 3-relocation candidates (P, C, 3) on individuals
    (P, ...): (d_hcv (P, C), d_scv (P, C), new_rooms (P, C, 3)). Kernel
    K4 on CUDA tensors (the wrapper builds the bitsets its body reads
    with their plain version, slot_bitsets), the plain version on CPU
    ones."""
    if not slots.is_cuda:
        kernels.tally(work.delta_one(pa, slots, att, occ, evs))
        return delta_one_plain(pa, slots, rooms, att, occ, evs, new_slots,
                               active)
    P, C, _ = evs.shape
    if att.dtype != torch.int16 or occ.dtype != torch.int16:
        raise TypeError("delta_one takes int16 att/occ")
    args = [x.contiguous() for x in (slots, rooms, att, occ,
                                     *slot_bitsets(pa, slots, att),
                                     evs.to(torch.int32),
                                     new_slots.to(torch.int32),
                                     active.to(torch.uint8))]
    d = torch.empty((2, P, C), dtype=torch.int32, device=slots.device)
    new_rooms = torch.empty((P, C, 3), dtype=torch.int32,
                            device=slots.device)
    if P * C == 0:
        return d[0], d[1], new_rooms
    p = kernels.ptr
    kernels.launch(
        "delta_one", *(p(a) for a in args), p(pa.possible_u8), p(pa.live),
        p(pa.student_count), p(pa.conflict_bits), p(pa.cap_rank),
        p(pa.dead), p(pa.attends_u8), p(pa.ev_ptr), p(pa.ev_stu), p(d[0]),
        p(d[1]), p(new_rooms), P, C, slots.shape[1], pa.n_rooms,
        pa.n_students, pa.n_slots, pa.slots_per_day,
        pa.conflict_bits.shape[1],
        work=work.delta_one(pa, slots, att, occ, evs))
    return d[0], d[1], new_rooms


@obs_prof.scope("tt.delta")
def apply_moves(pa, slots, rooms, att, occ, evs, new_slots, new_rooms,
                accept):
    """Commit one candidate (P, 3) per individual where `accept` (P,)
    holds; elsewhere the state is unchanged. Inactive pad entries
    (new == old) cancel in every update (JAX delta.py:188)."""
    P = slots.shape[0]
    S, T, R = pa.n_students, pa.n_slots, pa.n_rooms
    w = accept.to(att.dtype)
    evl = evs.long()
    old_slots = gather_rows(slots, evs).long()
    old_rooms = gather_rows(rooms, evs).long()
    ns = new_slots.long()
    # attendance: -col at the old slots, +col at the new, per row
    cols = pa.attends_u8.t()[evl].to(att.dtype) * w[:, None, None]
    s_base = torch.arange(S, device=slots.device) * T        # (S,)
    idx = torch.cat([s_base + old_slots[..., None],
                     s_base + ns[..., None]], 1).reshape(P, -1)
    att = att.reshape(P, S * T).scatter_add(
        1, idx, torch.cat([-cols, cols], 1).reshape(P, -1)).reshape(
        P, S, T)
    # occupancy: live events leave their old cells, enter the new ones
    live = pa.live[evl].to(occ.dtype) * w[:, None]          # (P, 3)
    idx = torch.cat([old_slots * R + old_rooms,
                     ns * R + new_rooms.long()], 1)
    occ = occ.reshape(P, T * R).scatter_add(
        1, idx, torch.cat([-live, live], 1)).reshape(P, T, R)
    keep = accept[:, None]
    slots = torch.where(keep, slots.scatter(1, evl, new_slots.to(
        slots.dtype)), slots)
    rooms = torch.where(keep, rooms.scatter(1, evl, new_rooms.to(
        rooms.dtype)), rooms)
    return slots, rooms, att, occ


class LSDraws(NamedTuple):
    """The draws of one random-candidate local search call: candidate c
    of individual p in round r is row (r, c, p) of every field."""

    mtype: torch.Tensor   # (n_rounds, K, P) int  0 Move1 / 1 Move2 / 2 Move3
    u: torch.Tensor       # (n_rounds, K, P, E) f32 uniforms (top 3 = events)
    t: torch.Tensor       # (n_rounds, K, P) int  Move1 target slot


def make_ls_draws(gens, rows_per_gen: int, n_rounds: int,
                  n_candidates: int, n_events: int, n_slots: int,
                  p1: float, p2: float, p3: float, device) -> LSDraws:
    """LSDraws for len(gens) * rows_per_gen individuals, each generator
    drawing its own block of individuals in one call per field."""
    probs = move_probs(p1, p2, p3, device)
    shape = (n_rounds, n_candidates, rows_per_gen)
    parts = []
    for g in gens:
        parts.append((
            torch.multinomial(probs, n_rounds * n_candidates * rows_per_gen,
                              replacement=True, generator=g).reshape(shape),
            torch.rand(shape + (n_events,), generator=g, device=device),
            torch.randint(0, n_slots, shape, generator=g, device=device,
                          dtype=torch.int32)))
    if len(parts) == 1:
        return LSDraws(*parts[0])
    return LSDraws(*(torch.cat([p[i] for p in parts], 2) for i in range(3)))


def round_candidates(pa, draws: LSDraws, r: int, slots):
    """Round r's candidates of every individual: evs, new_slots (P, K, 3)
    int32 and active (P, K, 3) bool, each sample_move's padded form."""
    K, P = draws.mtype.shape[1:]
    md = MoveDraws(draws.mtype[r].t().reshape(-1),
                   draws.u[r].transpose(0, 1).reshape(P * K, -1),
                   draws.t[r].t().reshape(-1))
    out = sample_move(pa, md, slots.repeat_interleave(K, 0))
    return tuple(x.reshape(P, K, 3) for x in out)


def random_local_search_plain(pa, draws: LSDraws, rows: LSRows) -> LSRows:
    """Plain version of K8: every round's K candidates scored by
    delta_one_plain, the first of least anchored penalty (jnp.argmin)
    accepted where strictly below the individual's (delta.py:240-272);
    the rows it returns carry a full evaluation (batch_penalty_plain), as
    K8's epilogue writes one."""
    st = state_of(pa, rows)
    P = st.slots.shape[0]
    ar = torch.arange(P, device=st.slots.device)
    for r in range(draws.mtype.shape[0]):
        evs, ns, act = round_candidates(pa, draws, r, st.slots)
        d_hcv, d_scv, nr = delta_one_plain(pa, st.slots, st.rooms, st.att,
                                           st.occ, evs, ns, act)
        anc = st.pen - fitness.base_penalty(st.hcv, st.scv)
        new_hcv = st.hcv[:, None] + d_hcv
        new_scv = st.scv[:, None] + d_scv
        new_pen = (fitness.base_penalty(new_hcv, new_scv) + anc[:, None]
                   + fitness.anchor_delta(pa, st.slots, evs, ns)
                   ).to(torch.int32)
        best = torch.argmin(new_pen, 1)
        best_pen = new_pen[ar, best]
        better = best_pen < st.pen
        slots, rooms, att, occ = apply_moves(
            pa, st.slots, st.rooms, st.att, st.occ, evs[ar, best],
            ns[ar, best], nr[ar, best], better)
        st = LSState(slots, rooms, att, occ,
                     torch.where(better, best_pen, st.pen),
                     torch.where(better, new_hcv[ar, best], st.hcv),
                     torch.where(better, new_scv[ar, best], st.scv))
    return LSRows(st.slots, st.rooms,
                  *fitness.batch_penalty_plain(pa, st.slots, st.rooms))


# bytes of shared memory K8 gives one chunk of rounds' events (at least
# one round), csrc/random_ls.cu K8_EVENT_BYTES, and the most warps of its
# block, K8_MAX_WARPS
K8_EVENT_BYTES = 12288
K8_MAX_WARPS = 16


def a16(*xs) -> int:
    """The sum of sizes each rounded up to 16 bytes."""
    return sum(-(-x // 16) * 16 for x in xs)


def state_regions(pa) -> list:
    """Bytes of an individual's state regions that grow with the
    students or the rooms, in the order the K4-body kernels' hot loops
    read them most (csrc/sweep_dev.cuh TT_STAGE_*: occ, amask, att; the
    bitset body reads att only for the <= 6 slots a move touches)."""
    S, T, R = pa.n_students, pa.n_slots, pa.n_rooms
    return [2 * T * R, 8 * S, 2 * S * T]


def global_row_bytes(pa, stage: int) -> int:
    """Bytes of an individual's global scratch row: the state regions
    not staged (amask, att, occ in that order, each rounded up to 16
    bytes: csrc/random_ls.cu and lahc.cu g_bytes)."""
    occ, amask, att = state_regions(pa)
    return a16(*(x for x, bit in ((amask, 2), (att, 4), (occ, 1))
                 if not stage & bit))


def random_ls_layout(pa, n_candidates: int) -> tuple:
    """Dynamic shared memory K8 takes per individual, the layout of
    csrc/random_ls.cu `k8_smem_layout`: slots, rooms, two buffers of 18
    ints per candidate, slot_ev (T x W words), one chunk of rounds'
    events (6 B a candidate) and the epilogue's live-event words and
    reduction scratch (W + 4 x K8_MAX_WARPS ints), each rounded up to 16
    bytes; occ, amask (8 B a student) and att where they fit
    (kernels.stage_regions; else the individual's global scratch row);
    plus the conflict bitset when the total still fits in SMEM_LIMIT
    (else K8 reads it from global memory). Returns (bytes, bits staged,
    the stage mask, scratch bytes an individual)."""
    E, T = pa.n_events, pa.n_slots
    W = pa.conflict_bits.shape[1]
    K = n_candidates
    chunk = max(1, K8_EVENT_BYTES // (6 * K))
    base = a16(4 * E, 4 * E, 2 * 4 * 18 * K, 4 * T * W, 6 * K * chunk,
               4 * (W + 4 * K8_MAX_WARPS))
    total, flags = kernels.stage_regions(base, state_regions(pa))
    stage = kernels.stage_bits(flags)
    with_bits = total + a16(4 * E * W)
    if with_bits <= kernels.SMEM_LIMIT:
        return with_bits, True, stage, global_row_bytes(pa, stage)
    return total, False, stage, global_row_bytes(pa, stage)


def random_ls_smem_bytes(pa, n_candidates: int) -> int:
    """Dynamic shared memory K8 takes per individual (random_ls_layout)."""
    return random_ls_layout(pa, n_candidates)[0]


def random_ls_events_plain(draws: LSDraws) -> torch.Tensor:
    """Plain version of K8's pre-pass: the events of every candidate of
    every round, the top 3 of its uniforms (moves.top3), as (P,
    n_rounds, K, 3) int16."""
    n_rounds, K, P, E = draws.u.shape
    ev = top3(draws.u.reshape(-1, E)).reshape(n_rounds, K, P, 3)
    return ev.permute(2, 0, 1, 3).to(torch.int16).contiguous()


def random_ls_events_kernel(draws: LSDraws) -> torch.Tensor:
    """Kernel K8's pre-pass (random_ls_events): one warp per draw row
    over the whole card."""
    n_rounds, K, P, E = draws.u.shape
    if draws.u.dtype != torch.float32:
        raise TypeError("random_ls_events takes float32 uniforms")
    u = draws.u.contiguous()
    out = torch.empty((P, n_rounds, K, 3), dtype=torch.int16,
                      device=u.device)
    if out.numel() == 0:
        return out
    kernels.launch("random_ls_events", kernels.ptr(u), kernels.ptr(out), P,
                   E, K, n_rounds, work=work.random_ls_events(draws))
    return out


def random_ls_lanes_plain(lp: LaneProblems, draws: LSDraws,
                          rows: LSRows) -> LSRows:
    """Plain version of K8 with a lane table: each lane's block of rows
    searched by random_local_search_plain on its own ProblemArrays."""
    P = rows.slots.shape[0]
    n = P // len(lp)
    parts = []
    for lane, pa in enumerate(lp.pas):
        sl = slice(lane * n, (lane + 1) * n)
        parts.append(random_local_search_plain(
            pa, LSDraws(*(x[:, :, sl] for x in draws)),
            LSRows(*(x[sl] for x in rows))))
    return LSRows(*(torch.cat(x) for x in zip(*parts)))


def random_ls_chain(pa, draws: LSDraws, rows: LSRows,
                    events: torch.Tensor) -> LSRows:
    """K8's chain (random_ls) on CUDA tensors, given every candidate's
    events from the pre-pass: every round for every individual in one
    launch, one block per individual. With `pa` a LaneProblems each
    lane is an equal block of the individuals and each block reads its
    lane's problem from the lane table (launches count as
    random_ls_lanes). Raises ValueError when one individual's state does
    not fit in shared memory; no fallback."""
    lanes, lane_rows = None, 0
    if isinstance(pa, LaneProblems):
        if rows.slots.shape[0] % len(pa):
            raise ValueError("random_ls: the rows do not split into the "
                             "lanes")
        lanes, lane_rows = pa.table, rows.slots.shape[0] // len(pa)
        lane_pa, pa = pa, pa.first
    n_rounds, K, P = draws.mtype.shape
    E = rows.slots.shape[1]
    smem, _, stage, scratch = random_ls_layout(pa, K)
    kernels.check_smem("random_ls", smem)
    if any(x.dtype != torch.int32 for x in rows):
        raise TypeError("random_ls takes int32 slots, rooms, pen, hcv and "
                        "scv")
    if tuple(events.shape) != (P, n_rounds, K, 3) or \
            events.dtype != torch.int16 or rows.slots.shape[0] != P:
        raise ValueError("random_ls: the draws do not fit the population")
    i32 = torch.int32
    ins = [x.contiguous() for x in rows]
    dr = [draws.mtype.to(i32).contiguous(), events.contiguous(),
          draws.t.to(i32).contiguous()]
    out = LSRows(*(torch.empty_like(x) for x in ins))
    if P == 0:
        return out
    # a row an individual (one block each, alive for the whole call)
    buf = (torch.empty(P * scratch, dtype=torch.uint8,
                       device=ins[0].device) if scratch else None)
    p = kernels.ptr
    kernels.launch(
        "random_ls" if lanes is None else "random_ls_lanes",
        *(p(x) for x in ins + dr), p(pa.possible_u8),
        p(pa.live), p(pa.student_count), p(pa.conflict_bits),
        p(pa.cap_rank), p(pa.dead), p(pa.attends_u8), p(pa.ev_ptr),
        p(pa.ev_stu), p(pa.stu_ptr), p(pa.stu_ev), p(pa.anchor_slots),
        p(pa.anchor_w), None if lanes is None else p(lanes),
        *(p(x) for x in out), None if buf is None else p(buf), P, E,
        pa.n_rooms, pa.n_students, pa.n_slots, pa.slots_per_day,
        pa.conflict_bits.shape[1], K, n_rounds, int(pa.anchored),
        pa.conflict_diag, lane_rows, stage,
        work=work.random_ls(pa if lanes is None else lane_pa, draws, rows))
    return out


def random_local_search_kernel(pa, draws: LSDraws, rows: LSRows) -> LSRows:
    """Kernel K8 on CUDA tensors: the pre-pass takes every candidate's
    events, then the chain runs every round of every individual."""
    n_rounds, K, P = draws.mtype.shape
    if tuple(draws.u.shape) != (n_rounds, K, P, rows.slots.shape[1]):
        raise ValueError("random_ls: the draws do not fit the population")
    return random_ls_chain(pa, draws, rows, random_ls_events_kernel(draws))


@obs_prof.scope("tt.delta")
def random_local_search(pa, draws: LSDraws, rows: LSRows) -> LSRows:
    """The random-candidate delta local search of a population's scored
    rows; the rows it returns carry a full evaluation of each (K8's
    epilogue). `pa` is a ProblemArrays, or a LaneProblems whose lanes
    are equal blocks of the rows. Kernel K8 on CUDA tensors, the plain
    version on CPU ones."""
    if not rows.slots.is_cuda:
        kernels.tally(work.random_ls_events(draws))
        kernels.tally(work.random_ls(pa, draws, rows))
        if isinstance(pa, LaneProblems):
            return random_ls_lanes_plain(pa, draws, rows)
        return random_local_search_plain(pa, draws, rows)
    return random_local_search_kernel(pa, draws, rows)


@obs_prof.scope("tt.delta")
def batch_local_search_delta(pa, draws: LSDraws, slots, rooms,
                             scores=None) -> LSRows:
    """Hill-climb a (P, E) population for draws' n_rounds rounds of K
    candidates each (JAX delta.py:212), from its penalty terms `scores`
    where the caller holds them (else K2's); returns the rows, each with
    a full evaluation (LSRows: slots, rooms first, as the JAX function
    returns them)."""
    return random_local_search(pa, draws, init_rows(pa, slots, rooms,
                                                    scores))
