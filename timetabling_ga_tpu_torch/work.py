"""The work of each kernel launch: integer operations and bytes moved,
counted from the launch's shapes and scalars (the port's counterpart of
XLA's `cost_analysis`, which the JAX package reads off each compiled
program).

`TABLE` maps every entry point of `kernels.SIGNATURES` and every form of
`kernels.FORMS` to a function of the wrapper's own arguments returning
a `Work(ops, bytes)`. `kernels.launch` adds a launch's work to
`kernels.WORK` beside `LAUNCHES`; on the CPU each wrapper adds the work
of the launches its kernel branch would make (`kernels.tally`), so a
program's counted work is the same on either device. The cost
observatory (obs/cost.py) reads the totals' growth over a program call.

Operations are counted as chip_smoke.py counts them for the kernels'
bounds: each inner loop's trip count times the loads and ALU
instructions on its path, counted by hand from csrc/ (the OPS_*
constants below). They are integer operations except the hot-mode rank
compares of K5, which are float32 and counted in with them. Bytes are
each input read once and each output written once.

Where the work depends on the data, a shape alone cannot see it, and
the table gives the most work the launch can do, with no device read:
- the K4 body (delta_one, and inside sweep_pass, random_ls, lahc): every
  candidate's three events change slot, each with the most students an
  event has, over min(n_days, 6) distinct days;
- breed: every child is crossed over and mutated;
- the K5 heat (sweep_pass in hot mode): each event at the larger of its
  infeasible and feasible costs;
- nsga_rank and nsga_survivors: as many fronts as rows;
- parallel_rooms: every event bids in every round.
K13's compress_trace and moment_rows count bytes only, as chip_smoke's
bounds do.

Stdlib only at import: the functions read shapes off the tensors they
are given (`numel`, `element_size`, `shape`), never their values. A
problem's own counts (a full evaluation's, the K4 body's, its tables'
bytes) are computed once a problem and kept (`_problem`), so a launch
pays a few integer products on the host.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple


class Work(NamedTuple):
    ops: int
    bytes: int


# Operations per element a kernel visits, counted by hand as the loads
# and ALU instructions on that element's path in csrc/sweep_dev.cuh,
# csrc/sweep_pass.cu and the other sources (the loop bookkeeping around
# them not counted)
OPS_ROOM_KEY = 12     # a (slot, room) key of a room argmin: occupancy
                      # load, own-cell test, suitability load, the key's
                      # mul/adds, compare and select
OPS_MOVE1_STUDENT = 25  # a (target, student) of tt_move1_target: day bits,
                        # free test, 4 neighbour bits, popcount, 5 adds
OPS_STUDENT = 6       # a student of the K4 re-score: 3 attendance loads,
                      # the earlier-event test
OPS_DAY_SCORE = 12    # tt_day_scv of one day's bits: runs and singles
# the bitset forms of the K4 body (K4, K5, K8, K10), Move1's prepare and
# the heat
OPS_DOT_WORD = 9      # a conflict word of the popcount dots: load, mask the
                      # moved events, two slot_ev loads, two and+popc, sub
OPS_SLOT_WORD = 5     # a (slot, word) of Move1's per-slot count or the
                      # heat: two loads, and, popcount, add
OPS_AMASK = 4         # a student's amask word: load, the old slot's
                      # attendance load, compare, select
OPS_FIX_SLOT = 9      # a touched slot of a student: att load, 3 patch
                      # compares and adds, the bit set or clear
OPS_DAY_BITS = 2      # a day's bits out of a mask: shift, and
OPS_HEAT_STUDENT = 14  # a student of the feasible heat: amask load, day
                       # bits, 4 neighbour bits, popcount, 3 adds
OPS_CAND = 16         # a candidate's fixed work: 4 stores, the lexicographic
                      # compare, the tie test and noise compare
OPS_HEAT = 10         # an event's fixed heat work: cell, suitability, mask
OPS_RANK = 3          # a float pair of the rank count: >, ==, index <
OPS_TOP3 = 3          # a uniform of the top 3 of E uniforms (lax.top_k):
                      # one pass, a load, the compare with the third
                      # largest so far and its select (K6/K8's three-pass
                      # warp argmax does more, which the count does not
                      # charge)
OPS_LEX = 3           # a pair of K7's rank count: two compares and add
OPS_COPY = 2          # a word of a copied row: load and store
OPS_PICK = 2          # a room pick of the parallel matcher: the AND of
                      # the event's suitability word with a mask of
                      # ranks, its find-first-set
OPS_BID = 3           # a bid: the cell's ballot, the lowest-lane test,
                      # the claimed mask
OPS_DOM = 5           # a pair of K11's dominator words: 4 compares and
                      # the ballot's and/or
OPS_DOM_WORD = 3      # a dominator word of K11's peel round: load, AND
                      # with the unassigned word, or into the test
OPS_ASSIGN = 8        # a (row, event, room) of K1's greedy matching
OPS_MOVE1_ROOM = 8    # a (target, room) of K3's room pick
OPS_MOVE1_TARGET = 14  # a (target, student) of K3's day re-score

# the most distinct days the K4 body re-scores for a candidate: its three
# events' old and new slots
_K4_DAYS = 6


def nbytes(*tensors) -> int:
    """Bytes of the tensors (None skipped), from their shapes."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _n(t) -> int:
    return 0 if t is None else t.numel()


class _Problem(NamedTuple):
    penalty_ops: int       # one full evaluation
    penalty_bytes: int     # the arrays a full evaluation reads
    room_bytes: int        # the room-matching tables
    k4_ops: int            # the K4 body on one candidate, at most
    k4_bytes: int          # the arrays the K4 body reads
    stu_bytes: int         # the students' CSR


# id(problem) -> (a weak reference to the problem, its counts): the memo
# keeps no problem's tensors alive (a fleet replica drops a settled
# job's problem, and its entry here goes with it)
_PROBLEMS: dict = {}


def _problem(pa) -> _Problem:
    """A problem's own counts, computed once while the problem lives
    (the reference beside them says the id is still the problem's)."""
    key = id(pa)
    hit = _PROBLEMS.get(key)
    if hit is not None and hit[0]() is pa:
        return hit[1]
    E, S, W = pa.n_events, pa.n_students, pa.conflict_bits.shape[1]
    n_d = min(pa.n_days, _K4_DAYS)
    per_event = W * OPS_DOT_WORD + pa.max_ev_students * (
        OPS_STUDENT + OPS_AMASK + 2 * OPS_FIX_SLOT
        + n_d * 2 * (OPS_DAY_BITS + OPS_DAY_SCORE))
    counts = _Problem(
        penalty_ops=(E * W * 3 + pa.stu_ev.numel() * 2
                     + S * pa.n_days * 8 + E * 12),
        penalty_bytes=nbytes(pa.possible_u8, pa.live, pa.student_count,
                             pa.conflict_bits, pa.stu_ptr, pa.stu_ev,
                             pa.anchor_slots, pa.anchor_w),
        room_bytes=nbytes(pa.possible_u8, pa.live, pa.cap_rank, pa.dead),
        k4_ops=3 * per_event + 3 * pa.n_rooms * OPS_ROOM_KEY + OPS_CAND,
        k4_bytes=nbytes(pa.possible_u8, pa.live, pa.student_count,
                        pa.conflict_bits, pa.cap_rank, pa.dead,
                        pa.attends_u8, pa.ev_ptr, pa.ev_stu,
                        pa.anchor_slots, pa.anchor_w),
        stu_bytes=nbytes(pa.stu_ptr, pa.stu_ev))
    _PROBLEMS[key] = (
        weakref.ref(pa, lambda _, k=key: _PROBLEMS.pop(k, None)), counts)
    return counts


def penalty_ops(pa) -> int:
    """Integer operations of one full evaluation (K2's body, also in K6's
    and K8's epilogues): three a conflict word of the correlation, two a
    CSR entry of the students' masks, eight a student's day, twelve an
    event's occupancy, suitability, last-slot and anchor terms."""
    return _problem(pa).penalty_ops


def penalty_bytes(pa) -> int:
    """Bytes of the problem arrays a full evaluation reads once."""
    return _problem(pa).penalty_bytes


def _room_bytes(pa) -> int:
    """Bytes of the room-matching tables a room argmin reads."""
    return _problem(pa).room_bytes


def _k4_problem_bytes(pa) -> int:
    """Bytes of the problem arrays the K4 body reads."""
    return _problem(pa).k4_bytes


def k4_candidate_ops(pa) -> int:
    """The most integer operations the K4 body does on one padded
    3-relocation candidate: three room argmins and the fixed candidate
    work, and for each of its three events, taken to change slot, its
    conflict row and, for each of the most students an event has, the
    re-score of min(n_days, 6) days."""
    return _problem(pa).k4_ops


def top3_ops(pa) -> int:
    """A mutation's move: the top 3 of E uniforms and three room
    argmins."""
    return pa.n_events * OPS_TOP3 + 3 * pa.n_rooms * OPS_ROOM_KEY


def parallel_rooms_ops(E: int, n_rounds: int) -> int:
    """Integer operations of one individual's parallel matching on
    rooms as bits: each event's best-fit pick and its bid for its
    incoming room at the start, and in each of the n_rounds rounds its
    stage-1 and stage-2 picks (one AND and one find-first-set each) and
    their two bids. The rounds that end early when nothing is left
    unmatched and the park rounds are not told apart: the count is of
    every event bidding in every round."""
    return E * ((OPS_PICK + OPS_BID) + n_rounds * 2 * (OPS_PICK + OPS_BID))


def parallel_rooms_bytes(pa, slots, rooms_in=None) -> int:
    """Bytes K9 moves: its rows' slots (and incoming rooms) read, their
    rooms written, and the rooms' tables it reads (the events' suit
    words in capacity-rank order, the rooms of each rank, the capacity
    ranks, the dead rooms) and the live flags."""
    return (nbytes(slots) * (3 if rooms_in is not None else 2)
            + nbytes(pa.suit_rank, pa.room_of_rank, pa.cap_rank, pa.dead,
                     pa.live))


# ----------------------------------------------------------- entry points


def assign_rooms(pa, slots) -> Work:
    """K1: a greedy room matching of each row, E x R keys a row."""
    P, E = slots.shape
    return Work(P * E * pa.n_rooms * OPS_ASSIGN,
                2 * nbytes(slots) + nbytes(pa.room_order) + _room_bytes(pa))


def batch_penalty(pa, slots) -> Work:
    """K2: one full evaluation a row."""
    P = slots.shape[0]
    return Work(P * penalty_ops(pa),
                2 * nbytes(slots) + penalty_bytes(pa) + 3 * P * 4)


def move1_sweep(pa, slots, att, occ, pivots) -> Work:
    """K3: each pivot's Move1 to every slot."""
    P, B = pivots.shape
    T, R, S = pa.n_slots, pa.n_rooms, pa.n_students
    W = pa.conflict_bits.shape[1]
    return Work(
        P * B * (T * R * OPS_MOVE1_ROOM + T * W * OPS_SLOT_WORD
                 + pa.max_ev_students * T * OPS_MOVE1_TARGET),
        2 * nbytes(slots) + nbytes(att, occ, pivots) + _room_bytes(pa)
        + nbytes(pa.student_count, pa.conflict_bits, pa.ev_ptr, pa.ev_stu)
        + P * (S * 8 + T * W * 4) + 3 * P * B * T * 4)


def delta_one(pa, slots, att, occ, evs) -> Work:
    """K4: the K4 body on each (row, candidate)."""
    P, C = evs.shape[:2]
    S, T = pa.n_students, pa.n_slots
    W = pa.conflict_bits.shape[1]
    return Work(P * C * k4_candidate_ops(pa),
                2 * nbytes(slots) + nbytes(att, occ) + P * C * 3 * 9
                + _k4_problem_bytes(pa) + P * (S * 8 + T * W * 4)
                + P * C * 5 * 4)


def sweep_pass(pa, sh, state, draws) -> Work:
    """K5, one pass: per step and block pivot its Move1 (its conflict row
    against every slot's event words, its students' amask words and old
    day, T targets of R room keys and one update per student), and each
    Move2 / Move3 candidate's K4 body; in hot mode the prologue's heat
    per event and the E^2 float rank compares. Bytes: the state read and
    written once, the draws and problem arrays read once, strict_rows
    and the pivots written."""
    P = state.slots.shape[0]
    E, R, T = pa.n_events, pa.n_rooms, pa.n_slots
    W = pa.conflict_bits.shape[1]
    m = pa.max_ev_students
    move1 = (T * W * OPS_SLOT_WORD
             + m * (OPS_AMASK + 2 * (OPS_DAY_BITS + OPS_DAY_SCORE))
             + T * (R * OPS_ROOM_KEY + OPS_CAND + m * OPS_MOVE1_STUDENT))
    n_k4 = sh.SB + (2 * (sh.SB - 1) if sh.with_move3 and sh.SB >= 2
                    else 0)
    ops = P * sh.n_steps * sh.B * (move1 + n_k4 * k4_candidate_ops(pa))
    if sh.use_hot:
        ops += P * E * (max(W * OPS_SLOT_WORD, m * OPS_HEAT_STUDENT)
                        + OPS_HEAT)
        ops += P * (2 * E + OPS_RANK * E * E)
    nb = (2 * nbytes(*state) + nbytes(*draws) + _k4_problem_bytes(pa)
          + nbytes(pa.event_mask) + P + P * sh.K * 4)
    return Work(ops, nb)


def _breed_one(pa, pop: int, k: int, n_rounds: int) -> int:
    """K6's operations on `pop` children of one problem, every child
    crossed over and mutated: the room matching of each event (the scan
    matcher's R keys, or the parallel matcher's rounds), the mutation's
    move, the two tournaments of k and one full evaluation."""
    E, R = pa.n_events, pa.n_rooms
    match = (parallel_rooms_ops(E, n_rounds) if n_rounds >= 0
             else E * (R * OPS_ROOM_KEY + 2))
    return pop * (match + top3_ops(pa) + 2 * k * OPS_LEX + penalty_ops(pa))


def breed(pa, state, draws, n_rounds: int = -1) -> Work:
    """K6: one child a block, scored in its epilogue. `pa` a ProblemArrays
    or a LaneProblems (breed_lanes: each lane's rows on its own problem,
    the lane table read once). `n_rounds` the parallel matcher's rounds,
    -1 for the scan matcher."""
    P, E = state.slots.shape
    k = draws.ta.shape[1]
    rows_b = (nbytes(state.slots, state.rooms, state.penalty, state.scv)
              + P * (2 * k + E + 2) * 4
              + nbytes(draws.move.u) + 2 * _n(draws.move.t) * 4
              + 2 * P * E * 4 + 3 * P * 4)
    pas = getattr(pa, "pas", None)
    if pas is None:
        return Work(_breed_one(pa, P, k, n_rounds),
                    rows_b + nbytes(pa.room_order) + _room_bytes(pa)
                    + penalty_bytes(pa))
    pop = P // len(pas)
    ops = sum(_breed_one(p, pop, k, n_rounds) for p in pas)
    nb = sum(nbytes(p.room_order) + _room_bytes(p) + penalty_bytes(p)
             for p in pas)
    return Work(ops, rows_b + nb + nbytes(pa.table))


def relocate(pa, slots, n_moves: int) -> Work:
    """K6's relocation entry: each row's chain of n_moves relocations."""
    N, E = slots.shape
    return Work(N * n_moves * (E * 3 + top3_ops(pa)),
                4 * nbytes(slots) + n_moves * N * (E + 2) * 4
                + _room_bytes(pa))


def _row_bytes(E: int) -> int:
    return 4 * (2 * E + 3)     # a row's five fields


def survivors(groups: int, na: int, nb: int, keep: int, E: int) -> Work:
    """K7: each island's rank count over its na + nb rows and the copy
    of its `keep` survivors."""
    n = na + nb
    return Work(groups * (n * n * OPS_LEX + keep * (2 * E + 3) * OPS_COPY),
                groups * (2 * n * 4 + 2 * keep * _row_bytes(E)))


def migrate(L: int, pop: int, E: int, halo: bool = False) -> Work:
    """K7's migrate entry: each island's ranks and its rows' copy; its
    halo form also reads the two halo rows."""
    return Work(L * (pop * pop * OPS_LEX + pop * (2 * E + 3) * OPS_COPY),
                L * (2 * pop * 4 + 2 * pop * _row_bytes(E))
                + (2 * 4 * (2 * E + 3) if halo else 0))


def random_ls_events(draws) -> Work:
    """K8's pre-pass: the top 3 of E uniforms of every candidate."""
    n_rounds, K, P, E = draws.u.shape
    return Work(P * n_rounds * K * E * OPS_TOP3,
                nbytes(draws.u) + P * n_rounds * K * 3 * 2)


def _ls_chain_bytes(pa, rows, draws) -> int:
    """The int32 rows (slots, rooms, pen, hcv, scv) read and written,
    the move types, targets and int16 events read."""
    n_rounds, K, P = draws.mtype.shape
    E = rows.slots.shape[1]
    return (2 * 4 * P * (2 * E + 3) + 2 * n_rounds * K * P * 4
            + P * n_rounds * K * 3 * 2)


def random_ls(pa, draws, rows) -> Work:
    """K8's chain: the K4 body on every candidate of every round and one
    full evaluation a row in its epilogue. With a LaneProblems each
    lane's rows count on their own problem (random_ls_lanes)."""
    n_rounds, K, P = draws.mtype.shape
    nb = _ls_chain_bytes(pa, rows, draws)

    def one(p, rows_n):
        c = _problem(p)
        return (rows_n * (n_rounds * K * c.k4_ops + c.penalty_ops),
                c.k4_bytes + c.stu_bytes)

    pas = getattr(pa, "pas", None)
    if pas is None:
        ops, pb = one(pa, P)
        return Work(ops, nb + pb)
    parts = [one(p, P // len(pas)) for p in pas]
    return Work(sum(o for o, _ in parts),
                nb + sum(b for _, b in parts) + nbytes(pa.table))


def full_eval_ls(pa, draws, rows) -> Work:
    """K12: a relocation (three room argmins) and a full evaluation per
    round, candidate and row."""
    n_rounds, K, P = draws.mtype.shape
    return Work(n_rounds * K * P * (penalty_ops(pa)
                                    + 3 * pa.n_rooms * OPS_ROOM_KEY),
                _ls_chain_bytes(pa, rows, draws) + penalty_bytes(pa)
                + nbytes(pa.cap_rank, pa.dead))


def parallel_rooms(pa, slots, rooms_in=None,
                   n_rounds: int = 4) -> Work:
    """K9: one individual's parallel matching a block."""
    P, E = slots.shape
    return Work(P * parallel_rooms_ops(E, n_rounds),
                parallel_rooms_bytes(pa, slots, rooms_in))


def lahc(pa, draws, state) -> Work:
    """K10: per step, walker and candidate the K4 body on the events of
    K8's pre-pass (whose top 3 of the uniforms random_ls_events counts);
    the walkers' state read and written once (of each history ring the
    entries the steps touch), the int16 events, the move types and
    targets and the problem arrays read once."""
    n, W, K = draws.mtype.shape
    touched = min(n, state.hist_pen.shape[1])
    st = nbytes(*state.ls, state.step, state.best_slots, state.best_rooms,
                state.best_pen, state.best_hcv, state.best_scv)
    return Work(W * n * K * k4_candidate_ops(pa),
                2 * st + 2 * 2 * W * touched * 4 + n * W * K * 3 * 2
                + 2 * n * W * K * 4 + _k4_problem_bytes(pa))


def _nsga_ops(n: int) -> int:
    """K11's n^2 dominance tests, a peel round a front over each row's
    ceil(n/32) dominator words (as many fronts as rows), and the
    crowding's rank compares."""
    return (n * n * OPS_DOM + n * n * -(-n // 32) * OPS_DOM_WORD
            + 2 * n * n * OPS_LEX)


def nsga_rank(groups: int, n: int) -> Work:
    """K11's nsga_rank: each island's fronts and crowding."""
    return Work(groups * _nsga_ops(n), groups * (n * 2 * 4 + 2 * n * 4))


def nsga_survivors(groups: int, na: int, nb: int, keep: int,
                   E: int) -> Work:
    """K11's nsga_survivors: the fronts of na + nb rows, the crowded
    order, the penalty sort of the `keep` survivors and their copy."""
    n = na + nb
    return Work(groups * (_nsga_ops(n) + n * n * OPS_LEX
                          + keep * n * OPS_LEX
                          + keep * (2 * E + 3) * OPS_COPY),
                groups * (n * 2 * 4 + n * 4 + 2 * keep * _row_bytes(E)))


def compress_trace(trace, cap: int, n_moments: int,
                   lanes: bool = False) -> Work:
    """K13's compress_trace: the (L, T, 2) trace (and, in its lane form,
    the (L,) valid counts) read and the (L, 3 cap + 1 + n_moments) leaf
    written (bytes only, as chip_smoke's bound counts it)."""
    L = trace.shape[0]
    return Work(0, nbytes(trace) + L * (3 * cap + 1 + n_moments) * 4
                + (L * 4 if lanes else 0))


def moment_rows(hcv) -> Work:
    """K13's moment_rows: (L, n) hcv and scv read, (4, L) moments
    written (bytes only)."""
    return Work(0, 2 * nbytes(hcv) + 4 * hcv.shape[0] * 4)


def quality_ops(L: int, pop: int) -> Work:
    """K14's quality_ops: each row's two flags, parent, two penalties and
    three counts read once, the accumulator read and written; a row's
    win compare, four flag ANDs and adds and three count adds, and each
    block's seven sums."""
    P = L * pop
    return Work(P * 11 + L * 7 * 10, P * (2 + 4 * 3 + 12) + 2 * L * 7 * 4)


def div_stats(L: int, pop: int, E: int, hamming_pairs: int) -> Work:
    """K14's div_stats: each island's penalties and scvs, the rows of its
    Hamming pairs (at most min(pop, 2k) distinct rows) and the mask read
    once, nine words written; eight operations a value of the two moment
    series, four a (pair, event) of the Hamming sample."""
    k = min(pop, hamming_pairs) if pop >= 2 else 0
    rows = min(pop, 2 * k)
    return Work(L * (16 * pop + 4 * k * E),
                L * (8 * pop + rows * E * 4 + 9 * 4) + E * 4)


# Every entry point and form: the function of the wrapper's arguments
# that counts one launch (kernels.launch's `work`)
TABLE = {
    "assign_rooms": assign_rooms, "batch_penalty": batch_penalty,
    "move1_sweep": move1_sweep, "delta_one": delta_one,
    "sweep_pass": sweep_pass, "breed": breed, "breed_lanes": breed,
    "relocate": relocate, "survivors": survivors, "migrate": migrate,
    "migrate_halo": migrate,
    "random_ls_events": random_ls_events, "random_ls": random_ls,
    "random_ls_lanes": random_ls, "full_eval_ls": full_eval_ls,
    "parallel_rooms": parallel_rooms, "lahc": lahc,
    "nsga_rank": nsga_rank, "nsga_survivors": nsga_survivors,
    "compress_trace": compress_trace,
    "compress_trace_lanes": compress_trace,
    "moment_rows": moment_rows, "quality_ops": quality_ops,
    "div_stats": div_stats, "div_stats_lanes": div_stats,
}
