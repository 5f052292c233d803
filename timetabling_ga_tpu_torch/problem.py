"""Problem model and `.tim` instance loader (PyTorch port).

A copy of `timetabling_ga_tpu/problem.py`'s host side — `Problem`,
`derive`, `load_tim`, `load_tim_file`, `dump_tim`, `random_instance`,
`itc_like_instance` — kept here because the port never imports the JAX
package. What differs is the device view: `ProblemArrays` holds torch
tensors on an explicit device, with the same fields, dtypes and masks as
the JAX `ProblemArrays` (problem.py:128-170) plus the derived forms the
hand-written CUDA kernels read:

    conflict_bits (E, W) int32   conflict rows as bitsets, W = ceil(E/32)
                                 (bit f of row e set iff conflict[e,f] > 0.5)
    stu_ptr/stu_ev               CSR of each student's events
    ev_ptr/ev_stu                CSR of each event's students
    cap_rank (R,) int32          room rank by capacity (double stable sort)
    room_order (E,) int32        most-constrained-first matching order

`.tim` format (Metaheuristics-Network / ITC-2002):

    E R F S                      header (events, rooms, features, students)
    <R ints>                     room sizes
    <S*E 0/1 ints>               student-event attendance, student-major
    <R*F 0/1 ints>               room features
    <E*F 0/1 ints>               event feature requirements
"""

from __future__ import annotations

import dataclasses
import io
from itertools import combinations
from typing import Union

import numpy as np
import torch

DAYS_DEFAULT = 5
SLOTS_PER_DAY_DEFAULT = 9


@dataclasses.dataclass(frozen=True)
class Problem:
    """A timetabling instance, packed as dense host numpy arrays."""

    n_events: int
    n_rooms: int
    n_features: int
    n_students: int
    room_size: np.ndarray      # (R,)    int32
    attends: np.ndarray        # (S, E)  int8   student-event attendance
    room_features: np.ndarray  # (R, F)  int8
    event_features: np.ndarray  # (E, F) int8
    student_count: np.ndarray  # (E,)    int32
    conflict: np.ndarray       # (E, E)  bool   shared-student correlation
    possible: np.ndarray       # (E, R)  bool   room suitability
    n_days: int = DAYS_DEFAULT
    slots_per_day: int = SLOTS_PER_DAY_DEFAULT
    # live-prefix counts of a padded instance (None = everything live)
    n_live_events: Union[int, None] = None
    n_live_rooms: Union[int, None] = None
    # anchored objective columns (None = unanchored)
    anchor_slots: Union[np.ndarray, None] = None  # (E,) int32
    anchor_w: Union[np.ndarray, None] = None      # (E,) int32

    @property
    def n_slots(self) -> int:
        return self.n_days * self.slots_per_day

    def device_arrays(self, device="cpu") -> "ProblemArrays":
        """The kernel-facing tensors on `device` (see ProblemArrays)."""
        live_e = (self.n_events if self.n_live_events is None
                  else self.n_live_events)
        live_r = (self.n_rooms if self.n_live_rooms is None
                  else self.n_live_rooms)
        anchor_slots = (np.zeros(self.n_events, dtype=np.int32)
                        if self.anchor_slots is None else self.anchor_slots)
        anchor_w = (np.zeros(self.n_events, dtype=np.int32)
                    if self.anchor_w is None else self.anchor_w)
        return make_problem_arrays(
            attends=self.attends.astype(np.float32),
            conflict=self.conflict.astype(np.float32),
            possible=self.possible,
            student_count=self.student_count,
            room_size=self.room_size,
            event_mask=(np.arange(self.n_events) < live_e).astype(np.float32),
            room_mask=np.arange(self.n_rooms) < live_r,
            anchor_slots=anchor_slots, anchor_w=anchor_w,
            n_days=self.n_days, slots_per_day=self.slots_per_day,
            device=device)


@dataclasses.dataclass(frozen=True)
class ProblemArrays:
    """Device view of a Problem: torch tensors on one device.

    The first nine fields mirror the JAX ProblemArrays exactly (dtypes
    included: attends/conflict/event_mask float32, possible/room_mask
    bool, the rest int32); all values are small exact integers. The
    derived fields below them are computed once per problem on the host
    and feed the CUDA kernels and the plain versions alike."""

    attends: torch.Tensor        # (S, E) f32
    conflict: torch.Tensor       # (E, E) f32, diagonal = event has students
    possible: torch.Tensor       # (E, R) bool
    student_count: torch.Tensor  # (E,)   i32
    room_size: torch.Tensor      # (R,)   i32
    event_mask: torch.Tensor     # (E,)   f32 1.0 live / 0.0 padded
    room_mask: torch.Tensor      # (R,)   bool
    anchor_slots: torch.Tensor   # (E,)   i32
    anchor_w: torch.Tensor       # (E,)   i32
    n_days: int
    slots_per_day: int
    # ---- derived (host-computed once, see module docstring)
    live: torch.Tensor           # (E,)   i32 1 live / 0 padded
    possible_u8: torch.Tensor    # (E, R) u8
    attends_u8: torch.Tensor     # (S, E) u8
    dead: torch.Tensor           # (R,)   i32 dead-room key penalty
    cap_rank: torch.Tensor       # (R,)   i32
    room_of_rank: torch.Tensor   # (R,)   i32 the room of capacity rank k
    suit_rank: torch.Tensor      # (E,)   i32 (uint32 bit patterns; R <= 32)
                                 # bit k: the room of capacity rank k suits
    room_order: torch.Tensor     # (E,)   i32
    conflict_bits: torch.Tensor  # (E, W) i32 (uint32 bit patterns)
    conflict_diag: int           # sum of conflict's diagonal
    stu_ptr: torch.Tensor        # (S+1,) i32
    stu_ev: torch.Tensor         # (nnz,) i32
    ev_ptr: torch.Tensor         # (E+1,) i32
    ev_stu: torch.Tensor         # (nnz,) i32
    max_ev_students: int         # largest student count of one event
    # K2's split of the students over a cluster's CTAs (host memory, int32,
    # whatever the device): for CS = 1, 2, 4, 8 in turn, the CS + 1 student
    # boundaries, then the CS + 1 CSR entry boundaries (`stu_split_of`)
    stu_split: torch.Tensor
    anchored: bool               # any anchor weight non-zero

    @property
    def n_slots(self) -> int:
        return self.n_days * self.slots_per_day

    @property
    def n_events(self) -> int:
        return self.possible.shape[0]

    @property
    def n_rooms(self) -> int:
        return self.possible.shape[1]

    @property
    def n_students(self) -> int:
        return self.attends.shape[0]

    @property
    def device(self) -> torch.device:
        return self.attends.device


# Dead-room key penalty (JAX ops/rooms.py _W_DEAD): masked-out rooms never
# win a room argmin; it strictly dominates every live room key.
W_DEAD = 1 << 28


def _csr(mat: np.ndarray):
    """(N, M) 0/1 matrix -> (ptr (N+1,), idx) int32 CSR of its rows."""
    rows, cols = np.nonzero(mat)
    ptr = np.zeros(mat.shape[0] + 1, dtype=np.int64)
    np.add.at(ptr, rows + 1, 1)
    return np.cumsum(ptr).astype(np.int32), cols.astype(np.int32)


# the cluster sizes K2 takes (ops/fitness.py batch_penalty_kernel)
K2_CLUSTERS = (1, 2, 4, 8)


def stu_split_of(stu_ptr: np.ndarray) -> list:
    """K2's students split over CS CTAs, for each CS in K2_CLUSTERS: rank
    c takes the students from the first whose CSR entries start at or
    after ceil(c * nnz / CS), so every rank gets about nnz / CS entries
    (at most that plus one student's); returned flat, each CS's CS + 1
    student boundaries then their CS + 1 entry boundaries."""
    stu_ptr = np.asarray(stu_ptr, dtype=np.int64)
    S, nnz = len(stu_ptr) - 1, int(stu_ptr[-1])
    out = []
    for cs in K2_CLUSTERS:
        bounds = [0] + [int(np.searchsorted(stu_ptr, -(-c * nnz // cs)))
                        for c in range(1, cs)] + [S]
        out += bounds + [int(stu_ptr[b]) for b in bounds]
    return out


def make_problem_arrays(attends, conflict, possible, student_count,
                        room_size, event_mask, room_mask, anchor_slots,
                        anchor_w, n_days: int, slots_per_day: int,
                        device="cpu") -> ProblemArrays:
    """Build a ProblemArrays on `device` from the nine numpy fields of a
    JAX ProblemArrays (the same values, any array-like)."""
    attends = np.asarray(attends, dtype=np.float32)
    conflict = np.asarray(conflict, dtype=np.float32)
    possible = np.asarray(possible, dtype=bool)
    student_count = np.asarray(student_count, dtype=np.int32)
    room_size = np.asarray(room_size, dtype=np.int32)
    event_mask = np.asarray(event_mask, dtype=np.float32)
    room_mask = np.asarray(room_mask, dtype=bool)
    E, R = possible.shape
    S = attends.shape[0]
    if n_days * slots_per_day > 64:
        raise ValueError("the kernels pack a student's slots into 64 "
                         f"bits; {n_days}x{slots_per_day} slots is too many")
    suit_count = possible.sum(axis=1).astype(np.int32)
    cap_rank = np.argsort(np.argsort(room_size, kind="stable"),
                          kind="stable").astype(np.int32)
    room_order = np.argsort(suit_count, kind="stable").astype(np.int32)
    room_of_rank = np.argsort(cap_rank, kind="stable").astype(np.int32)
    # the parallel matcher's suitability words (K9, K6); zero past 32 rooms,
    # where the kernels refuse to run
    by_rank = possible[:, room_of_rank][:, :32].astype(np.uint64)
    suit_rank = (by_rank << np.arange(by_rank.shape[1], dtype=np.uint64)
                 ).sum(axis=1).astype(np.uint32).view(np.int32)
    W = (E + 31) // 32
    conf = conflict > 0.5
    padded = np.zeros((E, W * 32), dtype=bool)
    padded[:, :E] = conf
    words = (padded.reshape(E, W, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(axis=2)
    conflict_bits = words.astype(np.uint32).view(np.int32)
    att01 = attends > 0.5
    stu_ptr, stu_ev = _csr(att01)
    ev_ptr, ev_stu = _csr(att01.T)

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return ProblemArrays(
        attends=t(attends, torch.float32),
        conflict=t(conflict, torch.float32),
        possible=t(possible, torch.bool),
        student_count=t(student_count, torch.int32),
        room_size=t(room_size, torch.int32),
        event_mask=t(event_mask, torch.float32),
        room_mask=t(room_mask, torch.bool),
        anchor_slots=t(np.asarray(anchor_slots, np.int32), torch.int32),
        anchor_w=t(np.asarray(anchor_w, np.int32), torch.int32),
        n_days=int(n_days), slots_per_day=int(slots_per_day),
        live=t((event_mask > 0.5).astype(np.int32), torch.int32),
        possible_u8=t(possible.astype(np.uint8), torch.uint8),
        attends_u8=t(attends.astype(np.uint8), torch.uint8),
        dead=t((~room_mask).astype(np.int32) * W_DEAD, torch.int32),
        cap_rank=t(cap_rank, torch.int32),
        room_of_rank=t(room_of_rank, torch.int32),
        suit_rank=t(suit_rank, torch.int32),
        room_order=t(room_order, torch.int32),
        conflict_bits=t(conflict_bits, torch.int32),
        conflict_diag=int(np.diagonal(conflict).sum()),
        stu_ptr=t(stu_ptr, torch.int32), stu_ev=t(stu_ev, torch.int32),
        ev_ptr=t(ev_ptr, torch.int32), ev_stu=t(ev_stu, torch.int32),
        max_ev_students=int(np.diff(ev_ptr).max()) if E else 0,
        stu_split=torch.tensor(stu_split_of(stu_ptr), dtype=torch.int32),
        anchored=bool(np.any(np.asarray(anchor_w) != 0)),
    )


def derive(n_events: int, n_rooms: int, n_features: int, n_students: int,
           room_size: np.ndarray, attends: np.ndarray,
           room_features: np.ndarray, event_features: np.ndarray,
           n_days: int = DAYS_DEFAULT,
           slots_per_day: int = SLOTS_PER_DAY_DEFAULT) -> Problem:
    """Build a Problem from raw arrays, computing the derived matrices:
    conflict = attends.T @ attends > 0; possible = size fits AND every
    required feature present (Problem.cpp:49-95)."""
    attends = np.asarray(attends, dtype=np.int8)
    room_size = np.asarray(room_size, dtype=np.int32)
    room_features = np.asarray(room_features, dtype=np.int8)
    event_features = np.asarray(event_features, dtype=np.int8)

    expected = {
        "room_size": (room_size.shape, (n_rooms,)),
        "attends": (attends.shape, (n_students, n_events)),
        "room_features": (room_features.shape, (n_rooms, n_features)),
        "event_features": (event_features.shape, (n_events, n_features)),
    }
    for name, (got, want) in expected.items():
        if got != want:
            raise ValueError(f"{name}: expected shape {want}, got {got}")

    student_count = attends.astype(np.int64).sum(axis=0).astype(np.int32)
    a32 = attends.astype(np.float32)
    conflict = (a32.T @ a32) > 0.5

    size_ok = room_size[None, :] >= student_count[:, None]
    missing = (event_features.astype(np.int32)[:, None, :]
               * (1 - room_features.astype(np.int32))[None, :, :]).sum(-1)
    possible = size_ok & (missing == 0)

    return Problem(
        n_events=n_events, n_rooms=n_rooms, n_features=n_features,
        n_students=n_students, room_size=room_size, attends=attends,
        room_features=room_features, event_features=event_features,
        student_count=student_count, conflict=conflict, possible=possible,
        n_days=n_days, slots_per_day=slots_per_day,
    )


def load_tim(source: Union[str, io.TextIOBase],
             n_days: int = DAYS_DEFAULT,
             slots_per_day: int = SLOTS_PER_DAY_DEFAULT) -> Problem:
    """Parse a `.tim` instance from a string or text stream."""
    text = source if isinstance(source, str) else source.read()
    tokens = np.array(text.split(), dtype=np.int64)
    pos = 0

    def take(n):
        nonlocal pos
        out = tokens[pos:pos + n]
        if out.size != n:
            raise ValueError(
                f"truncated .tim instance: wanted {n} tokens at {pos}, "
                f"got {out.size}")
        pos += n
        return out

    e, r, f, s = (int(x) for x in take(4))
    room_size = take(r).astype(np.int32)
    attends = take(s * e).reshape(s, e).astype(np.int8)
    room_features = take(r * f).reshape(r, f).astype(np.int8)
    event_features = take(e * f).reshape(e, f).astype(np.int8)
    if pos != tokens.size:
        raise ValueError(
            f".tim instance has {tokens.size - pos} trailing tokens")
    return derive(e, r, f, s, room_size, attends, room_features,
                  event_features, n_days=n_days, slots_per_day=slots_per_day)


def load_tim_file(path: str, **kw) -> Problem:
    with open(path, "r") as fh:
        return load_tim(fh, **kw)


def dump_tim(problem: Problem) -> str:
    """Serialize a Problem back to `.tim` text (inverse of load_tim)."""
    lines = [f"{problem.n_events} {problem.n_rooms} "
             f"{problem.n_features} {problem.n_students}"]
    lines += [str(int(x)) for x in problem.room_size]
    lines += [str(int(x)) for x in problem.attends.reshape(-1)]
    lines += [str(int(x)) for x in problem.room_features.reshape(-1)]
    lines += [str(int(x)) for x in problem.event_features.reshape(-1)]
    return "\n".join(lines) + "\n"


def random_instance(key_or_seed, n_events: int, n_rooms: int,
                    n_features: int, n_students: int,
                    attend_prob: float = 0.05,
                    feature_prob: float = 0.3,
                    n_days: int = DAYS_DEFAULT,
                    slots_per_day: int = SLOTS_PER_DAY_DEFAULT) -> Problem:
    """Synthetic instance generator (for tests and benchmarks); room 0
    satisfies every feature so no event is unplaceable."""
    rng = np.random.default_rng(key_or_seed)
    attends = (rng.random((n_students, n_events)) < attend_prob).astype(np.int8)
    event_features = (rng.random((n_events, n_features))
                      < feature_prob).astype(np.int8)
    room_features = (rng.random((n_rooms, n_features)) < 0.6).astype(np.int8)
    room_features[0, :] = 1
    student_count = attends.sum(axis=0)
    cap = max(int(student_count.max()), 1)
    room_size = rng.integers(max(cap // 2, 1), cap + 1,
                             size=n_rooms).astype(np.int32)
    room_size[0] = cap
    return derive(n_events, n_rooms, n_features, n_students, room_size,
                  attends, room_features, event_features,
                  n_days=n_days, slots_per_day=slots_per_day)


def itc_like_instance(key_or_seed, n_events: int = 400, n_rooms: int = 10,
                      n_features: int = 10, n_students: int = 200,
                      n_days: int = DAYS_DEFAULT,
                      slots_per_day: int = SLOTS_PER_DAY_DEFAULT,
                      return_planted: bool = False):
    """ITC-2002-style instance with a PLANTED perfect solution (events on
    injective (slot, room) cells off every day's last slot; each student
    takes 0 or 2-4 non-consecutive-triple slots per day; features and
    capacities built around the planted rooms). Returns the Problem, or
    (Problem, planted_slots, planted_rooms) when `return_planted`."""
    rng = np.random.default_rng(key_or_seed)
    spd, D = slots_per_day, n_days
    T = D * spd
    usable = [t for t in range(T) if t % spd != spd - 1]
    cells = [(t, r) for t in usable for r in range(n_rooms)]
    if n_events > len(cells):
        raise ValueError(
            f"{n_events} events do not fit {len(usable)} usable slots x "
            f"{n_rooms} rooms")
    rng.shuffle(cells)
    planted = cells[:n_events]
    p_slots = np.array([t for t, _ in planted], dtype=np.int32)
    p_rooms = np.array([r for _, r in planted], dtype=np.int32)
    by_slot = {t: np.nonzero(p_slots == t)[0] for t in usable}
    by_slot = {t: ev for t, ev in by_slot.items() if ev.size}

    def pattern_choices(av):
        out = []
        for k in (2, 3, 4):
            for c in combinations(av, k):
                if not any(c[i + 2] - c[i] == 2
                           for i in range(len(c) - 2)):
                    out.append(c)
        return out

    day_choices = [pattern_choices(
        [j for j in range(spd - 1) if (d * spd + j) in by_slot])
        for d in range(D)]

    attends = np.zeros((n_students, n_events), dtype=np.int8)
    for s in range(n_students):
        active_days = set(rng.permutation(D)[: rng.integers(3, D + 1)]
                          .tolist())
        for d in range(D):
            if d not in active_days or not day_choices[d]:
                continue
            pat = day_choices[d][rng.integers(len(day_choices[d]))]
            for j in pat:
                ev = by_slot[d * spd + j]
                attends[s, ev[rng.integers(ev.size)]] = 1

    room_features = np.zeros((n_rooms, n_features), dtype=np.int8)
    for r in range(n_rooms):
        k = rng.integers(3, max(4, n_features - 1))
        room_features[r, rng.permutation(n_features)[:k]] = 1
    event_features = np.zeros((n_events, n_features), dtype=np.int8)
    for e in range(n_events):
        has = np.nonzero(room_features[p_rooms[e]])[0]
        k = rng.integers(1, min(4, has.size) + 1)
        event_features[e, rng.permutation(has)[:k]] = 1

    student_count = attends.astype(np.int64).sum(axis=0).astype(np.int32)
    room_size = np.ones((n_rooms,), dtype=np.int32)
    for e in range(n_events):
        r = p_rooms[e]
        room_size[r] = max(room_size[r], int(student_count[e]))

    p = derive(n_events, n_rooms, n_features, n_students, room_size,
               attends, room_features, event_features,
               n_days=n_days, slots_per_day=slots_per_day)
    if return_planted:
        return p, p_slots, p_rooms
    return p


def room_tight_instance(key_or_seed, n_events: int, n_rooms: int,
                        n_features: int, n_students: int,
                        attend_prob: float = 0.05,
                        feature_prob: float = 0.4,
                        n_days: int = DAYS_DEFAULT,
                        slots_per_day: int = SLOTS_PER_DAY_DEFAULT
                        ) -> Problem:
    """Room-tight synthetic instance: no universal room, capacities drawn
    from the events' sizes, ~40% feature coverage, so each slot's
    possible rooms are few and overlap unevenly. An event with no
    possible room gets the room needing the fewest changes upgraded,
    until every event is placeable somewhere."""
    rng = np.random.default_rng(key_or_seed)
    attends = (rng.random((n_students, n_events))
               < attend_prob).astype(np.int8)
    event_features = (rng.random((n_events, n_features))
                      < feature_prob).astype(np.int8)
    room_features = (rng.random((n_rooms, n_features)) < 0.4).astype(np.int8)
    student_count = attends.astype(np.int64).sum(axis=0).astype(np.int32)
    sizes = np.sort(student_count)
    picks = rng.integers(0, max(n_events, 1), size=n_rooms)
    room_size = np.maximum(sizes[picks], 1).astype(np.int32)
    for _ in range(n_features + 1):
        p = derive(n_events, n_rooms, n_features, n_students, room_size,
                   attends, room_features, event_features,
                   n_days=n_days, slots_per_day=slots_per_day)
        orphan = np.nonzero(~p.possible.any(axis=1))[0]
        if orphan.size == 0:
            return p
        for e in orphan:
            need = event_features[e].astype(bool)
            deficit = ((need & ~room_features.astype(bool)).sum(axis=1)
                       + (room_size < student_count[e]) * 1)
            r = int(np.argmin(deficit))
            room_features[r][need] = 1
            room_size[r] = max(room_size[r], student_count[e])
    return p
