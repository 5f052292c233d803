"""Shape bucketing (copy of timetabling_ga_tpu/serve/bucket.py:46-193):
pad an instance to its geometric bucket, neutrally.

The serve scheduler packs only jobs of one bucket into a dispatch: their
padded problems share E, R, F, S and the slot grid, so one launch of K6
or K8's chain serves every lane (problem.LaneProblems) with the same
shared memory. The neutrality contract is JAX's:

  - padded EVENTS attend no students, require no features and carry
    `event_mask == 0`: the kernels and their plain versions exclude
    them from occupancy, clashes, correlation and the unsuitable-room
    count — their slots and rooms cannot move a penalty;
  - padded ROOMS have zero capacity and features and `room_mask ==
    False`: no event finds them possible, and every room argmin carries
    the dead-room key penalty, so no live event chooses one;
  - `possible[padded_event, :]` is False everywhere, so relocating a
    padded event has a zero unsuitable-room delta on every path.

So for any genotype that places the live events as an unpadded genotype
does, (penalty, hcv, scv) are equal bit for bit, and the greedy matcher
gives the live events the same rooms (tests/test_torch_serve.py holds
both against JAX's, as tests/test_serve.py does for JAX).

The key math (BucketSpec, bucket_key_from_counts) loads neither torch
nor numpy, so the fleet gateway routes by bucket without them; the
padding imports them when it runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import numpy as np

    from timetabling_ga_tpu_torch.problem import Problem


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Geometric bucket boundaries: dim -> smallest floor*ratio^k >= n.

    Floors keep tiny instances from over-fragmenting the small buckets;
    ratio 2 bounds padding waste below 2x per dimension (the classic
    geometric-bucketing bound). The slot grid (n_days, slots_per_day)
    is never padded — it is part of the bucket key instead: timeslot
    semantics (last-slot-of-day scv, day windows) are not maskable."""

    event_floor: int = 32
    room_floor: int = 4
    feature_floor: int = 4
    student_floor: int = 32
    ratio: float = 2.0


DEFAULT_SPEC = BucketSpec()


def _round_up(n: int, floor: int, ratio: float) -> int:
    if n <= 0:
        return floor
    size = floor
    while size < n:
        size = math.ceil(size * ratio)
    return size


def bucket_dims(problem: Problem, spec: BucketSpec = DEFAULT_SPEC
                ) -> tuple[int, int, int, int]:
    """(E', R', F', S') bucket boundaries for `problem`."""
    return (_round_up(problem.n_events, spec.event_floor, spec.ratio),
            _round_up(problem.n_rooms, spec.room_floor, spec.ratio),
            _round_up(problem.n_features, spec.feature_floor, spec.ratio),
            _round_up(problem.n_students, spec.student_floor, spec.ratio))


def bucket_key_from_counts(n_events: int, n_rooms: int, n_features: int,
                           n_students: int, n_days: int,
                           slots_per_day: int,
                           spec: BucketSpec = DEFAULT_SPEC) -> tuple:
    """bucket_key from raw instance counts — no Problem required (the
    `.tim` header's four counts and the slot grid)."""
    return (_round_up(n_events, spec.event_floor, spec.ratio),
            _round_up(n_rooms, spec.room_floor, spec.ratio),
            _round_up(n_features, spec.feature_floor, spec.ratio),
            _round_up(n_students, spec.student_floor, spec.ratio),
            int(n_days), int(slots_per_day))


def bucket_key(problem: Problem, spec: BucketSpec = DEFAULT_SPEC
               ) -> tuple:
    """The packing key: bucket dims + the slot grid. Jobs with equal
    keys share every shape, so the scheduler packs them into one
    dispatch (one launch of each kernel a generation)."""
    return bucket_key_from_counts(
        problem.n_events, problem.n_rooms, problem.n_features,
        problem.n_students, problem.n_days, problem.slots_per_day, spec)


def pad_problem(problem: Problem, spec: BucketSpec = DEFAULT_SPEC
                ) -> Problem:
    """Pad `problem` up to its bucket boundaries with masked padding.

    Returns a new Problem whose raw arrays are zero-padded to
    `bucket_dims`, whose `possible` matrix enforces the neutrality
    contract (module docstring), and whose `n_live_events` /
    `n_live_rooms` drive the ProblemArrays validity masks. Idempotent
    on an already-bucket-shaped instance (same dims in = same dims
    out), and a no-op-shaped instance still gets the mask fields set."""
    import numpy as np

    from timetabling_ga_tpu_torch.problem import derive
    E, R, F, S = (problem.n_events, problem.n_rooms, problem.n_features,
                  problem.n_students)
    Ep, Rp, Fp, Sp = bucket_dims(problem, spec)
    # The room-key packing bound (ops/rooms.py check_packing: E < 4096
    # and R < 4096) applies to the PADDED dims — geometric rounding can
    # push an instance the single-run engine solves fine (e.g. E = 2500)
    # up to a bucket past it. Reject it here, at admission, with an
    # actionable error instead.
    if Ep >= 4096 or Rp >= 4096:
        raise ValueError(
            f"instance too large for serve bucketing: padded dims "
            f"events={Ep} rooms={Rp} exceed the room-key packing "
            f"bound 4096 (instance events={E} rooms={R}; use the "
            f"single-run engine, or a finer BucketSpec ratio)")

    room_size = np.zeros((Rp,), np.int32)
    room_size[:R] = problem.room_size
    attends = np.zeros((Sp, Ep), np.int8)
    attends[:S, :E] = problem.attends
    room_features = np.zeros((Rp, Fp), np.int8)
    room_features[:R, :F] = problem.room_features
    event_features = np.zeros((Ep, Fp), np.int8)
    event_features[:E, :F] = problem.event_features

    padded = derive(Ep, Rp, Fp, Sp, room_size, attends, room_features,
                    event_features, n_days=problem.n_days,
                    slots_per_day=problem.slots_per_day)
    # derive() leaves zero-padding mostly neutral (conflict rows/cols and
    # student counts of padded events are zero by construction), but the
    # suitability matrix needs the explicit contract: a zero-requirement
    # live event would otherwise find a zero-capacity padded room
    # "possible", and padded events would look placeable everywhere.
    possible = np.array(padded.possible)
    possible[E:, :] = False       # padded events suit NO room
    possible[:, R:] = False       # padded rooms suit NO event
    # anchored-objective columns ride along zero-padded: padded events
    # carry anchor weight 0, so the anchor cost of a padded genotype
    # equals the unpadded instance's bit-exactly (the same neutrality
    # contract as every other term)
    anchor_slots = anchor_w = None
    if problem.anchor_slots is not None:
        anchor_slots = np.zeros((Ep,), np.int32)
        anchor_slots[:E] = problem.anchor_slots
    if problem.anchor_w is not None:
        anchor_w = np.zeros((Ep,), np.int32)
        anchor_w[:E] = problem.anchor_w
    return dataclasses.replace(padded, possible=possible,
                               n_live_events=E, n_live_rooms=R,
                               anchor_slots=anchor_slots,
                               anchor_w=anchor_w)


def embed_population(slots: np.ndarray, rooms: np.ndarray,
                     padded: Problem) -> tuple[np.ndarray, np.ndarray]:
    """Extend (P, E) live genotypes to the padded (P, E') shape.

    Padded events are parked at slot 0 / room 0 — any valid indices
    work, since the masks make them fitness- and matching-invisible."""
    import numpy as np
    P, E = slots.shape
    Ep = padded.n_events
    s = np.zeros((P, Ep), np.int32)
    r = np.zeros((P, Ep), np.int32)
    s[:, :E] = slots
    r[:, :E] = rooms
    return s, r


def extract_solution(slots, rooms, padded: Problem):
    """Slice a padded genotype back to the live events."""
    import numpy as np
    E = (padded.n_live_events if padded.n_live_events is not None
         else padded.n_events)
    return np.asarray(slots)[..., :E], np.asarray(rooms)[..., :E]
