"""Random-candidate local search by full re-evaluation (port of
timetabling_ga_tpu/ops/local_search.py:40, the `--ls-full-eval` form).

Each round applies the K candidate moves of every individual (K6's
relocation entry, one launch for all K x P rows), evaluates them all
(K2, one launch), and keeps each individual's first candidate of least
penalty where it is strictly below its current one. It takes the same
`LSDraws` as ops/delta.py `batch_local_search_delta` and gives the same
result; it is the debugging twin of that kernel, a composition of hand
kernels with no kernel of its own (2 launches plus the choice a round).
"""

from __future__ import annotations

import torch

from timetabling_ga_tpu_torch.ops import fitness
from timetabling_ga_tpu_torch.ops.delta import LSDraws
from timetabling_ga_tpu_torch.ops.moves import MoveDraws, random_move


def batch_local_search(pa, draws: LSDraws, slots, rooms, pen=None):
    """Hill-climb a (P, E) population for draws' n_rounds rounds of K
    candidates each, from its penalties `pen` where the caller holds them
    (else K2's); returns the improved (slots, rooms)."""
    n_rounds, K, P = draws.mtype.shape
    if pen is None:
        pen, _, _ = fitness.batch_penalty(pa, slots, rooms)
    ar = torch.arange(P, device=slots.device)
    for r in range(n_rounds):
        # candidate k of individual p is row k * P + p
        md = MoveDraws(draws.mtype[r].reshape(-1),
                       draws.u[r].reshape(K * P, -1),
                       draws.t[r].reshape(-1))
        c_slots, c_rooms = random_move(pa, md, slots.repeat(K, 1),
                                       rooms.repeat(K, 1))
        c_pen, _, _ = fitness.batch_penalty(pa, c_slots, c_rooms)
        c_pen = c_pen.reshape(K, P)
        best = torch.argmin(c_pen, 0)
        best_pen = c_pen[best, ar]
        better = best_pen < pen
        row = best * P + ar
        slots = torch.where(better[:, None], c_slots[row], slots)
        rooms = torch.where(better[:, None], c_rooms[row], rooms)
        pen = torch.where(better, best_pen, pen)
    return slots, rooms
