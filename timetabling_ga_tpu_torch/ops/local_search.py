"""Random-candidate local search by full re-evaluation (port of
timetabling_ga_tpu/ops/local_search.py:40, the `--ls-full-eval` form).

Each round applies K candidate moves to every individual's current row,
scores each candidate by a full evaluation and keeps the individual's
first candidate of least penalty where it is strictly below its current
one. It takes the same `LSDraws` as ops/delta.py
`batch_local_search_delta` and gives the same rows; it is the
independent check of that delta-scored search.

`batch_local_search` takes and returns rows as the delta form does
(`LSRows`: the assignments and their penalty terms, which the search
carries from the starting terms through every accepted evaluation).
`batch_local_search_kernel` is the wrapper of kernel K12
(csrc/full_eval_ls.cu): K8's pre-pass takes every candidate's events,
then one launch runs every round of every individual
(`full_eval_ls_chain`); `batch_local_search_plain` is its plain version,
a Python loop over the rounds.
"""

from __future__ import annotations

import torch

from timetabling_ga_tpu_torch import kernels, work
from timetabling_ga_tpu_torch.ops import fitness
from timetabling_ga_tpu_torch.ops.delta import (
    LSDraws, LSRows, a16, init_rows, random_ls_events_kernel)
from timetabling_ga_tpu_torch.ops.moves import MoveDraws, random_move_plain

# the largest cluster of CTAs K12 gives an individual
# (csrc/full_eval_ls.cu K12_MAX_CLUSTER), the bytes of one chunk of
# rounds' draws in its shared memory (K12_CHUNK_BYTES) and the threads of
# a CTA (K12_THREADS)
K12_MAX_CLUSTER = 8
K12_CHUNK_BYTES = 12288
K12_THREADS = 512


def full_eval_cluster(n_candidates: int) -> int:
    """CTAs K12 gives an individual: one a candidate, at most 8."""
    return min(n_candidates, K12_MAX_CLUSTER)


def full_eval_ls_layout(pa, n_candidates: int) -> tuple:
    """Dynamic shared memory of one K12 CTA, the layout of
    csrc/full_eval_ls.cu `k12_smem_layout`, and what it stages: the
    current row and its candidate copy (slots, rooms, live slot
    bitsets), the reduction scratch, two inboxes of 8 records of 16
    ints, one chunk of rounds' draws (14 B a candidate) and the
    per-event problem arrays (live flags, student counts, anchor slots
    and weights), each rounded up to 16 bytes; the two rows' (T, R)
    int32 occupancies where they fit (kernels.stage_regions; else a
    global scratch row of 8 T R bytes a CTA); then the suitable-rooms
    table (E x R bytes) when it still fits in SMEM_LIMIT, then the
    conflict bitset and the students' CSR when they still fit (else K12
    reads each from global memory). Returns (bytes, occupancies staged,
    table staged, conflict bits and CSR staged)."""
    E, R, S, T = pa.n_events, pa.n_rooms, pa.n_students, pa.n_slots
    W = pa.conflict_bits.shape[1]
    K = n_candidates
    n = max(1, K12_CHUNK_BYTES // (14 * K)) * K

    base = a16(*(4 * E, 4 * E, 4 * T * W) * 2,
               16 * (K12_THREADS // 32), 4 * 2 * K12_MAX_CLUSTER * 16,
               6 * n, 4 * n, 4 * n, 4 * E, 4 * E, 4 * E, 4 * E)
    total, (occ,) = kernels.stage_regions(base, [2 * a16(4 * T * R)])
    table = total + a16(E * R) <= kernels.SMEM_LIMIT
    total += a16(E * R) if table else 0
    staged = total + a16(4 * E * W, 4 * (S + 1), 4 * pa.stu_ev.numel())
    if staged <= kernels.SMEM_LIMIT:
        return staged, occ, table, True
    return total, occ, table, False


def full_eval_ls_smem_bytes(pa, n_candidates: int) -> int:
    """Dynamic shared memory of one K12 CTA (full_eval_ls_layout)."""
    return full_eval_ls_layout(pa, n_candidates)[0]


def batch_local_search_plain(pa, draws: LSDraws, rows: LSRows) -> LSRows:
    """Plain version of K12: every round's K candidate rows (candidate k
    of individual p is row k * P + p) by random_move_plain, scored by
    batch_penalty_plain, the first of least penalty (jnp.argmin) kept
    where strictly below the individual's (JAX local_search.py:61-82)."""
    n_rounds, K, P = draws.mtype.shape
    slots, rooms, pen, hcv, scv = rows
    ar = torch.arange(P, device=slots.device)
    for r in range(n_rounds):
        md = MoveDraws(draws.mtype[r].reshape(-1),
                       draws.u[r].reshape(K * P, -1),
                       draws.t[r].reshape(-1))
        c_slots, c_rooms = random_move_plain(pa, md, slots.repeat(K, 1),
                                             rooms.repeat(K, 1))
        c_pen, c_hcv, c_scv = (x.reshape(K, P) for x in
                               fitness.batch_penalty_plain(pa, c_slots,
                                                           c_rooms))
        best = torch.argmin(c_pen, 0)
        better = c_pen[best, ar] < pen
        row = best * P + ar
        slots = torch.where(better[:, None], c_slots[row], slots)
        rooms = torch.where(better[:, None], c_rooms[row], rooms)
        pen, hcv, scv = (torch.where(better, c[best, ar], x) for c, x in (
            (c_pen, pen), (c_hcv, hcv), (c_scv, scv)))
    return LSRows(slots, rooms, pen, hcv, scv)


def full_eval_ls_chain(pa, draws: LSDraws, rows: LSRows,
                       events: torch.Tensor, cluster=None) -> LSRows:
    """K12 on CUDA tensors, given every candidate's events from K8's
    pre-pass: every round for every individual in one launch, a cluster
    of `cluster` CTAs an individual (default full_eval_cluster(K); 1 to
    min(K, 8)). Where the two occupancies do not fit in shared memory,
    each CTA keeps them in a global scratch row and the clusters stride
    over the individuals, as many clusters as kernels.resident_grid
    gives CTAs: a row a CTA of every individual would be P x CS x 8 T R
    bytes (3 GB at P = 256, CS = 8 and R = 4,095), sized by the card it
    is at most ~0.4 GB. Raises ValueError when a CTA's state does not
    fit in shared memory; no fallback."""
    n_rounds, K, P = draws.mtype.shape
    E = rows.slots.shape[1]
    cs = full_eval_cluster(K) if cluster is None else cluster
    if not 1 <= cs <= full_eval_cluster(K):
        raise ValueError(f"full_eval_ls: a cluster of {cs} CTAs; it takes "
                         f"1 to {full_eval_cluster(K)} at K = {K}")
    kernels.check_smem("full_eval_ls", full_eval_ls_smem_bytes(pa, K))
    occ_staged = full_eval_ls_layout(pa, K)[1]
    if any(x.dtype != torch.int32 for x in rows):
        raise TypeError("full_eval_ls takes int32 slots, rooms, pen, hcv "
                        "and scv")
    if tuple(events.shape) != (P, n_rounds, K, 3) or \
            events.dtype != torch.int16 or rows.slots.shape[0] != P:
        raise ValueError("full_eval_ls: the draws do not fit the "
                         "population")
    i32 = torch.int32
    ins = [x.contiguous() for x in rows]
    dr = [draws.mtype.to(i32).contiguous(), events.contiguous(),
          draws.t.to(i32).contiguous()]
    out = LSRows(*(torch.empty_like(x) for x in ins))
    if P == 0:
        return out
    dev = rows.slots.device
    grid = P if occ_staged else kernels.resident_grid(P, dev, cs)
    buf = (None if occ_staged else
           torch.empty((grid * cs, 2, pa.n_slots, pa.n_rooms),
                       dtype=torch.int32, device=dev))
    p = kernels.ptr
    kernels.launch(
        "full_eval_ls", *(p(x) for x in ins + dr), p(pa.possible_u8),
        p(pa.cap_rank), p(pa.dead), p(pa.live), p(pa.student_count),
        p(pa.conflict_bits), p(pa.stu_ptr), p(pa.stu_ev),
        p(pa.anchor_slots), p(pa.anchor_w), *(p(x) for x in out),
        None if buf is None else p(buf), P, E,
        pa.n_rooms, pa.n_students, pa.n_slots, pa.slots_per_day,
        pa.conflict_bits.shape[1], K, n_rounds, pa.stu_ev.numel(),
        pa.conflict_diag, cs, int(occ_staged), grid,
        work=work.full_eval_ls(pa, draws, rows))
    return out


def batch_local_search_kernel(pa, draws: LSDraws, rows: LSRows,
                              cluster=None) -> LSRows:
    """Kernel K12 on CUDA tensors: K8's pre-pass takes every candidate's
    events, then the chain runs every round of every individual."""
    n_rounds, K, P = draws.mtype.shape
    if tuple(draws.u.shape) != (n_rounds, K, P, rows.slots.shape[1]):
        raise ValueError("full_eval_ls: the draws do not fit the "
                         "population")
    return full_eval_ls_chain(pa, draws, rows, random_ls_events_kernel(draws),
                              cluster)


def batch_local_search(pa, draws: LSDraws, slots, rooms,
                       scores=None) -> LSRows:
    """Hill-climb a (P, E) population for draws' n_rounds rounds of K
    candidates each, from its penalty terms `scores` where the caller
    holds them (else K2's); returns the rows with the terms of their last
    accepted evaluation. Kernel K12 on CUDA tensors, the plain version
    on CPU ones."""
    rows = init_rows(pa, slots, rooms, scores)
    if not slots.is_cuda:
        kernels.tally(work.random_ls_events(draws))
        kernels.tally(work.full_eval_ls(pa, draws, rows))
        return batch_local_search_plain(pa, draws, rows)
    return batch_local_search_kernel(pa, draws, rows)
