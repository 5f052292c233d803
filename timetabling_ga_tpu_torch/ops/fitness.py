"""Batched fitness evaluation (port of timetabling_ga_tpu/ops/fitness.py).

Every function takes a population: slots/rooms `(P, E)` int32 -> `(P,)`.
The plain versions repeat the JAX contractions over one-hot operands in
float32 (all values are small exact integers, so every sum is exact);
`batch_penalty` is the wrapper of kernel K2 (csrc/batch_penalty.cu),
which computes the same counts in int32 on the card.
"""

from __future__ import annotations

import torch

from timetabling_ga_tpu_torch import kernels

# Penalty encoding (reference Solution.cpp:167 and ga.cpp:191)
INFEASIBLE_OFFSET = 1_000_000


def check_no_tf32(t: torch.Tensor) -> None:
    """The plain versions' float32 matmuls are exact only without TF32:
    refuse to run them on the card with it enabled."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are enabled; the plain fitness "
                           "contractions need full float32")


def slot_onehot(slots: torch.Tensor, n_slots: int) -> torch.Tensor:
    """(P, E) int -> (P, T, E) float32 one-hot of event timeslots."""
    ar = torch.arange(n_slots, device=slots.device, dtype=slots.dtype)
    return (slots[:, None, :] == ar[None, :, None]).to(torch.float32)


def room_onehot(rooms: torch.Tensor, n_rooms: int) -> torch.Tensor:
    """(P, E) int -> (P, R, E) float32 one-hot of event rooms."""
    ar = torch.arange(n_rooms, device=rooms.device, dtype=rooms.dtype)
    return (rooms[:, None, :] == ar[None, :, None]).to(torch.float32)


def compute_hcv(pa, slots, rooms) -> torch.Tensor:
    """Hard-constraint violations (P,) int32: room clash pairs,
    correlated pairs sharing a slot, events in unsuitable rooms
    (Solution.cpp:141-160; JAX fitness.py:57)."""
    check_no_tf32(slots)
    X = slot_onehot(slots, pa.n_slots) * pa.event_mask[None, None, :]
    Y = room_onehot(rooms, pa.n_rooms)
    occ = X @ Y.transpose(1, 2)                         # (P, T, R)
    pair_clash = (occ * (occ - 1.0)).sum((1, 2)) * 0.5
    full = ((X @ pa.conflict) * X).sum((1, 2))
    diag = torch.diagonal(pa.conflict).sum()
    corr_pairs = (full - diag) * 0.5
    E = slots.shape[1]
    ar = torch.arange(E, device=slots.device)
    unsuitable = ((~pa.possible[ar[None, :], rooms.long()]).to(torch.int32)
                  * pa.live[None, :]).sum(1)
    return (pair_clash + corr_pairs).to(torch.int32) + unsuitable.to(
        torch.int32)


def attendance_matrix(pa, slots) -> torch.Tensor:
    """Per-(student, slot) attended-event counts (P, S, T) float32."""
    check_no_tf32(slots)
    X = slot_onehot(slots, pa.n_slots)                  # (P, T, E)
    return pa.attends @ X.transpose(1, 2)               # (P, S, T)


def day_view(x: torch.Tensor, n_days: int, spd: int) -> torch.Tensor:
    """(..., T) -> (..., D, spd)."""
    return x.reshape(x.shape[:-1] + (n_days, spd))


def scv_from_attendance(pa, slots, att) -> torch.Tensor:
    """Soft-constraint violations (P,) int32 given attendance counts:
    last-slot classes weighted by students, runs of >= 3, single-class
    days (Solution.cpp:86-139; JAX fitness.py:106)."""
    spd = pa.slots_per_day
    last_mask = (slots % spd) == (spd - 1)
    last = torch.where(last_mask, pa.student_count[None, :], 0).sum(1)
    b = day_view(att > 0, pa.n_days, spd)               # (P, S, D, spd)
    consec = (b[..., 2:] & b[..., 1:-1] & b[..., :-2]).to(
        torch.int32).sum((1, 2, 3))
    single = (b.sum(-1) == 1).to(torch.int32).sum((1, 2))
    return (last + consec + single).to(torch.int32)


def compute_scv(pa, slots) -> torch.Tensor:
    return scv_from_attendance(pa, slots, attendance_matrix(pa, slots))


def base_penalty(hcv, scv):
    """scv if feasible else 1_000_000 + hcv (Solution.cpp:162-170)."""
    return torch.where(hcv == 0, scv, INFEASIBLE_OFFSET + hcv)


def anchor_cost(pa, slots) -> torch.Tensor:
    """Weighted Hamming distance to the anchor timetable (P,) int32."""
    return (pa.anchor_w[None, :]
            * (slots != pa.anchor_slots[None, :]).to(torch.int32)).sum(1)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (P, E), idx (P, ...) -> x[p, idx[p, ...]] with idx's shape."""
    P = x.shape[0]
    return torch.gather(x, 1, idx.reshape(P, -1).long()).reshape(idx.shape)


def anchor_delta(pa, slots, evs, new_slots) -> torch.Tensor:
    """Anchor-cost change of sparse moves: slots (P, E), evs/new_slots
    (P, ..., M) -> (P, ...). Inactive lanes pass new == old and cancel."""
    evl = evs.long()
    w = pa.anchor_w[evl]
    old = gather_rows(slots, evs)
    anc = pa.anchor_slots[evl]
    return (w * ((new_slots != anc).to(torch.int32)
                 - (old != anc).to(torch.int32))).sum(-1)


def batch_penalty_plain(pa, slots, rooms):
    """Plain version of K2: (penalty, hcv, scv), each (P,) int32."""
    hcv = compute_hcv(pa, slots, rooms)
    scv = compute_scv(pa, slots)
    penalty = base_penalty(hcv, scv) + anchor_cost(pa, slots)
    return penalty.to(torch.int32), hcv, scv


def batch_penalty(pa, slots, rooms):
    """Evaluate a population: slots/rooms (P, E) int32 -> (penalty, hcv,
    scv), each (P,) int32. Kernel K2 on a CUDA tensor, the plain
    version on a CPU one."""
    if not slots.is_cuda:
        return batch_penalty_plain(pa, slots, rooms)
    P, E = slots.shape
    if slots.dtype != torch.int32 or rooms.dtype != torch.int32:
        raise TypeError("batch_penalty takes int32 slots and rooms")
    slots = slots.contiguous()
    rooms = rooms.contiguous()
    out = torch.empty((3, P), dtype=torch.int32, device=slots.device)
    pen, hcv, scv = out[0], out[1], out[2]
    if P == 0:
        return pen, hcv, scv
    p = kernels.ptr
    kernels.launch(
        "batch_penalty", p(slots), p(rooms), p(pa.possible_u8), p(pa.live),
        p(pa.student_count), p(pa.conflict_bits), p(pa.stu_ptr),
        p(pa.stu_ev), p(pa.anchor_slots), p(pa.anchor_w), p(pen), p(hcv),
        p(scv), P, E, pa.n_rooms, pa.n_students, pa.n_slots,
        pa.slots_per_day, pa.conflict_bits.shape[1], pa.conflict_diag)
    return pen, hcv, scv


def lex_order(penalty, scv) -> torch.Tensor:
    """Indices sorting the last axis by (penalty, scv), ties by position:
    two stable sorts, the tie order of jnp.lexsort((scv, penalty))."""
    o1 = torch.sort(scv, dim=-1, stable=True).indices
    o2 = torch.sort(torch.gather(penalty, -1, o1), dim=-1,
                    stable=True).indices
    return torch.gather(o1, -1, o2)
