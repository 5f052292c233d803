"""Delta candidate evaluation (port of timetabling_ga_tpu/ops/delta.py:50-208).

Maintained per-individual tensors:

    att (P, S, T) int16   per-(student, slot) attended-event counts
    occ (P, T, R) int16   per-(slot, room) occupancy counts

A candidate is a padded 3-relocation (events, new slots, active flags).
`delta_one` is the wrapper of kernel K4 (csrc/delta_one.cu), batched
over `(P, C)` candidates; `delta_one_plain` is its plain version, the
JAX `_delta_one` written out over the same batch. `apply_moves`
commits one accepted candidate per individual.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import fitness
from timetabling_ga_tpu_torch.ops.fitness import gather_rows
from timetabling_ga_tpu_torch.ops.rooms import choose_room, occupancy


class LSState(NamedTuple):
    """Per-population local-search state (all leading-axis P)."""

    slots: torch.Tensor   # (P, E) int32
    rooms: torch.Tensor   # (P, E) int32
    att: torch.Tensor     # (P, S, T) int16
    occ: torch.Tensor     # (P, T, R) int16
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


def init_state(pa, slots, rooms) -> LSState:
    """Maintained tensors + baseline fitness for a population."""
    pen, hcv, scv = fitness.batch_penalty(pa, slots, rooms)
    att = attendance_counts(pa, slots).to(torch.int16)
    occ = occupancy(pa, slots, rooms).to(torch.int16)
    return LSState(slots=slots, rooms=rooms, att=att, occ=occ,
                   pen=pen, hcv=hcv, scv=scv)


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


def delta_one(pa, slots, rooms, att, occ, evs, new_slots, active):
    """Delta of padded 3-relocation candidates (P, C, 3) on individuals
    (P, ...): (d_hcv (P, C), d_scv (P, C), new_rooms (P, C, 3)). Kernel
    K4 on CUDA tensors, the plain version on CPU ones."""
    if not slots.is_cuda:
        return delta_one_plain(pa, slots, rooms, att, occ, evs, new_slots,
                               active)
    P, C, _ = evs.shape
    if att.dtype != torch.int16 or occ.dtype != torch.int16:
        raise TypeError("delta_one takes int16 att/occ")
    args = [x.contiguous() for x in (slots, rooms, att, occ,
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
        pa.conflict_bits.shape[1])
    return d[0], d[1], new_rooms


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
