"""Room assignment (port of timetabling_ga_tpu/ops/rooms.py:54-143, 332).

Greedy most-constrained-first matching: events in stable ascending
order of their suitable-room count, each taking the argmin over rooms of
the marginal-hcv-cost key `(occ + unsuit) * 2^13 + unsuit * 2^12 +
cap_rank + dead` on its slot's occupancy row. `assign_rooms` is the
wrapper of kernel K1 (csrc/assign_rooms.cu); `assign_rooms_plain` is
its plain version, a Python loop over events batched over individuals.
"""

from __future__ import annotations

import torch

from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.problem import W_DEAD

# Composite-key weights (JAX rooms.py:42-51)
W_COST = 1 << 13
W_UNSUIT = 1 << 12


def _dead_rooms(pa) -> torch.Tensor:
    """(R,) int32 additive key penalty of masked-out rooms."""
    return (~pa.room_mask).to(torch.int32) * W_DEAD


def capacity_rank(pa) -> torch.Tensor:
    """(R,) int32 rank of each room by capacity (0 = smallest): a double
    stable argsort, as jnp.argsort(jnp.argsort(room_size))."""
    o = torch.sort(pa.room_size, stable=True).indices
    return torch.sort(o, stable=True).indices.to(torch.int32)


def _room_key(pa, occ_row, event, cap_rank) -> torch.Tensor:
    """Key (..., R) for choosing `event`'s (...,) room on occupancy rows
    (..., R); argmin wins. Must stay in lockstep with the kernels'."""
    unsuit = (~pa.possible[event.long()]).to(torch.int32)
    return ((occ_row.to(torch.int32) + unsuit) * W_COST + unsuit * W_UNSUIT
            + cap_rank + _dead_rooms(pa))


def choose_room(pa, occ_row, event, cap_rank=None) -> torch.Tensor:
    """Room (...,) int32 for `event` on its slot's occupancy row."""
    if cap_rank is None:
        cap_rank = capacity_rank(pa)
    return torch.argmin(_room_key(pa, occ_row, event, cap_rank),
                        dim=-1).to(torch.int32)


def check_packing(pa) -> None:
    """Key-packing bounds: cap_rank (< R) must stay under the unsuit
    flag field and the whole key inside int32 (JAX rooms.py:122)."""
    E, R = pa.possible.shape
    if not (E < 4096 and R < W_UNSUIT):
        raise ValueError(f"room key packing needs E < 4096 and R < 4096, "
                         f"got E={E} R={R}")


def assign_rooms_plain(pa, slots) -> torch.Tensor:
    """Plain version of K1: (P, E) slots -> (P, E) rooms."""
    check_packing(pa)
    P, E = slots.shape
    dev = slots.device
    occ = torch.zeros((P, pa.n_slots, pa.n_rooms), dtype=torch.int32,
                      device=dev)
    rooms = torch.zeros((P, E), dtype=torch.int32, device=dev)
    ar = torch.arange(P, device=dev)
    order = pa.room_order.tolist()
    live = pa.live.tolist()
    for e in order:
        t = slots[:, e].long()
        ev = torch.full((P,), e, dtype=torch.long, device=dev)
        r = choose_room(pa, occ[ar, t], ev, pa.cap_rank)
        rooms[:, e] = r
        occ[ar, t, r.long()] += live[e]
    return rooms


def assign_rooms_kernel(pa, slots) -> torch.Tensor:
    """Kernel K1: the whole population in one launch, a warp each."""
    check_packing(pa)
    if slots.dtype != torch.int32:
        raise TypeError("assign_rooms takes int32 slots")
    slots = slots.contiguous()
    P, E = slots.shape
    rooms = torch.empty_like(slots)
    if P == 0:
        return rooms
    p = kernels.ptr
    kernels.launch("assign_rooms", p(slots), p(rooms), p(pa.possible_u8),
                   p(pa.cap_rank), p(pa.dead), p(pa.live),
                   p(pa.room_order), P, E, pa.n_rooms, pa.n_slots)
    return rooms


def assign_rooms(pa, slots) -> torch.Tensor:
    """Full room matching of a population: (P, E) int32 slots -> (P, E)
    int32 rooms. Kernel K1 on a CUDA tensor, the plain version on a CPU
    one."""
    if not slots.is_cuda:
        return assign_rooms_plain(pa, slots)
    return assign_rooms_kernel(pa, slots)


def occupancy(pa, slots, rooms) -> torch.Tensor:
    """Occupancy counts (P, T, R) int32; padded events occupy nothing."""
    P = slots.shape[0]
    R = pa.n_rooms
    idx = slots.long() * R + rooms.long()
    occ = torch.zeros((P, pa.n_slots * R), dtype=torch.int32,
                      device=slots.device)
    occ.scatter_add_(1, idx, pa.live[None, :].expand(P, -1).contiguous())
    return occ.reshape(P, pa.n_slots, R)
