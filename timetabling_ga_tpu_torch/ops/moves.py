"""Neighbourhood moves (port of timetabling_ga_tpu/ops/moves.py:40-181).

Every move is a functional update of a population `(P, E)`: it
relocates events and greedily re-rooms only the moved ones on the
occupancy grid minus the moved events (rooms.choose_room). Randomness
comes in as tensors (`MoveDraws`), made by `make_move_draws` from a
torch.Generator — or, in the tests, from the JAX key tree.

`relocation_chain` is the wrapper of kernel K6's relocation entry
(csrc/breed.cu `tt_relocate`), which applies a row's moves in order in
one launch (the kicks'); `relocation_chain_plain` is its plain version,
`random_move_plain` (`sample_move` + `apply_relocation`) per move.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from timetabling_ga_tpu_torch import kernels, work
from timetabling_ga_tpu_torch.obs import prof as obs_prof
from timetabling_ga_tpu_torch.ops.fitness import gather_rows
from timetabling_ga_tpu_torch.ops.rooms import (
    _scratch, check_packing, choose_room, occupancy)


class MoveDraws(NamedTuple):
    """The draws of one random move per individual (moves.py:118-130);
    a chain of moves carries a leading move axis on every field."""

    mtype: torch.Tensor   # (P,) int   0 Move1 / 1 Move2 / 2 Move3
    u: torch.Tensor       # (P, E) f32 uniforms; their top 3 pick events
    t: torch.Tensor       # (P,) int   Move1 target slot


@functools.lru_cache(maxsize=64)
def move_probs(p1: float, p2: float, p3: float, device) -> torch.Tensor:
    """The (3,) float32 move-type weights on `device`, made once a
    device. On a card the copy leaves pinned memory without a fence: a
    pageable copy would synchronize the stream in every generation that
    draws moves, and a pipelined dispatch would wait for the one before
    it."""
    w = torch.tensor([p1, p2, p3], dtype=torch.float32)
    if torch.device(device).type == "cuda":
        return w.pin_memory().to(device, non_blocking=True)
    return w.to(device)


def make_move_draws(gens, rows_per_gen: int, n_events: int, n_slots: int,
                    p1: float, p2: float, p3: float, device) -> MoveDraws:
    """Draw MoveDraws for len(gens) * rows_per_gen individuals, each
    generator drawing its own block of rows."""
    probs = move_probs(p1, p2, p3, device)
    parts = []
    for g in gens:
        parts.append((
            torch.multinomial(probs, rows_per_gen, replacement=True,
                              generator=g),
            torch.rand((rows_per_gen, n_events), generator=g,
                       device=device),
            torch.randint(0, n_slots, (rows_per_gen,), generator=g,
                          device=device, dtype=torch.int32)))
    return MoveDraws(*(torch.cat([p[i] for p in parts]) for i in range(3)))


def _rows(P, device):
    return torch.arange(P, device=device)


def _remove(pa, occ, slots, rooms, e, weight_on):
    """Take event column `e` (P,) out of its occupancy cell where
    `weight_on` (P,) int is 1; padded events weigh 0."""
    ar = _rows(occ.shape[0], occ.device)
    w = pa.live[e.long()] * weight_on
    t = gather_rows(slots, e).long()
    r = gather_rows(rooms, e).long()
    occ[ar, t, r] -= w
    return w


def _set(x, e, v):
    ar = _rows(x.shape[0], x.device)
    x[ar, e.long()] = v.to(x.dtype)


@obs_prof.scope("tt.moves")
def move1(pa, slots, rooms, e, t):
    """Move event `e` (P,) to slot `t` (P,) and re-room it."""
    slots, rooms = slots.clone(), rooms.clone()
    occ = occupancy(pa, slots, rooms)
    ar = _rows(slots.shape[0], slots.device)
    _remove(pa, occ, slots, rooms, e, 1)
    r = choose_room(pa, occ[ar, t.long()], e, pa.cap_rank)
    _set(slots, e, t)
    _set(rooms, e, r)
    return slots, rooms


@obs_prof.scope("tt.moves")
def move2(pa, slots, rooms, e1, e2):
    """Swap the slots of e1 and e2 (P,); both re-roomed."""
    slots, rooms = slots.clone(), rooms.clone()
    ar = _rows(slots.shape[0], slots.device)
    t1, t2 = gather_rows(slots, e1), gather_rows(slots, e2)
    occ = occupancy(pa, slots, rooms)
    w1 = _remove(pa, occ, slots, rooms, e1, 1)
    _remove(pa, occ, slots, rooms, e2, 1)
    r1 = choose_room(pa, occ[ar, t2.long()], e1, pa.cap_rank)
    occ[ar, t2.long(), r1.long()] += w1
    r2 = choose_room(pa, occ[ar, t1.long()], e2, pa.cap_rank)
    _set(slots, e1, t2)
    _set(slots, e2, t1)
    _set(rooms, e1, r1)
    _set(rooms, e2, r2)
    return slots, rooms


@obs_prof.scope("tt.moves")
def move3(pa, slots, rooms, e1, e2, e3):
    """3-cycle: e1 -> slot of e2, e2 -> slot of e3, e3 -> slot of e1."""
    slots, rooms = slots.clone(), rooms.clone()
    ar = _rows(slots.shape[0], slots.device)
    t1, t2, t3 = (gather_rows(slots, e) for e in (e1, e2, e3))
    occ = occupancy(pa, slots, rooms)
    w1 = _remove(pa, occ, slots, rooms, e1, 1)
    w2 = _remove(pa, occ, slots, rooms, e2, 1)
    _remove(pa, occ, slots, rooms, e3, 1)
    r1 = choose_room(pa, occ[ar, t2.long()], e1, pa.cap_rank)
    occ[ar, t2.long(), r1.long()] += w1
    r2 = choose_room(pa, occ[ar, t3.long()], e2, pa.cap_rank)
    occ[ar, t3.long(), r2.long()] += w2
    r3 = choose_room(pa, occ[ar, t1.long()], e3, pa.cap_rank)
    for e, t, r in ((e1, t2, r1), (e2, t3, r2), (e3, t1, r3)):
        _set(slots, e, t)
        _set(rooms, e, r)
    return slots, rooms


def top3(u: torch.Tensor) -> torch.Tensor:
    """Indices (P, 3) of the three largest of each row, ties to the
    lower index (lax.top_k's order): a stable descending sort."""
    return torch.sort(u, dim=-1, descending=True, stable=True).indices[
        :, :3].to(torch.int32)


@obs_prof.scope("tt.moves")
def sample_move(pa, draws: MoveDraws, slots):
    """One random move per individual in padded 3-relocation form:
    (evs (P, 3), new_slots (P, 3), active (P, 3) bool); inactive entries
    keep their slot (Solution.cpp:441-469 sampling)."""
    evs = top3(draws.u)
    cur = gather_rows(slots, evs)                       # (P, 3)
    t = draws.t.to(slots.dtype)
    m = draws.mtype.long()
    move1_s = torch.stack([t, cur[:, 1], cur[:, 2]], 1)
    move2_s = torch.stack([cur[:, 1], cur[:, 0], cur[:, 2]], 1)
    move3_s = torch.stack([cur[:, 1], cur[:, 2], cur[:, 0]], 1)
    new_slots = torch.stack([move1_s, move2_s, move3_s], 1)[
        _rows(slots.shape[0], slots.device), m]
    table = torch.tensor([[True, False, False], [True, True, False],
                          [True, True, True]], device=slots.device)
    return evs, new_slots, table[m]


@obs_prof.scope("tt.moves")
def apply_relocation(pa, slots, rooms, evs, new_slots, active):
    """Apply padded 3-relocations (P, 3): remove the active events from
    the occupancy grid, then re-slot and greedily re-room them in order
    (the shared semantics of Move1/2/3)."""
    slots, rooms = slots.clone(), rooms.clone()
    occ = occupancy(pa, slots, rooms)
    ar = _rows(slots.shape[0], slots.device)
    old_slots = gather_rows(slots, evs).long()
    old_rooms = gather_rows(rooms, evs)
    live = pa.live[evs.long()]
    act = active.to(torch.int32) * live
    for m in range(3):
        occ[ar, old_slots[:, m], old_rooms[:, m].long()] -= act[:, m]
    for m in range(3):
        ns = new_slots[:, m].long()
        r_choice = choose_room(pa, occ[ar, ns], evs[:, m], pa.cap_rank)
        r_new = torch.where(active[:, m], r_choice, old_rooms[:, m])
        occ[ar, ns, r_new.long()] += act[:, m]
        _set(slots, evs[:, m], new_slots[:, m])
        _set(rooms, evs[:, m], r_new)
    return slots, rooms


@obs_prof.scope("tt.moves")
def random_move_plain(pa, draws: MoveDraws, slots, rooms):
    """One random move per individual: sample_move + apply_relocation."""
    evs, new_slots, active = sample_move(pa, draws, slots)
    return apply_relocation(pa, slots, rooms, evs, new_slots, active)


def relocation_chain_plain(pa, draws: MoveDraws, slots, rooms,
                           n_moves: int):
    """Plain version of K6's relocation entry: the first `n_moves` moves
    of `draws` (fields with a leading move axis) on every row, in order."""
    for i in range(n_moves):
        slots, rooms = random_move_plain(
            pa, MoveDraws(*(x[i] for x in draws)), slots, rooms)
    return slots, rooms


# rows of a K6 relocation block (csrc/breed.cu K6_WARPS), a warp each
RELOCATE_WARPS = 4


def relocate_stage(pa) -> tuple:
    """K6's relocation layout (csrc/breed.cu tt_relocate): (shared memory
    of one block, rows a block, global scratch bytes a row). A block
    takes RELOCATE_WARPS rows, a warp each, with each row's slots, rooms
    and (T, R) int32 occupancy; where four rows do not fit, two, then
    one; past one row, 0: four rows a block with their slots and rooms
    staged and their occupancy in global memory, a scratch row a warp."""
    row = 4 * (2 * pa.n_events + pa.n_slots * pa.n_rooms)
    limit = min(kernels.STAGE_LIMIT, kernels.SMEM_LIMIT)
    for rows in (RELOCATE_WARPS, 2, 1):
        if rows * row <= limit:
            return rows * row, rows, 0
    return (4 * RELOCATE_WARPS * 2 * pa.n_events, 0,
            4 * pa.n_slots * pa.n_rooms)


def relocate_smem_bytes(pa) -> int:
    """Shared memory of one K6 relocation block (relocate_stage)."""
    return relocate_stage(pa)[0]


def relocation_chain_kernel(pa, draws: MoveDraws, slots, rooms,
                            n_moves: int):
    """Kernel K6's relocation entry: every row's chain in one launch.
    Raises ValueError, before any launch, where a block's rows do not
    fit in shared memory."""
    check_packing(pa)
    smem, rows, scratch = relocate_stage(pa)
    kernels.check_smem("relocate", smem)
    if slots.dtype != torch.int32 or rooms.dtype != torch.int32:
        raise TypeError("relocation_chain takes int32 slots and rooms")
    if draws.u.dtype != torch.float32 or draws.u.shape[0] < n_moves:
        raise ValueError("relocation_chain: the draws need n_moves rows "
                         "of float32 uniforms")
    N, E = slots.shape
    ins = [x.contiguous() for x in (slots, rooms)]
    if N == 0 or n_moves == 0:
        return ins[0].clone(), ins[1].clone()
    dr = [draws.mtype[:n_moves].to(torch.int32).contiguous(),
          draws.u[:n_moves].contiguous(),
          draws.t[:n_moves].to(torch.int32).contiguous()]
    out = [torch.empty_like(x) for x in ins]
    # past one row a block, the blocks stride over the rows and each
    # warp's occupancy is a scratch row, sized by the blocks the card
    # holds at once (as K1's), not by N
    grid = (0 if rows else
            kernels.resident_grid(-(-N // RELOCATE_WARPS), slots.device))
    buf = _scratch(grid * RELOCATE_WARPS, scratch, slots.device)
    p = kernels.ptr
    kernels.launch("relocate", *(p(x) for x in ins + dr),
                   p(pa.possible_u8), p(pa.cap_rank), p(pa.dead),
                   p(pa.live), *(p(x) for x in out),
                   None if buf is None else p(buf), N, n_moves, E,
                   pa.n_rooms, pa.n_slots, rows, grid,
                   work=work.relocate(pa, slots, n_moves))
    return out[0], out[1]


@obs_prof.scope("tt.moves")
def relocation_chain(pa, draws: MoveDraws, slots, rooms, n_moves: int):
    """Apply the first `n_moves` random moves of `draws` (mtype/t
    (n, N), u (n, N, E)) to every row of (N, E) int32 slots/rooms, in
    order — the JAX kick's scan of random_move (islands.py:823-849).
    Kernel K6's relocation entry (one launch) on CUDA tensors, the plain
    version on CPU ones."""
    if not slots.is_cuda:
        if slots.shape[0] and n_moves:
            kernels.tally(work.relocate(pa, slots, n_moves))
        return relocation_chain_plain(pa, draws, slots, rooms, n_moves)
    return relocation_chain_kernel(pa, draws, slots, rooms, n_moves)
