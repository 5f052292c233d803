"""Room assignment (port of timetabling_ga_tpu/ops/rooms.py:54-341).

Greedy most-constrained-first matching: events in stable ascending
order of their suitable-room count, each taking the argmin over rooms of
the marginal-hcv-cost key `(occ + unsuit) * 2^13 + unsuit * 2^12 +
cap_rank + dead` on its slot's occupancy row. `assign_rooms` is the
wrapper of kernel K1 (csrc/assign_rooms.cu); `assign_rooms_plain` is
its plain version, a Python loop over events batched over individuals.

The parallel matcher (`--rooms-mode parallel`): `augment_rooms` runs
bounded rounds of length-1 and length-3 augmenting paths on a matching
decoupled from the rooms, every claim resolved by min-event-index
bidding on (slot, room) cells, then parks the unmatched at least
marginal cost in two bid rounds; `parallel_assign_rooms` starts it from
each event's best-fit suitable room. Both wrap kernel K9
(csrc/parallel_rooms.cu); `augment_rooms_plain` is the plain version,
batched over individuals.
"""

from __future__ import annotations

import torch

from timetabling_ga_tpu_torch import kernels, work
from timetabling_ga_tpu_torch.obs import prof as obs_prof
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


@obs_prof.scope("tt.rooms")
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


# warps of a K1, K6 breeding and K9 block on the card (csrc K1_THREADS,
# K6_THREADS and K9_THREADS over 32)
BLOCK_WARPS = 16


def assign_rooms_stage(pa) -> tuple:
    """K1's layout (csrc/assign_rooms.cu): (shared memory of one block,
    the stage mask, global scratch bytes a block). It stages each
    event's slot in matching order, and the (T, R) int32 occupancy
    where it fits (kernels.stage_regions); else the occupancy is a
    scratch row in global memory."""
    occ = 4 * pa.n_slots * pa.n_rooms
    _, (staged,) = kernels.stage_regions(4 * pa.n_events, [occ])
    return (4 * pa.n_events + (occ if staged else 0), int(staged),
            0 if staged else occ)


def assign_rooms_smem_bytes(pa) -> int:
    """Shared memory of one K1 block (assign_rooms_stage)."""
    return assign_rooms_stage(pa)[0]


def rank_row_ints(R: int) -> int:
    """One warp's rank rows of the parallel matcher (csrc/rooms_dev.cuh
    tt_rank_row_ints): five rows of 32 ceil(R / 32) ints and three words
    of ranks."""
    nw = -(-R // 32)
    return 5 * 32 * nw + 3 * nw


def parallel_rooms_ints(E: int, R: int, T: int,
                        n_warps: int = BLOCK_WARPS, su: bool = True,
                        rows: bool = True) -> int:
    """The parallel matcher's scratch ints in a block of n_warps warps
    (csrc/rooms_dev.cuh tt_parallel_rooms_ints): each event's matched
    rank, ceil(R / 32) suitability words (`su`) and live flag, the slot
    buckets, and each warp's rank rows (`rows`)."""
    return ((3 + (-(-R // 32) if su else 0)) * E + T + 1 + -(-E // 32) * T
            + (rank_row_ints(R) * n_warps if rows else 0))


def matcher_regions(E: int, R: int) -> list:
    """Bytes of the parallel matcher's regions that grow with the rooms,
    in the order its bids read them most: the block's rank rows, then
    the events' suitability words (kernels.stage_regions)."""
    return [4 * rank_row_ints(R) * BLOCK_WARPS, 4 * E * -(-R // 32)]


def parallel_rooms_stage(pa) -> tuple:
    """K9's layout (csrc/parallel_rooms.cu): (shared memory of one block,
    the stage mask, global scratch bytes a block). A block stages the
    slots, the rooms and the matcher's scratch, and of it the rank rows
    and the suitability words where they fit; the words not staged are
    read from the problem's, the rows not staged are a scratch row."""
    E, R, T = pa.n_events, pa.n_rooms, pa.n_slots
    base = 4 * (2 * E + parallel_rooms_ints(E, R, T, su=False, rows=False))
    _, (rows, su) = kernels.stage_regions(base, matcher_regions(E, R))
    smem = 4 * (2 * E + parallel_rooms_ints(E, R, T, su=su, rows=rows))
    return (smem, kernels.stage_bits((rows, su)),
            0 if rows else matcher_regions(E, R)[0])


def parallel_rooms_smem_bytes(pa) -> int:
    """Shared memory of one K9 block (parallel_rooms_stage)."""
    return parallel_rooms_stage(pa)[0]


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


def _scratch(n_rows: int, row_bytes: int, device):
    """Global scratch of n_rows rows of row_bytes (16-byte aligned), or
    None when a kernel stages everything."""
    if not row_bytes:
        return None
    return torch.empty(n_rows * (-(-row_bytes // 16) * 16),
                       dtype=torch.uint8, device=device)


def assign_rooms_kernel(pa, slots) -> torch.Tensor:
    """Kernel K1: the whole population in one launch, a block each.
    Where the (T, R) occupancy does not fit in shared memory, it is a
    scratch row in global memory a block, and kernels.resident_grid
    blocks stride over the rows: a row an individual would take P x T x
    R x 4 bytes (24 GB at pop 32,768 and R = 4,095), a row a resident
    block a few hundred MB at most. Raises ValueError, before any
    launch, where one block's state does not fit in shared memory."""
    check_packing(pa)
    smem, stage, scratch = assign_rooms_stage(pa)
    kernels.check_smem("assign_rooms", smem)
    if slots.dtype != torch.int32:
        raise TypeError("assign_rooms takes int32 slots")
    slots = slots.contiguous()
    P, E = slots.shape
    rooms = torch.empty_like(slots)
    if P == 0:
        return rooms
    grid = kernels.resident_grid(P, slots.device) if scratch else P
    buf = _scratch(grid, scratch, slots.device)
    p = kernels.ptr
    kernels.launch("assign_rooms", p(slots), p(rooms), p(pa.possible_u8),
                   p(pa.cap_rank), p(pa.dead), p(pa.live),
                   p(pa.room_order), None if buf is None else p(buf), P, E,
                   pa.n_rooms, pa.n_slots, stage, grid,
                   work=work.assign_rooms(pa, slots))
    return rooms


@obs_prof.scope("tt.rooms")
def assign_rooms(pa, slots) -> torch.Tensor:
    """Full room matching of a population: (P, E) int32 slots -> (P, E)
    int32 rooms. Kernel K1 on a CUDA tensor, the plain version on a CPU
    one."""
    if not slots.is_cuda:
        kernels.tally(work.assign_rooms(pa, slots))
        return assign_rooms_plain(pa, slots)
    return assign_rooms_kernel(pa, slots)


@obs_prof.scope("tt.rooms")
def occupancy(pa, slots, rooms) -> torch.Tensor:
    """Occupancy counts (P, T, R) int32; padded events occupy nothing."""
    P = slots.shape[0]
    R = pa.n_rooms
    idx = slots.long() * R + rooms.long()
    occ = torch.zeros((P, pa.n_slots * R), dtype=torch.int32,
                      device=slots.device)
    occ.scatter_add_(1, idx, pa.live[None, :].expand(P, -1).contiguous())
    return occ.reshape(P, pa.n_slots, R)


# key of a room no event may take in the parallel matcher's argmins
BIG = 1 << 20


def _scatter_min(cells, vals, P: int, n_cells: int, fill: int):
    grid = torch.full((P, n_cells), fill, dtype=torch.int64,
                      device=cells.device)
    return grid.scatter_reduce_(1, cells, vals, reduce="amin",
                                include_self=True)


def best_fit_rooms(pa, P: int) -> torch.Tensor:
    """parallel_assign_rooms's start (JAX rooms.py:320-322): each event's
    suitable room of least capacity rank, ignoring occupancy; room 0 when
    none suits. (P, E) int32."""
    k = torch.where(pa.possible, pa.cap_rank[None, :], BIG)
    return torch.argmin(k, 1).to(torch.int32)[None].expand(P, -1)


def augment_rooms_plain(pa, slots, rooms, n_rounds: int = 4):
    """Plain version of K9: augment_rooms (JAX rooms.py:154) of (P, E)
    slots from incoming rooms (P, E), all < R; returns (P, E) int32."""
    check_packing(pa)
    P, E = slots.shape
    R, T = pa.n_rooms, pa.n_slots
    C = R + 1
    dev = slots.device
    sl = slots.long()
    ev = torch.arange(E, device=dev)[None].expand(P, E)
    cap = pa.cap_rank.long()
    possible = pa.possible[None]                         # (1, E, R)
    ar = torch.arange(P, device=dev)[:, None]

    def cell(r):
        return sl * C + r

    def grid_of(r, vals):
        return _scatter_min(cell(r), vals, P, T * C, E)

    def rows(grid):
        """(P, E, R): each event's slot row of a (P, T*C) grid."""
        return grid.view(P, T, C)[ar, sl][..., :R]

    def argmin_has(key):
        c = torch.argmin(key, -1)
        return c, key.gather(-1, c[..., None])[..., 0] < BIG

    def resolve(choice, active):
        grid = grid_of(torch.where(active, choice, R),
                       torch.where(active, ev, E))
        return active & (grid.gather(1, cell(choice)) == ev)

    rooms = rooms.long()
    owner0 = grid_of(rooms, ev)
    matched0 = ((owner0.gather(1, cell(rooms)) == ev)
                & pa.possible[ev, rooms])
    mr = torch.where(matched0, rooms, R)
    for _ in range(n_rounds):
        # stage 1: length-1 augment, an unmatched event grabs a free room
        grid = grid_of(mr, ev)
        matched = mr < R
        k1 = torch.where(possible & (rows(grid) == E), cap, BIG)
        cand1, has1 = argmin_has(k1)
        win1 = resolve(cand1, ~matched & has1)
        mr = torch.where(win1, cand1, mr)
        # stage 2: length-3 augment, e -> r and its owner f -> free r'
        grid = grid_of(mr, ev)
        matched = mr < R
        own = rows(grid)
        fcand, can_move = argmin_has(torch.where(possible & (own == E), cap,
                                                 BIG))
        movable = torch.cat([can_move & matched,
                             torch.zeros((P, 1), dtype=torch.bool,
                                         device=dev)], 1)
        viable = (possible & (own != E)
                  & movable.gather(1, own.clamp(max=E).reshape(P, -1))
                  .view(P, E, R))
        cand2, has2 = argmin_has(torch.where(viable, cap, BIG))
        win_e = resolve(cand2, ~matched & has2)
        f = own.gather(-1, cand2[..., None])[..., 0].clamp(max=E - 1)
        fr = fcand.gather(1, f)
        grid3 = grid_of(torch.where(win_e, fr, R), torch.where(win_e, f, E))
        win_f = win_e & (grid3.gather(1, cell(fr)) == f)
        mr_ext = torch.cat([mr, torch.zeros((P, 1), dtype=mr.dtype,
                                            device=dev)], 1)
        tgt = torch.where(win_f, f, E)
        mr_ext.scatter_(1, tgt, torch.where(win_f, fr, mr_ext[:, E:]))
        mr = torch.where(win_f, cand2, mr_ext[:, :E])
    # park the unmatched at least marginal cost: two bid rounds, then the
    # stragglers take the current argmin; padded events enter parked and
    # keep their incoming room
    live = (pa.event_mask > 0.5)[None].expand(P, E)
    matched = mr < R
    occ = torch.zeros((P, T * C), dtype=torch.int64, device=dev)
    occ.scatter_add_(1, cell(mr), matched.long())
    unsuit = (~pa.possible).long()[None]

    def park_pick(occ):
        key = ((rows(occ) + unsuit) * W_COST + unsuit * W_UNSUIT + cap
               + _dead_rooms(pa).long())
        return torch.argmin(key, -1)

    parked = matched | ~live
    for _ in range(2):
        pick = park_pick(occ)
        win = resolve(pick, ~parked)
        occ.scatter_add_(1, cell(torch.where(win, pick, R)), win.long())
        mr = torch.where(win, pick, mr)
        parked = parked | win
    out = torch.where(live, torch.where(parked, mr, park_pick(occ)), rooms)
    return out.to(torch.int32)


def augment_rooms_kernel(pa, slots, rooms, n_rounds: int = 4):
    """Kernel K9: every individual in one launch, a block each (a warp
    a slot); `rooms` None starts from best_fit_rooms
    (parallel_assign_rooms). Raises ValueError, before any launch, where
    one block's state does not fit in shared memory."""
    check_packing(pa)
    smem, stage, scratch = parallel_rooms_stage(pa)
    kernels.check_smem("parallel_rooms", smem)
    ins = [slots.contiguous()] + ([] if rooms is None
                                  else [rooms.contiguous()])
    if any(x.dtype != torch.int32 for x in ins):
        raise TypeError("parallel_rooms takes int32 slots and rooms")
    P, E = slots.shape
    out = torch.empty_like(ins[0])
    if P == 0:
        return out
    # a block loops over rows when anything is read from global memory
    # (its scratch row, where the rank rows are not staged, is sized by
    # the blocks the card holds at once, as K1's)
    glob = stage != 3
    grid = kernels.resident_grid(P, slots.device) if glob else P
    buf = _scratch(grid, scratch, slots.device)
    p = kernels.ptr
    kernels.launch("parallel_rooms", p(ins[0]),
                   None if rooms is None else p(ins[1]), p(pa.cap_rank),
                   p(pa.dead), p(pa.live), p(pa.suit_rank),
                   p(pa.room_of_rank), p(out),
                   None if buf is None else p(buf), P, E, pa.n_rooms,
                   pa.n_slots, n_rounds, stage, grid,
                   work=work.parallel_rooms(pa, slots, rooms, n_rounds))
    return out


@obs_prof.scope("tt.rooms")
def augment_rooms(pa, slots, rooms, n_rounds: int = 4) -> torch.Tensor:
    """Round-limited augmenting-path improvement of the rooms (P, E) of
    slots (P, E) (JAX rooms.py:154). Kernel K9 on CUDA tensors, the
    plain version on CPU ones."""
    if not slots.is_cuda:
        kernels.tally(work.parallel_rooms(pa, slots, rooms, n_rounds))
        return augment_rooms_plain(pa, slots, rooms, n_rounds)
    return augment_rooms_kernel(pa, slots, rooms, n_rounds)


@obs_prof.scope("tt.rooms")
def parallel_assign_rooms(pa, slots, n_rounds: int = 4) -> torch.Tensor:
    """O(1)-depth room assignment of a population (JAX rooms.py:304;
    populations (P, E), as JAX batch_parallel_assign_rooms takes them):
    best-fit rooms, then augment_rooms. Kernel K9 on CUDA tensors, the
    plain version on CPU ones."""
    if not slots.is_cuda:
        kernels.tally(work.parallel_rooms(pa, slots, None, n_rounds))
        return augment_rooms_plain(
            pa, slots, best_fit_rooms(pa, slots.shape[0]), n_rounds)
    return augment_rooms_kernel(pa, slots, None, n_rounds)

