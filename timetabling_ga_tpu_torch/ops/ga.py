"""Population-level GA operators (port of timetabling_ga_tpu/ops/ga.py).

Tournament-5 selection by (penalty, scv), uniform crossover with a full
greedy room rematch, one random move with p_mutation — all of a
generation's breeding in one launch of kernel K6 (csrc/breed.cu,
`make_children`) — the local search on every child (the sweep, K5, or
the random-candidate search, K8 or its full-evaluation twin K12), full
evaluation (K6's epilogue scores the children, K8's the delta search's
rows, K12 carries its accepted evaluations, K2 scores the sweep's) and (mu+lambda) truncation in (penalty, scv) order
(kernel K7, csrc/survivors.cu, `survivors`). `make_children_plain` and
`survivors_plain` are the plain versions.

Under `multi_objective` (--nsga2) the parents are drawn by NSGA-II's
crowded tournament on ranks and crowding computed once a generation
(kernel K11's nsga_rank) and the replacement is K11's nsga_survivors;
under `rooms_mode="parallel"` the crossover rematch is the parallel
matcher (ops/rooms.py parallel_assign_rooms), inside K6 on the card.

Under the quality telemetry (`--quality`) a generation also adds its
crossover and mutation attempts and wins and the sweep's accepted moves
to an (L, N_OPS) int32 accumulator on the card (kernel K14's quality_ops,
csrc/quality.cu; JAX ga.py:221-302 with_quality): K6 writes each child's
base parent, K5 each row's accepted moves. Nothing new is drawn, so the
trajectory is the same with it on or off.

Populations may hold several islands as consecutive equal row blocks
(`groups`): selection, truncation and the converge rule act within each
block, as the JAX package's vmap over local islands does. Randomness
comes in as tensors (`BreedDraws` and a per-call LS draw function).

On the serve path each island is a job's lane with a problem of its own
(JAX parallel/islands.py:1115 make_lane_runner): `make_children`, the
random-candidate search and `generation` then take a
`problem.LaneProblems` in place of the ProblemArrays, one island of
`pop` rows a lane. K6 and K8's chain read each lane's problem from its
lane table; the plain versions loop over the lanes, each on its own
ProblemArrays.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from timetabling_ga_tpu_torch import kernels, work
from timetabling_ga_tpu_torch.obs import prof as obs_prof
from timetabling_ga_tpu_torch.obs.quality import N_OPS
from timetabling_ga_tpu_torch.ops import fitness, nsga
from timetabling_ga_tpu_torch.ops.delta import (
    LSRows, batch_local_search_delta, init_rows, make_ls_draws)
from timetabling_ga_tpu_torch.ops.local_search import batch_local_search
from timetabling_ga_tpu_torch.ops.moves import (
    MoveDraws, make_move_draws, random_move_plain)
from timetabling_ga_tpu_torch.ops.rooms import (
    assign_rooms, assign_rooms_plain, augment_rooms_plain, best_fit_rooms,
    check_packing)
from timetabling_ga_tpu_torch.ops.sweep import (
    make_sweep_draws, sweep_local_search, sweep_shape)
from timetabling_ga_tpu_torch.problem import LaneProblems


@dataclasses.dataclass(frozen=True)
class GAConfig:
    """Breeding hyper-parameters: the JAX GAConfig's fields, with its
    defaults."""

    pop_size: int = 10
    tournament_k: int = 5
    p_crossover: float = 0.8
    p_mutation: float = 0.5
    p1: float = 1.0
    p2: float = 1.0
    p3: float = 0.0
    ls_steps: int = 0             # random LS rounds per child; 0 = off
    ls_candidates: int = 8        # candidates per random LS round
    ls_delta: bool = True         # delta-scored (K8) vs full re-evaluation
    ls_mode: str = "random"       # "random" K-candidate | "sweep"
    ls_sweeps: int = 1
    ls_swap_block: int = 8
    ls_block_events: int = 1
    ls_sideways: float = 0.0
    ls_converge: bool = False
    ls_hot_k: int = 0
    init_sweeps: int = 0
    rooms_mode: str = "scan"      # crossover rematch: "scan" | "parallel"
    multi_objective: bool = False  # NSGA-II (hcv, scv) selection


class PopState(NamedTuple):
    """A population sorted best-first by (penalty, scv) per island."""

    slots: torch.Tensor    # (P, E) int32
    rooms: torch.Tensor    # (P, E) int32
    penalty: torch.Tensor  # (P,)   int32
    hcv: torch.Tensor      # (P,)   int32
    scv: torch.Tensor      # (P,)   int32


class BreedDraws(NamedTuple):
    """The draws of one generation's breeding, one row per child."""

    ta: torch.Tensor       # (P, k) int  tournament A draws (island rows)
    tb: torch.Tensor       # (P, k) int  tournament B draws
    mask: torch.Tensor     # (P, E) bool crossover: True takes parent A
    do_x: torch.Tensor     # (P,) bool   crossover applied
    do_m: torch.Tensor     # (P,) bool   mutation applied
    move: MoveDraws        # the mutation move


def _cat(parts, dim=0):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def make_breed_draws(gens, pop: int, n_events: int, n_slots: int,
                     cfg: GAConfig, device) -> BreedDraws:
    """BreedDraws for len(gens) islands of `pop` children each."""
    parts = []
    for g in gens:
        parts.append((
            torch.randint(0, pop, (pop, cfg.tournament_k), generator=g,
                          device=device, dtype=torch.int32),
            torch.randint(0, pop, (pop, cfg.tournament_k), generator=g,
                          device=device, dtype=torch.int32),
            torch.rand((pop, n_events), generator=g, device=device) < 0.5,
            torch.rand((pop,), generator=g, device=device)
            < cfg.p_crossover,
            torch.rand((pop,), generator=g, device=device)
            < cfg.p_mutation))
    move = make_move_draws(gens, pop, n_events, n_slots, cfg.p1, cfg.p2,
                           cfg.p3, device)
    return BreedDraws(*(_cat([p[i] for p in parts]) for i in range(5)),
                      move=move)


def sweep_draws_fn(gens, rows_per_gen: int, pa, cfg: GAConfig):
    """Per-pass sweep draw function for the LS of a population."""
    shape = sweep_shape(pa.n_events, pa.n_slots, cfg.ls_swap_block,
                        cfg.ls_block_events, cfg.ls_hot_k, cfg.p3)

    def draws(_i, live=None):
        return make_sweep_draws(gens, rows_per_gen, shape, pa.n_events,
                                cfg.ls_sideways, pa.device,
                                live if live is not None
                                and len(live) == len(gens) else None)
    draws.takes_live = True
    return draws


def ls_draws_fn(gens, rows_per_gen: int, pa, cfg: GAConfig):
    """The draw function of a generation's local search: the sweep's
    per-pass draws, or, in random mode, `draws(0)` gives the LSDraws of
    the whole search."""
    if cfg.ls_mode == "sweep":
        return sweep_draws_fn(gens, rows_per_gen, pa, cfg)

    def draws(_i):
        return make_ls_draws(gens, rows_per_gen, cfg.ls_steps,
                             cfg.ls_candidates, pa.n_events, pa.n_slots,
                             cfg.p1, cfg.p2, cfg.p3, pa.device)
    return draws


def _group_view(x, groups):
    return x.reshape((groups, -1) + tuple(x.shape[1:]))


def evaluate(pa, slots, rooms, groups: int = 1) -> PopState:
    """Evaluate (P, E) genotypes (K2) and sort each island best-first
    by (penalty, scv)."""
    penalty, hcv, scv = fitness.batch_penalty(pa, slots, rooms)
    return survivors(PopState(slots, rooms, penalty, hcv, scv),
                     groups=groups)


def survivors_plain(a: PopState, b: Optional[PopState] = None,
                    groups: int = 1, keep: int = None) -> PopState:
    """Plain version of K7: each island's rows of `a` then its rows of
    `b` (when given) sorted by (penalty, scv) — lex_order, ties to the
    earlier row — and the first `keep` (default all) kept."""
    if b is not None:
        a = PopState(*(
            torch.cat([_group_view(x, groups), _group_view(y, groups)], 1)
            .reshape((-1,) + tuple(x.shape[1:])) for x, y in zip(a, b)))
    order = fitness.lex_order(_group_view(a.penalty, groups),
                              _group_view(a.scv, groups))
    if keep is not None:
        order = order[:, :keep]
    base = (torch.arange(groups, device=order.device)[:, None]
            * _group_view(a.penalty, groups).shape[1])
    flat = (order + base).reshape(-1)
    return PopState(*(x[flat] for x in a))


def survivors_kernel(a: PopState, b: Optional[PopState] = None,
                     groups: int = 1, keep: int = None) -> PopState:
    """Kernel K7: every island's survivors in one launch."""
    na = a.slots.shape[0] // groups
    nb = 0 if b is None else b.slots.shape[0] // groups
    keep = na + nb if keep is None else keep
    E = a.slots.shape[1]
    ins = [x.contiguous() for x in a]
    if any(x.dtype != torch.int32 for x in ins):
        raise TypeError("survivors takes int32 populations")
    ins_b = [None] * 5 if b is None else [x.contiguous() for x in b]
    out = PopState(
        torch.empty((groups * keep, E), dtype=torch.int32,
                    device=a.slots.device),
        torch.empty((groups * keep, E), dtype=torch.int32,
                    device=a.slots.device),
        *(torch.empty(groups * keep, dtype=torch.int32,
                      device=a.slots.device) for _ in range(3)))
    p = kernels.ptr
    kernels.launch("survivors", *(p(x) for x in ins),
                   *(None if x is None else p(x) for x in ins_b),
                   *(p(x) for x in out), groups, na, nb, keep, E,
                   work=work.survivors(groups, na, nb, keep, E))
    return out


def survivors(a: PopState, b: Optional[PopState] = None, groups: int = 1,
              keep: int = None) -> PopState:
    """Each island's best `keep` (default all) of its rows of `a` and
    then of `b` in (penalty, scv) order, ties to the earlier row — the
    (mu+lambda) truncation of JAX ga.py:276-293 with a = parents and b =
    children, or with b = None the sort of `evaluate`. Kernel K7 on CUDA
    tensors, the plain version on CPU ones."""
    if not a.slots.is_cuda:
        na = a.slots.shape[0] // groups
        nb = 0 if b is None else b.slots.shape[0] // groups
        kernels.tally(work.survivors(groups, na, nb,
                                     na + nb if keep is None else keep,
                                     a.slots.shape[1]))
        return survivors_plain(a, b, groups, keep)
    return survivors_kernel(a, b, groups, keep)


@obs_prof.scope("tt.ga")
def init_population(pa, slots0, cfg: GAConfig = None, draws_fn=None,
                    groups: int = 1) -> PopState:
    """Initial population from random slots `slots0` (P, E): greedy room
    matching (K1), then, when cfg.init_sweeps > 0, a converge sweep
    polish with `draws_fn` (RandomInitialSolution + the reference's
    initial localSearch, ga.cpp:429-434)."""
    slots = slots0.to(torch.int32)
    rooms = assign_rooms(pa, slots)
    if cfg is not None and cfg.init_sweeps > 0:
        slots, rooms = sweep_local_search(
            pa, draws_fn, slots, rooms, n_sweeps=cfg.init_sweeps,
            swap_block=cfg.ls_swap_block, converge=True,
            block_events=cfg.ls_block_events, sideways=cfg.ls_sideways,
            hot_k=cfg.ls_hot_k, p3=cfg.p3, groups=groups)
    return evaluate(pa, slots, rooms, groups)


def tournament(draws, penalty, scv) -> torch.Tensor:
    """Tournament selection per child: draws (C, k) row indices into the
    parents -> (C,) the index of the best draw by (penalty, scv), the
    earliest draw on a full tie (jnp.lexsort(...)[0])."""
    order = fitness.lex_order(penalty[draws], scv[draws])
    return torch.gather(draws, 1, order[:, :1])[:, 0]


# rounds of the parallel matcher on the breeding path (JAX
# parallel_assign_rooms's default, ga.py:204)
PARALLEL_ROUNDS = 4


def make_children_plain(pa, draws: BreedDraws, state: PopState,
                        cfg: GAConfig, groups: int = 1, mo_stats=None,
                        with_parent: bool = False):
    """Plain version of K6: breed one child per parent row, 2x tournament
    -> crossover(p) -> mutation(p). `mo_stats` is None (tournaments by
    (penalty, scv)) or the parents' (ranks, crowding) for the crowded
    tournament. Returns the children's rows scored (LSRows: slots,
    rooms and batch_penalty_plain's terms), and with with_parent also
    each child's base parent (tournament A's winner, a row of `state`)
    as (P,) int32."""
    P = state.slots.shape[0]
    pop = P // groups
    base = (torch.arange(P, device=state.slots.device) // pop * pop)[:, None]
    if mo_stats is None:
        ia = tournament(draws.ta.long() + base, state.penalty, state.scv)
        ib = tournament(draws.tb.long() + base, state.penalty, state.scv)
    else:
        ia = nsga.crowded_tournament(draws.ta.long() + base, *mo_stats)
        ib = nsga.crowded_tournament(draws.tb.long() + base, *mo_stats)
    s_a, r_a = state.slots[ia], state.rooms[ia]
    s_b = state.slots[ib]
    x_slots = torch.where(draws.mask, s_a, s_b)
    if cfg.rooms_mode == "parallel":
        x_rooms = augment_rooms_plain(pa, x_slots, best_fit_rooms(pa, P),
                                      PARALLEL_ROUNDS)
    else:
        x_rooms = assign_rooms_plain(pa, x_slots)
    do_x = draws.do_x[:, None]
    slots = torch.where(do_x, x_slots, s_a)
    rooms = torch.where(do_x, x_rooms, r_a)
    m_slots, m_rooms = random_move_plain(pa, draws.move, slots, rooms)
    do_m = draws.do_m[:, None]
    slots = torch.where(do_m, m_slots, slots)
    rooms = torch.where(do_m, m_rooms, rooms)
    rows = LSRows(slots, rooms, *fitness.batch_penalty_plain(pa, slots,
                                                              rooms))
    if with_parent:
        return rows, ia.to(torch.int32)
    return rows


def _lane_rows(x, lane: int, pop: int):
    return x[lane * pop:(lane + 1) * pop]


def _lane_draws(draws: BreedDraws, lane: int, pop: int) -> BreedDraws:
    return BreedDraws(*(_lane_rows(x, lane, pop) for x in draws[:5]),
                      move=MoveDraws(*(_lane_rows(x, lane, pop)
                                       for x in draws.move)))


def make_children_lanes_plain(lp: LaneProblems, draws: BreedDraws,
                              state: PopState, cfg: GAConfig,
                              mo_stats=None, with_parent: bool = False):
    """Plain version of K6 with a lane table: each lane's children by
    make_children_plain on its rows and its own ProblemArrays."""
    pop = state.slots.shape[0] // len(lp)
    parts = []
    for lane, pa in enumerate(lp.pas):
        mo = (None if mo_stats is None else
              tuple(_lane_rows(x, lane, pop) for x in mo_stats))
        out = make_children_plain(
            pa, _lane_draws(draws, lane, pop),
            PopState(*(_lane_rows(x, lane, pop) for x in state)), cfg, 1,
            mo, with_parent)
        if with_parent:
            rows, parent = out
            parts.append((*rows, parent + lane * pop))
        else:
            parts.append(out)
    out = [torch.cat(x) for x in zip(*parts)]
    rows = LSRows(*out[:5])
    return (rows, out[5]) if with_parent else rows


def make_children_kernel(pa, draws: BreedDraws, state: PopState,
                         groups: int = 1, mo_stats=None,
                         rooms_mode: str = "scan",
                         with_parent: bool = False):
    """Kernel K6: every child in one launch, a block a child, which also
    scores it (the (3, P) penalty terms K2 would give) and, with
    with_parent, writes its base parent. With `pa` a LaneProblems the
    islands are its lanes (groups is len(pa)) and each block reads its
    lane's problem from the lane table (launches count as
    breed_lanes)."""
    lanes = None
    n_rounds = PARALLEL_ROUNDS if rooms_mode == "parallel" else -1
    w = work.breed(pa, state, draws, n_rounds)
    if isinstance(pa, LaneProblems):
        if groups != len(pa):
            raise ValueError(f"make_children: {groups} islands for "
                             f"{len(pa)} lanes")
        lanes, pa = pa.table, pa.first
    check_packing(pa)
    P, E = state.slots.shape
    ins = [x.contiguous() for x in (state.slots, state.rooms,
                                    state.penalty, state.scv)]
    if any(x.dtype != torch.int32 for x in ins):
        raise TypeError("make_children takes an int32 population")
    if draws.move.u.dtype != torch.float32:
        raise TypeError("make_children takes float32 move uniforms")
    i32 = torch.int32
    dr = [draws.ta.to(i32).contiguous(), draws.tb.to(i32).contiguous(),
          draws.mask.contiguous().view(torch.uint8),
          draws.do_x.contiguous().view(torch.uint8),
          draws.do_m.contiguous().view(torch.uint8),
          draws.move.mtype.to(i32).contiguous(),
          draws.move.u.contiguous(), draws.move.t.to(i32).contiguous()]
    mo = [None, None]
    if mo_stats is not None:
        mo = [mo_stats[0].contiguous(), mo_stats[1].contiguous()]
        if mo[0].dtype != torch.int32 or mo[1].dtype != torch.float32:
            raise TypeError("make_children takes int32 ranks and float32 "
                            "crowding")
    out = [torch.empty_like(ins[0]), torch.empty_like(ins[1])]
    ev = torch.empty((3, P), dtype=torch.int32, device=ins[0].device)
    parent = (torch.empty(P, dtype=torch.int32, device=ins[0].device)
              if with_parent else None)
    rows = LSRows(*out, ev[0], ev[1], ev[2])
    if P == 0:
        return (rows, parent) if with_parent else rows
    p = kernels.ptr
    kernels.launch("breed" if lanes is None else "breed_lanes",
                   *(p(x) for x in ins + dr), p(pa.possible_u8),
                   p(pa.cap_rank), p(pa.dead), p(pa.live),
                   p(pa.room_order), p(pa.suit_rank), p(pa.room_of_rank),
                   *(None if x is None else p(x) for x in mo),
                   p(pa.student_count), p(pa.conflict_bits), p(pa.stu_ptr),
                   p(pa.stu_ev), p(pa.anchor_slots), p(pa.anchor_w),
                   None if lanes is None else p(lanes),
                   p(out[0]), p(out[1]), p(ev),
                   None if parent is None else p(parent), P, P // groups,
                   draws.ta.shape[1], E, pa.n_rooms, pa.n_slots, n_rounds,
                   pa.n_students, pa.slots_per_day, pa.conflict_bits.shape[1],
                   pa.conflict_diag, work=w)
    return (rows, parent) if with_parent else rows


@obs_prof.scope("tt.ga")
def make_children(pa, draws: BreedDraws, state: PopState, cfg: GAConfig,
                  groups: int = 1, mo_stats=None, with_parent: bool = False):
    """Breed one child per parent row (each island's children from its
    own parents); returns the children's rows with their penalty terms
    (LSRows), and with with_parent also each child's base parent row
    ((P,) int32). `pa` is a ProblemArrays, or a LaneProblems whose lanes
    are the islands. Kernel K6 on CUDA tensors, which scores each child
    in its epilogue, the plain version on CPU ones."""
    if not state.slots.is_cuda:
        kernels.tally(work.breed(
            pa, state, draws,
            PARALLEL_ROUNDS if cfg.rooms_mode == "parallel" else -1))
        if isinstance(pa, LaneProblems):
            return make_children_lanes_plain(pa, draws, state, cfg,
                                             mo_stats, with_parent)
        return make_children_plain(pa, draws, state, cfg, groups, mo_stats,
                                   with_parent)
    return make_children_kernel(pa, draws, state, groups, mo_stats,
                                cfg.rooms_mode, with_parent)


def local_search(pa, ls_draws, children: LSRows, cfg: GAConfig,
                 groups: int = 1, return_ops: bool = False):
    """The local search of the scored children as JAX ga.py:249-274
    selects it: the sweep when ls_mode is "sweep", else ls_steps rounds
    of the random-candidate search (delta-scored, or by full
    re-evaluation when ls_delta is False), else none. Each search starts
    from the children's scores; returns their rows after it, scored: K8
    scores the delta search's rows in its epilogue, K12 carries the full
    evaluations of the rows it accepts, K2 scores the sweep's. With
    return_ops, returns (rows, ops): the sweep's (P, 3) accepted-move
    counts a row, or None after the other searches (JAX's zeros)."""
    slots, rooms = children.slots, children.rooms
    ops = None
    if isinstance(pa, LaneProblems) and (cfg.ls_mode == "sweep"
                                         or not cfg.ls_delta):
        raise ValueError("lanes take the delta-scored random-candidate "
                         "search only (the serve generation's)")
    if cfg.ls_mode == "sweep" and cfg.ls_sweeps > 0:
        slots, rooms, *ops = sweep_local_search(
            pa, ls_draws, slots, rooms, n_sweeps=cfg.ls_sweeps,
            swap_block=cfg.ls_swap_block, converge=cfg.ls_converge,
            block_events=cfg.ls_block_events, sideways=cfg.ls_sideways,
            hot_k=cfg.ls_hot_k, p3=cfg.p3, groups=groups,
            scores=children[2:], return_ops=return_ops)
        rows = init_rows(pa, slots, rooms)
        ops = ops[0] if return_ops else None
    elif cfg.ls_mode != "sweep" and cfg.ls_steps > 0:
        search = (batch_local_search_delta if cfg.ls_delta
                  else batch_local_search)
        rows = search(pa, ls_draws(0), slots, rooms, children[2:])
    else:
        rows = children
    return (rows, ops) if return_ops else rows


def quality_ops_plain(do_x, do_m, parent, child_pen, parent_pen, sweep_ops,
                      acc, L: int) -> torch.Tensor:
    """Plain version of K14's quality_ops entry (see `quality_ops`)."""
    win = child_pen < parent_pen[parent.long()]
    x, m = do_x.to(torch.bool), do_m.to(torch.bool)
    n = torch.stack([x, x & win, m, m & win], 1).to(torch.int32)
    if sweep_ops is None:
        sweep_ops = torch.zeros((n.shape[0], 3), dtype=torch.int32,
                                device=n.device)
    n = torch.cat([n, sweep_ops.to(torch.int32)], 1)
    acc += n.reshape(L, -1, N_OPS).sum(1, dtype=torch.int32)
    return acc


def quality_ops_kernel(do_x, do_m, parent, child_pen, parent_pen,
                       sweep_ops, acc, L: int) -> torch.Tensor:
    """K14's quality_ops entry: a block an island adds into `acc`."""
    i32 = torch.int32
    ins = [parent.contiguous(), child_pen.contiguous(),
           parent_pen.contiguous()]
    if sweep_ops is not None:
        ins.append(sweep_ops.contiguous())
    if (any(x.dtype != i32 for x in ins) or acc.dtype != i32
            or not acc.is_contiguous() or tuple(acc.shape) != (L, N_OPS)):
        raise TypeError("quality_ops takes int32 rows and a contiguous "
                        f"(L, {N_OPS}) int32 accumulator")
    p = kernels.ptr
    kernels.launch("quality_ops",
                   p(do_x.contiguous().view(torch.uint8)),
                   p(do_m.contiguous().view(torch.uint8)),
                   *(p(x) for x in ins[:3]),
                   p(ins[3]) if sweep_ops is not None else None, p(acc),
                   L, do_x.shape[0] // L,
                   work=work.quality_ops(L, do_x.shape[0] // L))
    return acc


def quality_ops(do_x, do_m, parent, child_pen, parent_pen, sweep_ops, acc,
                L: int) -> torch.Tensor:
    """Add one generation's operator counters to the (L, N_OPS) int32
    accumulator `acc`, in place, per island of L equal row blocks:
    crossover attempts and wins, mutation attempts and wins — a win is a
    child whose penalty after its local search is below its base
    parent's (`parent`, rows of the parents' `parent_pen`), credited to
    each operator that touched it — then the rows' accepted Move1, Move2
    and Move3 counts (`sweep_ops` (P, 3), or None: zeros). JAX
    ga.py:294-302. Kernel K14 on CUDA tensors, the plain version on CPU
    ones. Returns acc."""
    if not acc.is_cuda:
        kernels.tally(work.quality_ops(L, do_x.shape[0] // L))
        return quality_ops_plain(do_x, do_m, parent, child_pen, parent_pen,
                                 sweep_ops, acc, L)
    return quality_ops_kernel(do_x, do_m, parent, child_pen, parent_pen,
                              sweep_ops, acc, L)


@obs_prof.scope("tt.ga")
def generation(pa, draws: BreedDraws, ls_draws, state: PopState,
               cfg: GAConfig, groups: int = 1, qacc=None) -> PopState:
    """One generation over `groups` islands of cfg.pop_size rows: breed
    and score every child, local-search them, evaluate, and keep each
    island's best pop_size of parents + children in (penalty, scv) order
    — or, under multi_objective, NSGA-II's survivors, penalty-sorted (JAX
    ga.py:221-293). `ls_draws` is the local search's draw function
    (`ls_draws_fn`). On the card the children's evaluations come from K6
    and, after the random-candidate search, K8 or K12; K2 runs only
    after the sweep. `qacc`, an (L, N_OPS) int32 tensor, takes the
    generation's quality counters (`quality_ops`, JAX with_quality)."""
    mo_stats = None
    if cfg.multi_objective:
        mo_stats = nsga.rank_crowd(state.hcv, state.scv, groups)
    if qacc is None:
        children = make_children(pa, draws, state, cfg, groups, mo_stats)
        children = PopState(*local_search(pa, ls_draws, children, cfg,
                                          groups))
    else:
        children, parent = make_children(pa, draws, state, cfg, groups,
                                         mo_stats, with_parent=True)
        rows, sweep_ops = local_search(pa, ls_draws, children, cfg, groups,
                                       return_ops=True)
        children = PopState(*rows)
        quality_ops(draws.do_x, draws.do_m, parent, children.penalty,
                    state.penalty, sweep_ops, qacc, groups)
    if cfg.multi_objective:
        return nsga.survivors(state, children, groups, keep=cfg.pop_size)
    return survivors(state, children, groups, keep=cfg.pop_size)
