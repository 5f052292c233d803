"""Population-level GA operators (port of timetabling_ga_tpu/ops/ga.py).

Tournament-5 selection by (penalty, scv), uniform crossover with a full
greedy room rematch (kernel K1), one random move with p_mutation, the
sweep local search on every child, full evaluation (kernel K2) and
(mu+lambda) truncation in (penalty, scv) order.

Populations may hold several islands as consecutive equal row blocks
(`groups`): selection, truncation and the converge rule act within each
block, as the JAX package's vmap over local islands does. Randomness
comes in as tensors (`BreedDraws` and a per-pass sweep draw function).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from timetabling_ga_tpu_torch.ops import fitness
from timetabling_ga_tpu_torch.ops.moves import (
    MoveDraws, make_move_draws, random_move)
from timetabling_ga_tpu_torch.ops.rooms import assign_rooms
from timetabling_ga_tpu_torch.ops.sweep import (
    make_sweep_draws, sweep_local_search, sweep_shape)


@dataclasses.dataclass(frozen=True)
class GAConfig:
    """Breeding hyper-parameters: the JAX GAConfig's fields for the scan
    room matcher and the sweep local search, the only ones ported."""

    pop_size: int = 10
    tournament_k: int = 5
    p_crossover: float = 0.8
    p_mutation: float = 0.5
    p1: float = 1.0
    p2: float = 1.0
    p3: float = 0.0
    ls_sweeps: int = 1
    ls_swap_block: int = 8
    ls_block_events: int = 1
    ls_sideways: float = 0.0
    ls_converge: bool = False
    ls_hot_k: int = 0
    init_sweeps: int = 0


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


def make_breed_draws(gens, pop: int, n_events: int, n_slots: int,
                     cfg: GAConfig, device) -> BreedDraws:
    """BreedDraws for len(gens) islands of `pop` children each."""
    parts = []
    for g in gens:
        parts.append((
            torch.randint(0, pop, (pop, cfg.tournament_k), generator=g,
                          device=device),
            torch.randint(0, pop, (pop, cfg.tournament_k), generator=g,
                          device=device),
            torch.rand((pop, n_events), generator=g, device=device) < 0.5,
            torch.rand((pop,), generator=g, device=device)
            < cfg.p_crossover,
            torch.rand((pop,), generator=g, device=device)
            < cfg.p_mutation))
    move = make_move_draws(gens, pop, n_events, n_slots, cfg.p1, cfg.p2,
                           cfg.p3, device)
    return BreedDraws(*(torch.cat([p[i] for p in parts]) for i in range(5)),
                      move=move)


def sweep_draws_fn(gens, rows_per_gen: int, pa, cfg: GAConfig):
    """Per-pass sweep draw function for the LS of a population."""
    shape = sweep_shape(pa.n_events, pa.n_slots, cfg.ls_swap_block,
                        cfg.ls_block_events, cfg.ls_hot_k, cfg.p3)

    def draws(_i):
        return make_sweep_draws(gens, rows_per_gen, shape, pa.n_events,
                                cfg.ls_sideways, pa.device)
    return draws


def _group_view(x, groups):
    return x.reshape((groups, -1) + tuple(x.shape[1:]))


def evaluate(pa, slots, rooms, groups: int = 1) -> PopState:
    """Evaluate (P, E) genotypes (K2) and sort each island best-first
    by (penalty, scv)."""
    penalty, hcv, scv = fitness.batch_penalty(pa, slots, rooms)
    return sort_islands(PopState(slots, rooms, penalty, hcv, scv), groups)


def sort_islands(state: PopState, groups: int = 1,
                 keep: int = None) -> PopState:
    """Sort each island's rows by (penalty, scv) and keep the first
    `keep` (default all) — lex_order per island."""
    order = fitness.lex_order(_group_view(state.penalty, groups),
                              _group_view(state.scv, groups))
    if keep is not None:
        order = order[:, :keep]
    base = (torch.arange(groups, device=order.device)[:, None]
            * _group_view(state.penalty, groups).shape[1])
    flat = (order + base).reshape(-1)
    return PopState(*(x[flat] for x in state))


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


def make_children(pa, draws: BreedDraws, state: PopState, cfg: GAConfig,
                  groups: int = 1):
    """Breed one child per parent row: 2x tournament -> crossover(p) ->
    mutation(p). Returns the children's (slots, rooms)."""
    P = state.slots.shape[0]
    pop = P // groups
    base = (torch.arange(P, device=state.slots.device) // pop * pop)[:, None]
    ia = tournament(draws.ta + base, state.penalty, state.scv)
    ib = tournament(draws.tb + base, state.penalty, state.scv)
    s_a, r_a = state.slots[ia], state.rooms[ia]
    s_b = state.slots[ib]
    x_slots = torch.where(draws.mask, s_a, s_b)
    x_rooms = assign_rooms(pa, x_slots)
    do_x = draws.do_x[:, None]
    slots = torch.where(do_x, x_slots, s_a)
    rooms = torch.where(do_x, x_rooms, r_a)
    m_slots, m_rooms = random_move(pa, draws.move, slots, rooms)
    do_m = draws.do_m[:, None]
    slots = torch.where(do_m, m_slots, slots)
    rooms = torch.where(do_m, m_rooms, rooms)
    return slots, rooms


def generation(pa, draws: BreedDraws, sweep_draws, state: PopState,
               cfg: GAConfig, groups: int = 1) -> PopState:
    """One generation over `groups` islands of cfg.pop_size rows: breed
    every child, sweep-LS them, evaluate, and keep each island's best
    pop_size of parents + children in (penalty, scv) order."""
    ch_slots, ch_rooms = make_children(pa, draws, state, cfg, groups)
    if cfg.ls_sweeps > 0:
        ch_slots, ch_rooms = sweep_local_search(
            pa, sweep_draws, ch_slots, ch_rooms, n_sweeps=cfg.ls_sweeps,
            swap_block=cfg.ls_swap_block, converge=cfg.ls_converge,
            block_events=cfg.ls_block_events, sideways=cfg.ls_sideways,
            hot_k=cfg.ls_hot_k, p3=cfg.p3, groups=groups)
    c_pen, c_hcv, c_scv = fitness.batch_penalty(pa, ch_slots, ch_rooms)
    children = PopState(ch_slots, ch_rooms, c_pen, c_hcv, c_scv)
    both = PopState(*(
        torch.cat([_group_view(a, groups), _group_view(b, groups)], 1)
        .reshape((-1,) + tuple(a.shape[1:]))
        for a, b in zip(state, children)))
    return sort_islands(both, groups, keep=cfg.pop_size)
