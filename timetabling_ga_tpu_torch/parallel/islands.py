"""Island model on one GPU (port of the single-device part of
timetabling_ga_tpu/parallel/islands.py:166-397, 702-884).

All L islands live on one card as consecutive row blocks of one
population `(L * pop, E)`; the JAX package's local-island vmap becomes
that block structure (ops/ga.py `groups`). Migration is the ring of the
JAX `_migrate` done with rolls over the island axis: no collective is
needed on one card. Each island draws from its own torch.Generator.
"""

from __future__ import annotations

import torch

from timetabling_ga_tpu_torch.ops import ga
from timetabling_ga_tpu_torch.ops.moves import make_move_draws, random_move
from timetabling_ga_tpu_torch.ops.sweep import sweep_local_search


def _blocks(x, L):
    return x.reshape((L, -1) + tuple(x.shape[1:]))


def init_island_population(pa, gens, pop_size: int) -> ga.PopState:
    """Every island's population from its own generator: uniform random
    slots, greedy room matching (K1), evaluation (K2), sorted per island.
    The initial polish runs after, in budgeted chunks (`polish`)."""
    slots0 = torch.cat([
        torch.randint(0, pa.n_slots, (pop_size, pa.n_events), generator=g,
                      device=pa.device, dtype=torch.int32) for g in gens])
    return ga.init_population(pa, slots0, groups=len(gens))


def migrate(state: ga.PopState, L: int) -> ga.PopState:
    """Bidirectional ring migration of one migrant each way: island l's
    worst row receives island l-1's best, its second-worst island l+1's
    second-best, then each island re-sorts (ga.cpp:522-535). With one
    island the ring closes on itself, as the JAX ring over one device
    does. Populations under 3 skip migration: a victim row would alias
    the best (islands.py:247-251)."""
    pop = state.penalty.shape[0] // L
    if pop < 3:
        return state
    out = []
    for x in state:
        b = _blocks(x, L).clone()
        best = b[:, 0].clone()
        second = b[:, 1].clone()
        b[:, -1] = torch.roll(best, 1, dims=0)
        b[:, -2] = torch.roll(second, -1, dims=0)
        out.append(b.reshape(x.shape))
    return ga.sort_islands(ga.PopState(*out), L)


def run_epochs(pa, gens, state: ga.PopState, cfg: ga.GAConfig,
               n_epochs: int, gens_per_epoch: int):
    """`n_epochs` x `gens_per_epoch` generations on every island, a ring
    migration after each epoch. Returns (state, trace) with trace
    (L, n_epochs * gens_per_epoch, 2) int32 on the device: each
    generation's per-island best (hcv, scv)."""
    L = len(gens)
    pop = cfg.pop_size
    sweep_fn = ga.sweep_draws_fn(gens, pop, pa, cfg)
    trace = []
    for _ in range(n_epochs):
        for _ in range(gens_per_epoch):
            draws = ga.make_breed_draws(gens, pop, pa.n_events, pa.n_slots,
                                        cfg, pa.device)
            state = ga.generation(pa, draws, sweep_fn, state, cfg, groups=L)
            trace.append(torch.stack([_blocks(state.hcv, L)[:, 0],
                                      _blocks(state.scv, L)[:, 0]], -1))
        state = migrate(state, L)
    return state, torch.stack(trace, 1)


def polish(pa, gens, state: ga.PopState, cfg: ga.GAConfig, n_sweeps: int):
    """Up to `n_sweeps` converge sweep passes over the whole population
    (one convergence group, as the JAX polish runner sweeps its flat
    shard), then re-evaluation sorted per island. Returns (state, stats)
    with stats (3, L * pop) int32 = penalty, hcv, scv."""
    L = len(gens)
    pop = state.penalty.shape[0] // L
    slots, rooms = sweep_local_search(
        pa, ga.sweep_draws_fn(gens, pop, pa, cfg), state.slots, state.rooms,
        n_sweeps=n_sweeps, swap_block=cfg.ls_swap_block, converge=True,
        block_events=cfg.ls_block_events, sideways=cfg.ls_sideways,
        hot_k=cfg.ls_hot_k, p3=cfg.p3)
    st = ga.evaluate(pa, slots, rooms, groups=L)
    return st, torch.stack([st.penalty, st.hcv, st.scv])


KICK_MAX_MOVES = 16


def kick(pa, gens, state: ga.PopState, cfg: ga.GAConfig,
         n_moves: int) -> ga.PopState:
    """Reseed each island's worst half from copies of its best row with
    `n_moves` random moves each; the elite half is untouched
    (islands.py:789-853). Populations under 2 are returned unchanged."""
    L = len(gens)
    pop = state.penalty.shape[0] // L
    half = pop // 2
    if half < 1:
        return state
    n_moves = min(n_moves, KICK_MAX_MOVES)
    n_clone = pop - half
    s = _blocks(state.slots, L)[:, :1].expand(L, n_clone, -1).reshape(
        L * n_clone, -1)
    r = _blocks(state.rooms, L)[:, :1].expand(L, n_clone, -1).reshape(
        L * n_clone, -1)
    for _ in range(n_moves):
        draws = make_move_draws(gens, n_clone, pa.n_events, pa.n_slots,
                                cfg.p1, cfg.p2, cfg.p3, pa.device)
        s, r = random_move(pa, draws, s, r)
    slots = _blocks(state.slots, L).clone()
    rooms = _blocks(state.rooms, L).clone()
    slots[:, half:] = _blocks(s, L)
    rooms[:, half:] = _blocks(r, L)
    return ga.evaluate(pa, slots.reshape(L * pop, -1),
                       rooms.reshape(L * pop, -1), groups=L)


def shrink(state: ga.PopState, L: int, pop_out: int) -> ga.PopState:
    """Keep each island's elite `pop_out` rows (islands are sorted)."""
    return ga.PopState(*(
        _blocks(x, L)[:, :pop_out].reshape((-1,) + tuple(x.shape[1:]))
        for x in state))

