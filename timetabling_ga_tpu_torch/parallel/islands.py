"""Island model on one GPU (port of the single-device part of
timetabling_ga_tpu/parallel/islands.py:166-397, 702-884).

All L islands live on one card as consecutive row blocks of one
population `(L * pop, E)`; the JAX package's local-island vmap becomes
that block structure (ops/ga.py `groups`). Migration is the ring of the
JAX `_migrate` over the island axis, kernel K7's migrate entry
(csrc/survivors.cu) on the card: no collective is needed on one card.
The kick's move chains are one launch of K6's relocation entry. The
LAHC endgame (`lahc_run`, `lahc_finalize` around ops/lahc.py's
init_lahc; JAX islands.py:899 make_lahc_runners) runs each island's rows
as independent walkers through kernel K10, with no migration. Each
island draws from its own torch.Generator.
"""

from __future__ import annotations

import torch

from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import fitness, ga, lahc
from timetabling_ga_tpu_torch.ops.moves import (
    MoveDraws, make_move_draws, relocation_chain)
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


def migrate_plain(state: ga.PopState, L: int) -> ga.PopState:
    """Plain version of K7's migrate entry (see `migrate`)."""
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
    return ga.survivors_plain(ga.PopState(*out), groups=L)


def migrate_kernel(state: ga.PopState, L: int) -> ga.PopState:
    """Kernel K7's migrate entry: every island in one launch, out of
    place (the emigrants are read from the input)."""
    pop = state.penalty.shape[0] // L
    if pop < 3:
        return state
    ins = [x.contiguous() for x in state]
    if any(x.dtype != torch.int32 for x in ins):
        raise TypeError("migrate takes an int32 population")
    out = ga.PopState(*(torch.empty_like(x) for x in ins))
    p = kernels.ptr
    kernels.launch("migrate", *(p(x) for x in ins), *(p(x) for x in out),
                   L, pop, state.slots.shape[1])
    return out


def migrate(state: ga.PopState, L: int) -> ga.PopState:
    """Bidirectional ring migration of one migrant each way: island l's
    worst row receives island l-1's best, its second-worst island l+1's
    second-best, then each island re-sorts (ga.cpp:522-535). With one
    island the ring closes on itself, as the JAX ring over one device
    does. Populations under 3 skip migration: a victim row would alias
    the best (islands.py:247-251). Kernel K7's migrate entry on CUDA
    tensors, the plain version on CPU ones."""
    if not state.slots.is_cuda:
        return migrate_plain(state, L)
    return migrate_kernel(state, L)


def run_epochs(pa, gens, state: ga.PopState, cfg: ga.GAConfig,
               n_epochs: int, gens_per_epoch: int):
    """`n_epochs` x `gens_per_epoch` generations on every island, a ring
    migration after each epoch. Returns (state, trace) with trace
    (L, n_epochs * gens_per_epoch, 2) int32 on the device: each
    generation's per-island best (hcv, scv)."""
    L = len(gens)
    pop = cfg.pop_size
    ls_fn = ga.ls_draws_fn(gens, pop, pa, cfg)
    trace = []
    for _ in range(n_epochs):
        for _ in range(gens_per_epoch):
            draws = ga.make_breed_draws(gens, pop, pa.n_events, pa.n_slots,
                                        cfg, pa.device)
            state = ga.generation(pa, draws, ls_fn, state, cfg, groups=L)
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
    if n_moves > 0:
        moves = [make_move_draws(gens, n_clone, pa.n_events, pa.n_slots,
                                 cfg.p1, cfg.p2, cfg.p3, pa.device)
                 for _ in range(n_moves)]
        s, r = relocation_chain(
            pa, MoveDraws(*map(torch.stack, zip(*moves))), s.contiguous(),
            r.contiguous(), n_moves)
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


# the most bytes of draws one K10 launch takes: a chunk of LAHC steps is
# cut into launches of at most this much (102,912 bytes a step at
# comp01s with 4 walkers of 16 candidates: 2,608 steps a launch)
LAHC_DRAW_BYTES = 256 << 20


def lahc_run(pa, gens, lstate: lahc.LahcState, cfg: ga.GAConfig,
             n_steps: int, k_cands: int):
    """`n_steps` LAHC steps of every walker, in launches of at most
    LAHC_DRAW_BYTES of draws, each island drawing its walkers' block from
    its own generator. Returns (lstate, stats) with stats (3, L) int32 on
    the device: each island's lex-best walker's best-so-far (penalty,
    hcv, scv)."""
    L = len(gens)
    W, E = lstate.ls.slots.shape
    per = max(1, LAHC_DRAW_BYTES // lahc.draw_bytes_per_step(W, k_cands, E))
    done = 0
    while done < n_steps:
        n = min(per, n_steps - done)
        draws = lahc.make_lahc_draws(gens, W // L, n, k_cands, E,
                                     pa.n_slots, cfg.p1, cfg.p2, cfg.p3,
                                     pa.device)
        lstate = lahc.lahc_steps(pa, draws, lstate)
        done += n
    bp, bh, bs = (_blocks(x, L) for x in (lstate.best_pen, lstate.best_hcv,
                                          lstate.best_scv))
    idx = fitness.lex_order(bp, bs)[:, :1]
    stats = torch.stack([x.gather(1, idx)[:, 0] for x in (bp, bh, bs)])
    return lstate, stats


def lahc_finalize(lstate: lahc.LahcState, L: int) -> ga.PopState:
    """Each island's best snapshots sorted by (penalty, scv) (K7)."""
    return ga.survivors(ga.PopState(lstate.best_slots, lstate.best_rooms,
                                    lstate.best_pen, lstate.best_hcv,
                                    lstate.best_scv), groups=L)
