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

The per-generation best trace a dispatch returns is the full `(L, G, 2)`
(hcv, scv) trace, or, under `--trace-mode deltas|stats`, the packed
`(L, 3K + 1 [+ 4])` leaf of each island's last K strict improvements,
their count and, in stats mode, four float32 moments (JAX
`_compress_trace`, islands.py:595): kernel K13 (csrc/trace_compress.cu)
on the card, `compress_trace_plain` on the CPU. `trace_events` decodes
either on the host. In stats mode the polish and the LAHC chunks append
the same moments of their rows (K13's moment_rows entry).
"""

from __future__ import annotations

import os

import numpy as np
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


# Improvement-event capacity per island per dispatch (JAX islands.py:425):
# on overflow the earliest events are dropped, the shipped count shows it
TRACE_DELTAS_CAP = int(os.environ.get("TT_TRACE_DELTAS_CAP", "64"))
# moments shipped in stats mode: mean, var, min, max (float32 bits)
TRACE_N_MOMENTS = 4
SENTINEL = 2 ** 31 - 1


def trace_leaf_width(n_gens: int, trace_mode: str) -> int:
    """Packed columns per island: K events x (gen, hcv, scv), the
    improvement count [and the moments]."""
    k = min(n_gens, TRACE_DELTAS_CAP)
    return 3 * k + 1 + (TRACE_N_MOMENTS if trace_mode == "stats" else 0)


def reported_f32(hcv, scv):
    """The reported value as float32 (JAX `_reported_f32`): scv once
    feasible, else hcv * 1e6 + scv."""
    s = scv.to(torch.float32)
    return torch.where(hcv == 0, s, hcv.to(torch.float32) * 1e6 + s)


def _moments(rep, dim):
    """(4, ...) float32 bits as int32 of (mean, var clamped at 0, min,
    max) of `rep` over `dim` (JAX `_moment_rows`, float32 throughout)."""
    n = float(max(rep.shape[dim], 1))
    mean = rep.sum(dim) / n
    var = torch.clamp((rep * rep).sum(dim) / n - mean * mean, min=0.0)
    return torch.stack([mean, var, rep.amin(dim), rep.amax(dim)]).view(
        torch.int32)


def moment_rows_plain(hcv, scv):
    """Plain version of K13's moment_rows entry: (4, L) moment rows of
    the reported values of (L, n) hcv/scv rows."""
    return _moments(reported_f32(hcv, scv), 1)


def moment_rows_kernel(hcv, scv):
    """K13's moment_rows entry: a warp a row."""
    hcv, scv = hcv.contiguous(), scv.contiguous()
    if hcv.dtype != torch.int32 or scv.dtype != torch.int32:
        raise TypeError("moment_rows takes int32 rows")
    L, n = hcv.shape
    out = torch.empty((TRACE_N_MOMENTS, L), dtype=torch.int32,
                      device=hcv.device)
    kernels.launch("moment_rows", kernels.ptr(hcv), kernels.ptr(scv),
                   kernels.ptr(out), L, n)
    return out


def moment_rows(hcv, scv):
    """(4, L) int32 (float32 bits) mean/var/min/max of the reported
    values of each of L rows of n (hcv, scv): K13 on CUDA tensors, the
    plain version on CPU ones."""
    if not hcv.is_cuda:
        return moment_rows_plain(hcv, scv)
    return moment_rows_kernel(hcv, scv)


def compress_trace_plain(trace, trace_mode: str):
    """Plain version of K13's compress_trace entry (JAX `_compress_trace`
    with every row valid): per island the running lexicographic minimum
    of (hcv, scv) from the sentinel, its strict improvements, the last K
    of them as (gen, hcv, scv) rows padded with the sentinel, their
    count, and in stats mode the moments of the reported values."""
    L, T, _ = trace.shape
    K = min(T, TRACE_DELTAS_CAP)
    h, s = trace[..., 0], trace[..., 1]
    key = (h.to(torch.int64) << 32) | s.to(torch.int64)
    start = torch.full((L, 1), (SENTINEL << 32) | SENTINEL,
                       dtype=torch.int64, device=trace.device)
    before = torch.cat([start, key], 1).cummin(1).values[:, :T]
    mask = key < before
    n_imp = mask.sum(1, dtype=torch.int32)
    pos = mask.cumsum(1, dtype=torch.int32) - 1
    slot = pos - torch.clamp(n_imp - K, min=0)[:, None]
    idx = torch.where(mask & (slot >= 0), slot, K).to(torch.int64)
    gidx = torch.arange(T, dtype=torch.int32, device=trace.device)
    rows = torch.stack([gidx.expand(L, T), h, s], -1)
    ev = torch.full((L, K + 1, 3), SENTINEL, dtype=torch.int32,
                    device=trace.device)
    ev.scatter_(1, idx[..., None].expand(L, T, 3), rows)
    parts = [ev[:, :K].reshape(L, 3 * K), n_imp[:, None]]
    if trace_mode == "stats":
        parts.append(_moments(reported_f32(h, s), 1).T)
    return torch.cat(parts, 1)


def compress_trace_kernel(trace, trace_mode: str):
    """K13's compress_trace entry: a warp an island, walking T in chunks
    of 32 rows."""
    trace = trace.contiguous()
    if trace.dtype != torch.int32:
        raise TypeError("compress_trace takes an int32 trace")
    L, T, _ = trace.shape
    K = min(T, TRACE_DELTAS_CAP)
    out = torch.empty((L, trace_leaf_width(T, trace_mode)),
                      dtype=torch.int32, device=trace.device)
    kernels.launch("compress_trace", kernels.ptr(trace), kernels.ptr(out),
                   L, T, K, int(trace_mode == "stats"))
    return out


def compress_trace(trace, trace_mode: str):
    """(L, T, 2) int32 per-generation (hcv, scv) trace -> (L, 3K + 1
    [+ 4]) packed leaf, K = min(T, TRACE_DELTAS_CAP): K13 on a CUDA
    tensor, the plain version on a CPU one."""
    if not trace.is_cuda:
        return compress_trace_plain(trace, trace_mode)
    return compress_trace_kernel(trace, trace_mode)


def trace_events(trace, trace_mode: str):
    """Host decode of a fetched trace leaf (JAX islands.py:662), numpy
    only: (events, counts, moments) with events[i] island i's ordered
    (gen, hcv, scv) list, counts the improvement counts (None for a full
    trace, which lists every generation) and moments an (L, 4) float32
    [mean, var, min, max] array (stats mode only). Sentinel rows are
    dropped."""
    tr = np.asarray(trace)
    if tr.ndim != 2:
        flat = tr.reshape(tr.shape[0], -1, 2)
        events = [[(g, int(row[0]), int(row[1]))
                   for g, row in enumerate(isl) if row[0] != SENTINEL]
                  for isl in flat]
        return events, None, None
    n_isl, W = tr.shape
    n_mom = TRACE_N_MOMENTS if trace_mode == "stats" else 0
    K = (W - 1 - n_mom) // 3
    ev = tr[:, :3 * K].reshape(n_isl, K, 3)
    counts = tr[:, 3 * K].copy()
    moments = None
    if n_mom:
        moments = np.ascontiguousarray(tr[:, 3 * K + 1:]).view(np.float32)
    events = [[(int(g), int(h), int(s)) for g, h, s in isl
               if g != SENTINEL] for isl in ev]
    return events, counts, moments


def run_epochs(pa, gens, state: ga.PopState, cfg: ga.GAConfig,
               n_epochs: int, gens_per_epoch: int,
               trace_mode: str = "full"):
    """`n_epochs` x `gens_per_epoch` generations on every island, a ring
    migration after each epoch. Returns (state, trace) with trace on the
    device: (L, n_epochs * gens_per_epoch, 2) int32, each generation's
    per-island best (hcv, scv), or under `deltas`/`stats` its packed
    leaf (`compress_trace`). The trajectory is the same in every mode."""
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
    trace = torch.stack(trace, 1)
    if trace_mode != "full":
        trace = compress_trace(trace, trace_mode)
    return state, trace


def polish(pa, gens, state: ga.PopState, cfg: ga.GAConfig, n_sweeps: int,
           with_passes: bool = False):
    """Up to `n_sweeps` converge sweep passes over the whole population
    (one convergence group, as the JAX polish runner sweeps its flat
    shard), then re-evaluation sorted per island. Returns (state, stats)
    with stats (3, L * pop) int32 = penalty, hcv, scv; with_passes
    (stats mode, JAX make_polish_runner) appends a row of the executed
    pass count and the four moment rows of the polished population's
    reported values, each broadcast across the columns."""
    L = len(gens)
    pop = state.penalty.shape[0] // L
    slots, rooms, passes = sweep_local_search(
        pa, ga.sweep_draws_fn(gens, pop, pa, cfg), state.slots, state.rooms,
        n_sweeps=n_sweeps, swap_block=cfg.ls_swap_block, converge=True,
        block_events=cfg.ls_block_events, sideways=cfg.ls_sideways,
        hot_k=cfg.ls_hot_k, p3=cfg.p3, return_passes=True)
    st = ga.evaluate(pa, slots, rooms, groups=L)
    stats = torch.stack([st.penalty, st.hcv, st.scv])
    if with_passes:
        cols = stats.shape[1]
        stats = torch.cat([
            stats, torch.full((1, cols), passes, dtype=torch.int32,
                              device=stats.device),
            moment_rows(st.hcv[None], st.scv[None]).expand(
                TRACE_N_MOMENTS, cols)])
    return st, stats


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
             n_steps: int, k_cands: int, with_moments: bool = False):
    """`n_steps` LAHC steps of every walker, in launches of at most
    LAHC_DRAW_BYTES of draws, each island drawing its walkers' block from
    its own generator. Returns (lstate, stats) with stats (3, L) int32 on
    the device: each island's lex-best walker's best-so-far (penalty,
    hcv, scv); with_moments (stats mode, JAX make_lahc_runners) appends
    four moment rows of each island's walkers' best-so-far reported
    values."""
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
    if with_moments:
        stats = torch.cat([stats, moment_rows(bh, bs)])
    return lstate, stats


def lahc_finalize(lstate: lahc.LahcState, L: int) -> ga.PopState:
    """Each island's best snapshots sorted by (penalty, scv) (K7)."""
    return ga.survivors(ga.PopState(lstate.best_slots, lstate.best_rooms,
                                    lstate.best_pen, lstate.best_hcv,
                                    lstate.best_scv), groups=L)
