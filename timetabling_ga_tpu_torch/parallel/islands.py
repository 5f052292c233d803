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

Under `--quality` (JAX islands.py:545-595, the quality runners at
:336-397 and :986-1067) a dispatch's leaf is packed as `deltas` even in
`full` mode, then, uncapped (K = T), the trace keeps every improvement,
and each island's row carries the quality block (obs/quality.py) after
it: [event leaf | N_OPS counters | migration gain | N_DIV diversity].
The counters accumulate on the card a generation at a time (kernel K14's
quality_ops, through ops/ga.py generation), the gain at each ring
exchange (K7's migrate), the diversity of the dispatch's final
population once (K14's div_stats); the host splits the block off with
`split_quality`. Nothing new is drawn: the trajectory and the record
stream are the same with it on or off.

The serve lanes (JAX islands.py:139 `pad_lanes`, :1087 `make_lane_init`,
:1115 `make_lane_runner`): `lane_init` initialises one job's population
on its own problem, and `lane_run` advances a dispatch's lanes — each a
job with its own problem (problem.LaneProblems), generator and count —
through the serve generation, with no migration, returning each lane's
per-generation best (hcv, scv) and sentinels past its count, or under
`deltas`/`stats` (and `--quality`) the packed leaf with each lane's rows
at and past its count masked (K13's lane form, `compress_trace_lanes`),
then each lane's quality block: its counters over its own generations, a
zero gain (lanes never migrate) and the diversity of its final rows
under its own event mask (K14's lane form, `div_stats_lanes`).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from timetabling_ga_tpu_torch import kernels, work
from timetabling_ga_tpu_torch.obs import prof as obs_prof
from timetabling_ga_tpu_torch.obs import quality as obs_quality
from timetabling_ga_tpu_torch.ops import fitness, ga, lahc
from timetabling_ga_tpu_torch.ops.moves import (
    MoveDraws, make_move_draws, relocation_chain)
from timetabling_ga_tpu_torch.ops.sweep import sweep_local_search
from timetabling_ga_tpu_torch.problem import LaneProblems


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


def reported_i32(hcv, scv):
    """The reported best in int32 (JAX `_reported_i32`): scv once
    feasible, else hcv * 1e6 + scv, wrapping as int32 arithmetic does."""
    return torch.where(hcv == 0, scv, hcv * 1_000_000 + scv)


def migrate_plain(state: ga.PopState, L: int, return_gain: bool = False):
    """Plain version of K7's migrate entry (see `migrate`)."""
    pop = state.penalty.shape[0] // L
    if pop < 3:
        if return_gain:
            return state, torch.zeros(L, dtype=torch.int32,
                                      device=state.penalty.device)
        return state
    out = []
    for x in state:
        b = _blocks(x, L).clone()
        best = b[:, 0].clone()
        second = b[:, 1].clone()
        b[:, -1] = torch.roll(best, 1, dims=0)
        b[:, -2] = torch.roll(second, -1, dims=0)
        out.append(b.reshape(x.shape))
    new = ga.survivors_plain(ga.PopState(*out), groups=L)
    if not return_gain:
        return new

    def best(st):
        return reported_i32(_blocks(st.hcv, L)[:, 0],
                            _blocks(st.scv, L)[:, 0])
    return new, torch.clamp(best(state) - best(new), min=0)


def migrate_kernel(state: ga.PopState, L: int, return_gain: bool = False):
    """Kernel K7's migrate entry: every island in one launch, out of
    place (the emigrants are read from the input); with return_gain the
    first block of each island also writes its gain."""
    pop = state.penalty.shape[0] // L
    if pop < 3:
        if return_gain:
            return state, torch.zeros(L, dtype=torch.int32,
                                      device=state.penalty.device)
        return state
    # every island's first block writes its gain
    gain = (torch.empty(L, dtype=torch.int32, device=state.penalty.device)
            if return_gain else None)
    ins = [x.contiguous() for x in state]
    if any(x.dtype != torch.int32 for x in ins):
        raise TypeError("migrate takes an int32 population")
    out = ga.PopState(*(torch.empty_like(x) for x in ins))
    p = kernels.ptr
    kernels.launch("migrate", *(p(x) for x in ins), *(p(x) for x in out),
                   None if gain is None else p(gain), L, pop,
                   state.slots.shape[1],
                   work=work.migrate(L, pop, state.slots.shape[1]))
    return (out, gain) if return_gain else out


@obs_prof.scope("tt.migrate")
def migrate(state: ga.PopState, L: int, return_gain: bool = False):
    """Bidirectional ring migration of one migrant each way: island l's
    worst row receives island l-1's best, its second-worst island l+1's
    second-best, then each island re-sorts (ga.cpp:522-535). With one
    island the ring closes on itself, as the JAX ring over one device
    does. Populations under 3 skip migration: a victim row would alias
    the best (islands.py:247-251). With return_gain (the quality
    telemetry) also returns each island's (L,) int32 gain: its reported
    best before the exchange minus after, at least 0 (zeros under pop
    3). Kernel K7's migrate entry on CUDA tensors, the plain version on
    CPU ones."""
    if not state.slots.is_cuda:
        pop = state.penalty.shape[0] // L
        if pop >= 3:
            kernels.tally(work.migrate(L, pop, state.slots.shape[1]))
        return migrate_plain(state, L, return_gain)
    return migrate_kernel(state, L, return_gain)


# Improvement-event capacity per island per dispatch (JAX islands.py:425):
# on overflow the earliest events are dropped, the shipped count shows it
TRACE_DELTAS_CAP = int(os.environ.get("TT_TRACE_DELTAS_CAP", "64"))
# moments shipped in stats mode: mean, var, min, max (float32 bits)
TRACE_N_MOMENTS = 4
SENTINEL = 2 ** 31 - 1


def effective_trace_mode(trace_mode: str, quality: bool) -> str:
    """The leaf's packing: the quality block rides a compressed leaf, so
    under quality a `full` trace packs as `deltas` (JAX islands.py:556).
    The record stream is the same either way."""
    return "deltas" if quality and trace_mode == "full" else trace_mode


def split_quality(trace, quality: bool):
    """Host split of a fetched leaf into (event leaf, quality block or
    None), numpy only (JAX islands.py:568)."""
    if not quality:
        return trace, None
    tr = np.asarray(trace)
    w = obs_quality.QUALITY_WIDTH
    return tr[:, :-w], tr[:, -w:]


def trace_leaf_width(n_gens: int, trace_mode: str,
                     quality: bool = False) -> int:
    """Packed columns per island: K events x (gen, hcv, scv), the
    improvement count [and the moments] [and the quality block]. A
    quality-packed `full` trace is uncapped, K = n_gens (JAX
    islands.py:580)."""
    k = (n_gens if quality and trace_mode == "full"
         else min(n_gens, TRACE_DELTAS_CAP))
    mode = effective_trace_mode(trace_mode, quality)
    return (3 * k + 1 + (TRACE_N_MOMENTS if mode == "stats" else 0)
            + (obs_quality.QUALITY_WIDTH if quality else 0))


def reported_f32(hcv, scv):
    """The reported value as float32 (JAX `_reported_f32`): scv once
    feasible, else hcv * 1e6 + scv."""
    s = scv.to(torch.float32)
    return torch.where(hcv == 0, s, hcv.to(torch.float32) * 1e6 + s)


def _moments(rep, dim, valid=None):
    """(4, ...) float32 bits as int32 of (mean, var clamped at 0, min,
    max) of `rep` over `dim` (JAX `_moment_rows`, float32 throughout).
    With a boolean `valid` of rep's shape, JAX's mask-weighted form:
    sums of the valid values over max(their count, 1), min and max over
    them (+inf and -inf where none is)."""
    if valid is None:
        n = float(max(rep.shape[dim], 1))
        mean = rep.sum(dim) / n
        var = torch.clamp((rep * rep).sum(dim) / n - mean * mean, min=0.0)
        mn, mx = rep.amin(dim), rep.amax(dim)
    else:
        w = valid.to(torch.float32)
        n = torch.clamp(w.sum(dim), min=1.0)
        mean = (rep * w).sum(dim) / n
        var = torch.clamp((rep * rep * w).sum(dim) / n - mean * mean,
                          min=0.0)
        mn = torch.where(valid, rep, math.inf).amin(dim)
        mx = torch.where(valid, rep, -math.inf).amax(dim)
    return torch.stack([mean, var, mn, mx]).view(torch.int32)


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
                   kernels.ptr(out), L, n, work=work.moment_rows(hcv))
    return out


def moment_rows(hcv, scv):
    """(4, L) int32 (float32 bits) mean/var/min/max of the reported
    values of each of L rows of n (hcv, scv): K13 on CUDA tensors, the
    plain version on CPU ones."""
    if not hcv.is_cuda:
        kernels.tally(work.moment_rows(hcv))
        return moment_rows_plain(hcv, scv)
    return moment_rows_kernel(hcv, scv)


def _event_cap(T: int, cap) -> int:
    return min(T, TRACE_DELTAS_CAP if cap is None else cap)


def _valid_rows(n_valid, T: int, device):
    """(L, T) bool: row t of island l is valid iff t < n_valid[l] (None
    with n_valid None: every row)."""
    if n_valid is None:
        return None
    nv = torch.as_tensor(n_valid, dtype=torch.int32, device=device)
    return (torch.arange(T, dtype=torch.int32, device=device)[None, :]
            < nv[:, None])


def compress_trace_plain(trace, trace_mode: str, cap: int = None,
                         n_valid=None):
    """Plain version of K13's compress_trace entry (JAX `_compress_trace`):
    per island the running lexicographic minimum of (hcv, scv) from the
    sentinel over its valid rows, its strict improvements, the last K of
    them as (gen, hcv, scv) rows padded with the sentinel, their count,
    and in stats mode the moments of the valid rows' reported values
    (`_moments`' masked form with an `n_valid`)."""
    L, T, _ = trace.shape
    K = _event_cap(T, cap)
    h, s = trace[..., 0], trace[..., 1]
    key = (h.to(torch.int64) << 32) | s.to(torch.int64)
    valid = _valid_rows(n_valid, T, trace.device)
    if valid is not None:
        # an invalid row neither improves nor moves the running minimum
        key = torch.where(valid, key, torch.iinfo(torch.int64).max)
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
        parts.append(_moments(reported_f32(h, s), 1, valid).T)
    return torch.cat(parts, 1)


def compress_trace_kernel(trace, trace_mode: str, cap: int = None,
                          n_valid=None):
    """K13's compress_trace entry: a warp an island, walking T in chunks
    of 32 rows, or, with an (L,) int32 n_valid (its lane form, counted as
    compress_trace_lanes), its first n_valid[l] rows."""
    trace = trace.contiguous()
    if trace.dtype != torch.int32:
        raise TypeError("compress_trace takes an int32 trace")
    L, T, _ = trace.shape
    K = _event_cap(T, cap)
    n_mom = TRACE_N_MOMENTS if trace_mode == "stats" else 0
    out = torch.empty((L, 3 * K + 1 + n_mom), dtype=torch.int32,
                      device=trace.device)
    nv = None
    if n_valid is not None:
        nv = torch.as_tensor(n_valid, dtype=torch.int32,
                             device=trace.device).contiguous()
        if tuple(nv.shape) != (L,):
            raise ValueError(f"compress_trace: n_valid {tuple(nv.shape)} "
                             f"for {L} islands")
    kernels.launch("compress_trace" if nv is None
                   else "compress_trace_lanes", kernels.ptr(trace),
                   None if nv is None else kernels.ptr(nv),
                   kernels.ptr(out), L, T, K, int(trace_mode == "stats"),
                   work=work.compress_trace(trace, K, n_mom, nv is not None))
    return out


def compress_trace(trace, trace_mode: str, cap: int = None, n_valid=None):
    """(L, T, 2) int32 per-generation (hcv, scv) trace -> (L, 3K + 1
    [+ 4]) packed leaf, K = min(T, cap), `cap` TRACE_DELTAS_CAP unless
    given (a quality-packed `full` trace passes T). `n_valid`, an (L,)
    int32 count (the serve lanes' generations), masks each island's rows
    at and past it: they are never improvements and take no part in the
    moments. K13 on a CUDA tensor, the plain version on a CPU one."""
    if not trace.is_cuda:
        kernels.tally(work.compress_trace(
            trace, _event_cap(trace.shape[1], cap),
            TRACE_N_MOMENTS if trace_mode == "stats" else 0,
            n_valid is not None))
        return compress_trace_plain(trace, trace_mode, cap, n_valid)
    return compress_trace_kernel(trace, trace_mode, cap, n_valid)


def hamming_stride(pop: int) -> int:
    """The coprime pair stride of the Hamming sample (JAX islands.py:478
    `_hamming_stride`): the largest a <= pop // 2 with gcd(a, pop) == 1,
    0 when pop < 2."""
    if pop < 2:
        return 0
    for a in range(max(1, pop // 2), 0, -1):
        if math.gcd(a, pop) == 1:
            return a
    return 1


def _div_moments(x):
    """(L, 4) float32 mean, var, min, max of (L, n) float32 values by
    JAX's min-shifted formula (islands.py:508-517)."""
    mn = x.amin(1)
    c = x - mn[:, None]
    mean_c = c.mean(1)
    var = torch.clamp((c * c).mean(1) - mean_c * mean_c, min=0.0)
    return torch.stack([mn + mean_c, var, mn, x.amax(1)], 1)


def div_stats_plain(event_mask, slots, pen, scv, L: int):
    """Plain version of K14's div_stats entry (see `div_stats`)."""
    pop = pen.shape[0] // L
    k = min(pop, obs_quality.HAMMING_PAIRS)
    stride = hamming_stride(pop)
    if stride == 0:
        ham = torch.zeros(L, dtype=torch.float32, device=pen.device)
    else:
        s = _blocks(slots, L)
        a, b = s[:, :k], torch.roll(s, -stride, 1)[:, :k]
        # a mask row a lane, or the one (E,) mask for every island
        m = event_mask.to(torch.float32).expand(L, -1)
        live = torch.clamp(m.sum(1), min=1.0)
        ham = (((a != b).to(torch.float32) * m[:, None, :]).sum((1, 2))
               / (k * live))
    div = torch.cat([_div_moments(_blocks(pen, L).to(torch.float32)),
                     _div_moments(_blocks(scv, L).to(torch.float32)),
                     ham[:, None]], 1)
    return div.view(torch.int32)


def div_stats_kernel(event_mask, slots, pen, scv, L: int):
    """K14's div_stats entry: a block an island, reading the shared (E,)
    mask or, from an (L, E) one (its lane form, counted as
    div_stats_lanes), its own row."""
    ins = [x.contiguous() for x in (pen, scv, slots)]
    if (any(x.dtype != torch.int32 for x in ins)
            or event_mask.dtype != torch.float32):
        raise TypeError("div_stats takes int32 rows and a float32 mask")
    pop = pen.shape[0] // L
    E = slots.shape[1]
    lanes = event_mask.dim() == 2
    if lanes and tuple(event_mask.shape) != (L, E):
        raise ValueError(f"div_stats: an event mask of "
                         f"{tuple(event_mask.shape)} for {L} lanes of {E}")
    out = torch.empty((L, obs_quality.N_DIV), dtype=torch.int32,
                      device=pen.device)
    p = kernels.ptr
    kernels.launch("div_stats_lanes" if lanes else "div_stats",
                   *(p(x) for x in ins), p(event_mask.contiguous()), p(out),
                   L, pop, E, min(pop, obs_quality.HAMMING_PAIRS),
                   hamming_stride(pop), E if lanes else 0,
                   work=work.div_stats(L, pop, E, obs_quality.HAMMING_PAIRS))
    return out


@obs_prof.scope("tt.quality")
def div_stats(pa, state: ga.PopState, L: int):
    """(L, N_DIV) int32 (float32 bits) diversity rows of L islands (JAX
    islands.py:495 `_div_stats` over `_div_rows`): the min-shifted
    mean, var, min and max of penalty and of scv, then the Hamming
    sample — the share of live events (event_mask) on which rows i and
    (i + stride) mod pop differ, over the first min(pop, HAMMING_PAIRS)
    rows, as one float32 division by k * live; 0 when pop < 2. With `pa`
    a LaneProblems (the serve lanes, JAX's vmap of `_div_stats` over the
    lanes' problems) each lane counts under its own event mask. Kernel
    K14 on CUDA tensors, the plain version on CPU ones."""
    mask = (pa.event_masks if isinstance(pa, LaneProblems)
            else pa.event_mask)
    if not state.slots.is_cuda:
        kernels.tally(work.div_stats(L, state.penalty.shape[0] // L,
                                     state.slots.shape[1],
                                     obs_quality.HAMMING_PAIRS))
        return div_stats_plain(mask, state.slots, state.penalty, state.scv,
                               L)
    return div_stats_kernel(mask, state.slots, state.penalty, state.scv, L)


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
               trace_mode: str = "full", quality: bool = False):
    """`n_epochs` x `gens_per_epoch` generations on every island, a ring
    migration after each epoch. Returns (state, trace) with trace on the
    device: (L, n_epochs * gens_per_epoch, 2) int32, each generation's
    per-island best (hcv, scv), or under `deltas`/`stats` its packed
    leaf (`compress_trace`); with `quality` the leaf packed as
    `effective_trace_mode` says, then the quality block (see the module
    docstring). The trajectory is the same in every mode."""
    L = len(gens)
    pop = cfg.pop_size
    ls_fn = ga.ls_draws_fn(gens, pop, pa, cfg)
    qacc = mig = None
    if quality:
        qacc = torch.zeros((L, obs_quality.N_OPS), dtype=torch.int32,
                           device=pa.device)
        mig = torch.zeros((L, 1), dtype=torch.int32, device=pa.device)
    trace = []
    for _ in range(n_epochs):
        for _ in range(gens_per_epoch):
            draws = ga.make_breed_draws(gens, pop, pa.n_events, pa.n_slots,
                                        cfg, pa.device)
            state = ga.generation(pa, draws, ls_fn, state, cfg, groups=L,
                                  qacc=qacc)
            trace.append(torch.stack([_blocks(state.hcv, L)[:, 0],
                                      _blocks(state.scv, L)[:, 0]], -1))
        if quality:
            state, gain = migrate(state, L, return_gain=True)
            mig += gain[:, None]
        else:
            state = migrate(state, L)
    trace = torch.stack(trace, 1)
    mode = effective_trace_mode(trace_mode, quality)
    if mode != "full":
        # a quality-packed full trace keeps every improvement (K = T)
        trace = compress_trace(trace, mode, trace.shape[1]
                               if mode != trace_mode else None)
    if quality:
        trace = torch.cat([trace, qacc, mig, div_stats(pa, state, L)], 1)
    return state, trace


@obs_prof.scope("tt.polish")
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


# ----------------------------------------------------------- serve lanes

# the word after a job's seed in its generators' seeds: a dispatch chunk's
# generations, or the job's initial population
LANE_CHUNK_WORD = 1
LANE_INIT_WORD = 2


def pad_lanes(n_lanes: int, n_devices: int = 1) -> int:
    """Smallest lane count >= `n_lanes` that is a multiple of
    `n_devices` (JAX islands.py:139, which takes the mesh's device
    count). The port serves one card, so this is max(1, n_lanes)."""
    return ((max(1, n_lanes) + n_devices - 1) // n_devices) * n_devices


def lane_generator(device, seed: int, chunk: int = None) -> torch.Generator:
    """A job's generator: for its dispatch chunk `chunk`, or, with None,
    for its initial population — seeded through SeedSequence from (seed,
    the word, chunk) as engine.island_generators seeds islands. A job's
    stream is then a pure function of its own seed and progress, as JAX's
    fold_in(fold_in(key(seed), chunk), generation) keys are
    (serve/scheduler.py:64-69)."""
    words = [int(seed) & (2 ** 64 - 1),
             LANE_INIT_WORD if chunk is None else LANE_CHUNK_WORD,
             0 if chunk is None else int(chunk)]
    s = int(np.random.SeedSequence(words).generate_state(
        1, dtype=np.uint64)[0] >> 1)
    g = torch.Generator(device=device)
    g.manual_seed(s)
    return g


def lane_init(pa, seed: int, pop_size: int) -> ga.PopState:
    """One job's initial population on its own problem (JAX
    make_lane_init's lane: ga.init_population with the serve config,
    which has no initial polish): uniform random slots from the job's
    init generator, greedy rooms (K1), evaluation (K2), sorted (K7)."""
    return init_island_population(
        pa, [lane_generator(pa.device, seed)], pop_size)


def _lane_rows(lanes, pop: int, device) -> torch.Tensor:
    """The row indices of `lanes`' blocks of `pop` rows."""
    return (torch.as_tensor(lanes, dtype=torch.long, device=device)[:, None]
            * pop + torch.arange(pop, device=device)).reshape(-1)


def _gather_lanes(xs, lanes, L: int, per: int) -> tuple:
    """The rows of `lanes`' blocks of `per` rows of each tensor of `xs`
    (all L of them, or no tensor: `xs` itself)."""
    if len(lanes) == L or not xs:
        return tuple(xs)
    idx = _lane_rows(lanes, per, xs[0].device)
    return tuple(x[idx] for x in xs)


def _scatter_lanes(xs, lanes, rows, L: int, per: int) -> tuple:
    """`xs` with the rows of `lanes` replaced by `rows` (all L of them:
    `rows` itself)."""
    if len(lanes) == L or not xs:
        return tuple(rows)
    idx = _lane_rows(lanes, per, xs[0].device)
    return tuple(x.index_copy(0, idx, y) for x, y in zip(xs, rows))


def lane_run(lp: LaneProblems, gens, state: ga.PopState, counts,
             cfg: ga.GAConfig, max_gens: int, trace_mode: str = "full",
             quality: bool = False):
    """One serve dispatch (JAX make_lane_runner, islands.py:1148-1218):
    lane l of `lp` (its rows the l-th block of `state`) runs counts[l] <=
    max_gens generations of `cfg` drawn from its generator gens[l] (None
    where counts[l] is 0), with no migration. Returns (state, trace):
    trace on the device, (L, max_gens, 2) int32 in trace mode `full`,
    each lane's best (hcv, scv) after each of its generations and the
    sentinel past its count (JAX's tr0); under `deltas`/`stats` the
    packed leaf of those rows with each lane's count as its valid count
    (`compress_trace`'s n_valid). With `quality` the leaf is packed as
    `effective_trace_mode` says (an upgraded `full` trace uncapped, K =
    max_gens) and each lane's row gets its quality block: the operator
    counters of its own generations, a zero gain and the diversity of
    its final rows under its own event mask.

    A lane whose count is reached drops out of the launches: the still
    running lanes' rows (and their counters' rows) are gathered, and
    their problems selected, when the set shrinks, at most L - 1 times a
    dispatch, so no kernel takes a mask, a lane's rows stay as its last
    generation left them and a lane that has dropped out counts nothing
    more (JAX's `keep`). Only lanes with a count > 0 ever run."""
    L = len(lp)
    if len(counts) != L or len(gens) != L:
        raise ValueError("lane_run: one count and one generator a lane")
    if any(not 0 <= c <= max_gens for c in counts):
        raise ValueError(f"lane_run: counts {list(counts)} outside "
                         f"[0, {max_gens}]")
    pop = cfg.pop_size
    dev = state.slots.device
    trace = torch.full((L, max_gens, 2), SENTINEL, dtype=torch.int32,
                       device=dev)
    # the operator counters, one row a lane (none without quality)
    qacc = ((torch.zeros((L, obs_quality.N_OPS), dtype=torch.int32,
                         device=dev),) if quality else ())
    cur_lanes, cur, cur_q = [], None, ()   # the running lanes' rows
    for i in range(max(counts, default=0)):
        run = [lane for lane in range(L) if counts[lane] > i]
        if run != cur_lanes:
            if cur_lanes:
                state = ga.PopState(*_scatter_lanes(state, cur_lanes, cur,
                                                    L, pop))
                qacc = _scatter_lanes(qacc, cur_lanes, cur_q, L, 1)
            cur_lanes = run
            cur = ga.PopState(*_gather_lanes(state, run, L, pop))
            cur_q = _gather_lanes(qacc, run, L, 1)
            sub = lp if len(run) == L else lp.select(run)
            rows = (slice(None) if len(run) == L
                    else torch.as_tensor(run, device=dev))
        g = [gens[lane] for lane in run]
        draws = ga.make_breed_draws(g, pop, lp.n_events, lp.n_slots, cfg,
                                    dev)
        cur = ga.generation(sub, draws, ga.ls_draws_fn(g, pop, sub, cfg),
                            cur, cfg, groups=len(run),
                            qacc=cur_q[0] if cur_q else None)
        trace[rows, i] = torch.stack([_blocks(cur.hcv, len(run))[:, 0],
                                      _blocks(cur.scv, len(run))[:, 0]], -1)
    if cur_lanes:
        state = ga.PopState(*_scatter_lanes(state, cur_lanes, cur, L, pop))
        qacc = _scatter_lanes(qacc, cur_lanes, cur_q, L, 1)
    mode = effective_trace_mode(trace_mode, quality)
    if mode != "full":
        trace = compress_trace(
            trace, mode, max_gens if mode != trace_mode else None,
            n_valid=torch.tensor(list(counts), dtype=torch.int32,
                                 device=dev))
    if quality:
        # lanes never migrate: the gain column is zeros, so the layout
        # stays the island runners' (JAX _append_quality)
        trace = torch.cat([trace, *qacc,
                           torch.zeros((L, 1), dtype=torch.int32,
                                       device=dev),
                           div_stats(lp, state, L)], 1)
    return state, trace
