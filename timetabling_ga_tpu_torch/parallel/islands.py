"""Island model (port of timetabling_ga_tpu/parallel/islands.py:128-397,
702-884).

A shard's L islands live on its card as consecutive row blocks of one
population `(L * pop, E)`; the JAX package's local-island vmap becomes
that block structure (ops/ga.py `groups`). The island mesh (`Mesh`,
JAX's `make_mesh`) holds one such shard a device — a list of
torch.devices, which may repeat one card — and, across processes
(parallel/comm.py), every rank's shards in rank order; the `mesh_*`
programs run each shard's program on its card. Migration is the ring of
the JAX `_migrate` over every island of the mesh: inside a shard kernel
K7's migrate entry (csrc/survivors.cu), and at each shard boundary a
halo exchange of one row each way (`mesh_migrate`, JAX's
`lax.ppermute` edges) that K7's halo form reads; the global best is a
min across shards and an all_reduce(MIN) across processes.
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

import contextlib
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
from timetabling_ga_tpu_torch.parallel import comm
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


def halo_row(state: ga.PopState, r: int) -> torch.Tensor:
    """Row `r` of a population packed as one (2E + 3,) int32 halo row:
    [slots | rooms | penalty | hcv | scv], a copy (the emigrant as it
    was before any write)."""
    return torch.cat([state.slots[r], state.rooms[r], state.penalty[r:r + 1],
                      state.hcv[r:r + 1], state.scv[r:r + 1]])


def _unpack_row(row: torch.Tensor, E: int) -> tuple:
    """A packed halo row's PopState fields, each with a leading 1."""
    return (row[:E][None], row[E:2 * E][None], row[2 * E:2 * E + 1],
            row[2 * E + 1:2 * E + 2], row[2 * E + 2:2 * E + 3])


def migrate_plain(state: ga.PopState, L: int, return_gain: bool = False,
                  fwd_in=None, bwd_in=None):
    """Plain version of K7's migrate entry (see `migrate`)."""
    pop = state.penalty.shape[0] // L
    if pop < 3:
        if return_gain:
            return state, torch.zeros(L, dtype=torch.int32,
                                      device=state.penalty.device)
        return state
    E = state.slots.shape[1]
    fwd = None if fwd_in is None else _unpack_row(fwd_in, E)
    bwd = None if bwd_in is None else _unpack_row(bwd_in, E)
    out = []
    for i, x in enumerate(state):
        b = _blocks(x, L).clone()
        best = b[:, 0].clone()
        second = b[:, 1].clone()
        imm_f = torch.roll(best, 1, dims=0)
        imm_b = torch.roll(second, -1, dims=0)
        if fwd is not None:
            imm_f[0] = fwd[i][0]
        if bwd is not None:
            imm_b[L - 1] = bwd[i][0]
        b[:, -1] = imm_f
        b[:, -2] = imm_b
        out.append(b.reshape(x.shape))
    new = ga.survivors_plain(ga.PopState(*out), groups=L)
    if not return_gain:
        return new

    def best(st):
        return reported_i32(_blocks(st.hcv, L)[:, 0],
                            _blocks(st.scv, L)[:, 0])
    return new, torch.clamp(best(state) - best(new), min=0)


def migrate_kernel(state: ga.PopState, L: int, return_gain: bool = False,
                   fwd_in=None, bwd_in=None):
    """Kernel K7's migrate entry: every island in one launch, out of
    place (the emigrants are read from the input); with return_gain the
    first block of each island also writes its gain; with halo rows
    island 0's row -1 and island L-1's row -2 come from them (its halo
    form, counted as migrate_halo)."""
    pop = state.penalty.shape[0] // L
    if pop < 3:
        if return_gain:
            return state, torch.zeros(L, dtype=torch.int32,
                                      device=state.penalty.device)
        return state
    E = state.slots.shape[1]
    has_halo = fwd_in is not None or bwd_in is not None
    for row in (fwd_in, bwd_in):
        if row is not None and (row.dtype != torch.int32
                                or row.shape != (2 * E + 3,)
                                or row.device != state.slots.device):
            raise ValueError(f"migrate: a halo row must be ({2 * E + 3},) "
                             f"int32 on the population's device, got "
                             f"{tuple(row.shape)} {row.dtype} {row.device}")
    # every island's first block writes its gain
    gain = (torch.empty(L, dtype=torch.int32, device=state.penalty.device)
            if return_gain else None)
    ins = [x.contiguous() for x in state]
    if any(x.dtype != torch.int32 for x in ins):
        raise TypeError("migrate takes an int32 population")
    out = ga.PopState(*(torch.empty_like(x) for x in ins))
    p = kernels.ptr
    kernels.launch("migrate_halo" if has_halo else "migrate",
                   *(p(x) for x in ins), *(p(x) for x in out),
                   *(None if h is None else p(h) for h in (fwd_in, bwd_in)),
                   None if gain is None else p(gain), L, pop, E,
                   work=work.migrate(L, pop, E, halo=has_halo))
    return (out, gain) if return_gain else out


@obs_prof.scope("tt.migrate")
def migrate(state: ga.PopState, L: int, return_gain: bool = False,
            fwd_in=None, bwd_in=None):
    """Bidirectional ring migration of one migrant each way: island l's
    worst row receives island l-1's best, its second-worst island l+1's
    second-best, then each island re-sorts (ga.cpp:522-535). With one
    island the ring closes on itself, as the JAX ring over one device
    does. On a mesh (`mesh_migrate`) the shard-boundary edges arrive as
    halo rows (`halo_row`): `fwd_in`, the previous shard's last island's
    best, replaces island L-1's best as island 0's immigrant, and
    `bwd_in`, the next shard's first island's second best, replaces
    island 0's second as island L-1's. Populations under 3 skip
    migration: a victim row would alias the best (islands.py:247-251).
    With return_gain (the quality telemetry) also returns each island's
    (L,) int32 gain: its reported best before the exchange minus after,
    at least 0 (zeros under pop 3). Kernel K7's migrate entry on CUDA
    tensors, the plain version on CPU ones."""
    if not state.slots.is_cuda:
        pop = state.penalty.shape[0] // L
        if pop >= 3:
            kernels.tally(work.migrate(
                L, pop, state.slots.shape[1],
                halo=fwd_in is not None or bwd_in is not None))
        return migrate_plain(state, L, return_gain, fwd_in, bwd_in)
    return migrate_kernel(state, L, return_gain, fwd_in, bwd_in)


# ------------------------------------------------------------ the mesh

class Mesh:
    """The island mesh (JAX `make_mesh`'s 1-D "island" axis): this
    process's shards, a torch.device each, and the process group
    (parallel/comm.py) whose ranks hold the other shards. A device may
    repeat: shards on one card are separate populations on it (the
    counterpart of JAX's virtual CPU devices). The global shard order is
    rank 0's shards, then rank 1's, ...; shard k holds islands [k L,
    (k + 1) L) (`local_islands`)."""

    def __init__(self, devices, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.group = comm.active() if group is None else group

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        """Shards over every process."""
        return self.n_local * self.group.world

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.group.rank * self.n_local

    def shard_device(self, s: int):
        """A context that makes local shard `s`'s card current (kernels
        launch on the current card's stream); nothing for the host."""
        d = self.devices[s]
        return torch.cuda.device(d) if d.type == "cuda" else \
            contextlib.nullcontext()

    def local_rows(self, n_global: int) -> list:
        """(start, stop) of each local shard's rows of an array of
        `n_global` rows split evenly over every shard."""
        per = n_global // self.n_shards
        return [((self.first_shard + s) * per,
                 (self.first_shard + s + 1) * per)
                for s in range(self.n_local)]

    def global_min(self, vals) -> torch.Tensor:
        """The minimum of one scalar a shard, over every shard: a min
        across the local shards, then an all_reduce(MIN) across the
        processes (JAX's lax.pmin)."""
        d0 = self.devices[0]
        m = torch.stack([v.to(d0) for v in vals]).min()
        return self.group.all_reduce_min(m)

    def halo(self, to_next, to_prev) -> tuple:
        """The ring's shard-boundary exchange: shard k's `to_next` row
        goes to shard k+1 and its `to_prev` row to shard k-1, around every
        shard of every process. Returns (from_prev, from_next) per local
        shard, each on its shard's device. Between local shards a row is
        a copy; this process's first and last shards trade with the
        neighbouring processes through one exchange (JAX's
        lax.ppermute), which closes the ring on itself in one process."""
        n = self.n_local
        x_prev, x_next = self.group.exchange(to_next[-1], to_prev[0])
        from_prev = [x_prev if s == 0 else to_next[s - 1] for s in range(n)]
        from_next = [x_next if s == n - 1 else to_prev[s + 1]
                     for s in range(n)]
        return ([r.to(self.devices[s]) for s, r in enumerate(from_prev)],
                [r.to(self.devices[s]) for s, r in enumerate(from_next)])


def visible_devices(backend: str) -> list:
    """The cards this process sees (`torch.cuda.device_count()`), or the
    host alone for `cpu`."""
    if backend == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(n_islands: int = None, devices=None, group=None) -> Mesh:
    """The island mesh over `devices` (default: the visible cards), cut
    to the first `n_islands` shards when given (JAX islands.py:128)."""
    if devices is None:
        devices = visible_devices("gpu")
    devices = list(devices)
    if n_islands is not None:
        devices = devices[:max(1, n_islands)]
    return Mesh(devices, group)


def local_islands(mesh: Mesh, n_islands: int = None) -> int:
    """Islands a shard (JAX islands.py:150): n_islands may exceed the
    shard count, each shard then carries L = n_islands / n_shards
    islands as consecutive row blocks, the ring running within a shard
    by K7 and across shards by the halo. Must divide evenly."""
    if n_islands is None:
        return 1
    n = mesh.n_shards
    if n_islands % n:
        raise ValueError(f"n_islands={n_islands} must be a multiple of "
                         f"the device count {n}")
    return n_islands // n


def on_shards(mesh: Mesh, fn, *per_shard, **kw) -> list:
    """fn(shard's args..., **kw) on each local shard, its card current;
    `per_shard` are lists with one item a shard."""
    out = []
    for s in range(mesh.n_local):
        with mesh.shard_device(s):
            out.append(fn(*(a[s] for a in per_shard), **kw))
    return out


def mesh_migrate(mesh: Mesh, states, L: int, return_gain: bool = False):
    """JAX `_migrate` over every island of the mesh (islands.py:213-285):
    the ring edges inside a shard are K7's on the card; the two edges at
    each shard boundary are the halo — island L-1's best forward to the
    next shard's island 0, island 0's second backward to the previous
    shard's island L-1 — every field of the rows, taken before any
    write. One shard in all: K7's ring closes on the card. Returns the
    shards' states (and each shard's (L,) gains)."""
    pop = states[0].penalty.shape[0] // L
    if mesh.n_shards == 1 or pop < 3:
        out = on_shards(mesh, migrate, states, L=L, return_gain=return_gain)
    else:
        to_next = on_shards(mesh, halo_row, states, r=(L - 1) * pop)
        to_prev = on_shards(mesh, halo_row, states, r=1)
        from_prev, from_next = mesh.halo(to_next, to_prev)
        out = on_shards(mesh, lambda st, f, b: migrate(st, L, return_gain,
                                                       f, b),
                        states, from_prev, from_next)
    if return_gain:
        return [o[0] for o in out], [o[1] for o in out]
    return out


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
    docstring). The trajectory is the same in every mode. One shard of
    `mesh_run_epochs`, its ring closing on the card."""
    states, traces, _ = mesh_run_epochs(
        Mesh([state.slots.device], comm.SOLO), [pa], [gens], [state], cfg,
        n_epochs, gens_per_epoch, trace_mode, quality)
    return states[0], traces[0]


def mesh_run_epochs(mesh: Mesh, pas, gens, states, cfg: ga.GAConfig,
                    n_epochs: int, gens_per_epoch: int,
                    trace_mode: str = "full", quality: bool = False):
    """`run_epochs` on every shard of the mesh (JAX make_island_runner):
    each epoch every shard runs its generations on its card, then the
    migration crosses the mesh (`mesh_migrate`). `pas`, `gens` and
    `states` hold one item a local shard. Returns (states, traces,
    global best): each shard's state and trace leaf on its card, and
    the lowest best-row penalty over every island (JAX's lax.pmin, one
    all_reduce(MIN) across processes)."""
    n_sh = mesh.n_local
    L = len(gens[0])
    pop = cfg.pop_size
    ls_fns = [ga.ls_draws_fn(g, pop, pa, cfg) for g, pa in zip(gens, pas)]
    qacc = [None] * n_sh
    mig = [None] * n_sh
    if quality:
        qacc = [torch.zeros((L, obs_quality.N_OPS), dtype=torch.int32,
                            device=pa.device) for pa in pas]
        mig = [torch.zeros((L, 1), dtype=torch.int32, device=pa.device)
               for pa in pas]
    traces = [[] for _ in range(n_sh)]
    states = list(states)
    for _ in range(n_epochs):
        for s in range(n_sh):
            pa, st = pas[s], states[s]
            with mesh.shard_device(s):
                for _ in range(gens_per_epoch):
                    draws = ga.make_breed_draws(gens[s], pop, pa.n_events,
                                                pa.n_slots, cfg, pa.device)
                    st = ga.generation(pa, draws, ls_fns[s], st, cfg,
                                       groups=L, qacc=qacc[s])
                    traces[s].append(torch.stack(
                        [_blocks(st.hcv, L)[:, 0], _blocks(st.scv, L)[:, 0]],
                        -1))
            states[s] = st
        if quality:
            states, gains = mesh_migrate(mesh, states, L, return_gain=True)
            for s in range(n_sh):
                mig[s] += gains[s][:, None]
        else:
            states = mesh_migrate(mesh, states, L)
    mode = effective_trace_mode(trace_mode, quality)
    out = []
    for s in range(n_sh):
        with mesh.shard_device(s):
            trace = torch.stack(traces[s], 1)
            if mode != "full":
                # a quality-packed full trace keeps every improvement
                # (K = T)
                trace = compress_trace(trace, mode, trace.shape[1]
                                       if mode != trace_mode else None)
            if quality:
                trace = torch.cat([trace, qacc[s], mig[s],
                                   div_stats(pas[s], states[s], L)], 1)
        out.append(trace)
    best = mesh.global_min([_blocks(st.penalty, L)[:, 0].min()
                            for st in states])
    return states, out, best


@obs_prof.scope("tt.polish")
def polish(pa, gens, state: ga.PopState, cfg: ga.GAConfig, n_sweeps: int,
           with_passes: bool = False):
    """Up to `n_sweeps` converge sweep passes over the population, each
    island a convergence group of its own whose generator draws only
    for the passes it runs (JAX's polish runner converges its flat shard
    as one group, which on its default layout of one island a device is
    one island; here a shard's islands stay independent of which
    islands share the shard, so a mesh run gives one card's records),
    then re-evaluation sorted per island. Returns (state, stats)
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
        hot_k=cfg.ls_hot_k, p3=cfg.p3, groups=L, return_passes=True)
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


# ------------------------------------------------- the mesh's programs
# Each runs its single-shard program on every local shard, its card
# current, with no collective: only the generation runner migrates
# (mesh_run_epochs). The engine fetches their outputs through
# dispatch_core.fetch, which gathers the shards.

def mesh_init(mesh: Mesh, pas, gens, pop_size: int) -> list:
    return on_shards(mesh, init_island_population, pas, gens,
                     pop_size=pop_size)


def mesh_polish(mesh: Mesh, pas, gens, states, cfg: ga.GAConfig,
                n_sweeps: int, with_passes: bool = False):
    """(states, stats) of `polish` on every shard; stats one (rows,
    L * pop) block a shard, joined along axis 1 by the fetch."""
    out = on_shards(mesh, polish, pas, gens, states, cfg=cfg,
                    n_sweeps=n_sweeps, with_passes=with_passes)
    return [o[0] for o in out], [o[1] for o in out]


def mesh_kick(mesh: Mesh, pas, gens, states, cfg: ga.GAConfig,
              n_moves: int) -> list:
    return on_shards(mesh, kick, pas, gens, states, cfg=cfg,
                     n_moves=n_moves)


def mesh_shrink(mesh: Mesh, states, L: int, pop_out: int) -> list:
    return on_shards(mesh, shrink, states, L=L, pop_out=pop_out)


def mesh_lahc_init(mesh: Mesh, pas, states, hist: int) -> list:
    return on_shards(mesh, lambda pa, st: lahc.init_lahc(
        pa, st.slots, st.rooms, hist), pas, states)


def mesh_lahc_run(mesh: Mesh, pas, gens, lstates, cfg: ga.GAConfig,
                  n_steps: int, k_cands: int, with_moments: bool = False):
    """(lstates, stats) of `lahc_run` on every shard; stats (rows, L) a
    shard, joined along axis 1 by the fetch."""
    out = on_shards(mesh, lahc_run, pas, gens, lstates, cfg=cfg,
                    n_steps=n_steps, k_cands=k_cands,
                    with_moments=with_moments)
    return [o[0] for o in out], [o[1] for o in out]


def mesh_lahc_finalize(mesh: Mesh, lstates, L: int) -> list:
    return on_shards(mesh, lahc_finalize, lstates, L=L)


# ----------------------------------------------------------- serve lanes

# the word after a job's seed in its generators' seeds: a dispatch chunk's
# generations, or the job's initial population
LANE_CHUNK_WORD = 1
LANE_INIT_WORD = 2


def pad_lanes(n_lanes: int, n_devices: int = 1) -> int:
    """Smallest lane count >= `n_lanes` that is a multiple of
    `n_devices` (JAX islands.py:139, which takes the mesh's device
    count): the serve scheduler's dispatch width on its lane mesh."""
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


def mesh_lane_run(mesh: Mesh, lps, gens, states, counts, cfg: ga.GAConfig,
                  max_gens: int, trace_mode: str = "full",
                  quality: bool = False):
    """One serve dispatch over the lane mesh: card s's lanes (the s-th
    block of len(gens) / mesh.n_local) run as one `lane_run` on its card
    from its state `states[s]` and its LaneProblems `lps[s]`; a card
    whose lanes all have count 0 (filler, `lps[s]` None) does not run.
    Lanes never migrate: no collective. Returns (states, traces), the
    traces of the cards that ran, in lane order (the cards that run are
    a prefix: jobs fill the lanes in order)."""
    per = len(gens) // mesh.n_local
    states = list(states)
    traces = []
    for s in range(mesh.n_local):
        lanes = slice(s * per, (s + 1) * per)
        if lps[s] is None or not any(counts[lanes]):
            continue
        with mesh.shard_device(s):
            states[s], tr = lane_run(lps[s], gens[lanes], states[s],
                                     counts[lanes], cfg, max_gens,
                                     trace_mode, quality)
        traces.append(tr)
    return states, traces
