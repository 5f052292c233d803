"""Late-Acceptance Hill Climbing walkers (port of
timetabling_ga_tpu/ops/lahc.py).

Each walker keeps a ring `hist` of Lh past costs. A step scores K random
candidates (sample_move's padded 3-relocations, delta-scored as the
random-candidate local search does), takes the block's lexicographic
best by (penalty, scv) — the first on a tie — and accepts it when it is
no worse than hist[step % Lh] or than the current cost; hist[step % Lh]
then takes the post-decision current cost. A best-so-far snapshot moves
on strict improvements only. Costs are (penalty, scv) pairs compared
lexicographically; the penalty keeps the anchor residual of the walker's
start.

`lahc_steps` is the wrapper of kernel K10 (csrc/lahc.cu): K8's
pre-pass (`random_ls_events`) takes every candidate's events from the
uniforms, then K10 runs all steps of a call in one launch, one block per
walker, scoring on the bitsets K5 keeps (ops/delta.py `slot_bitsets`);
`lahc_steps_plain` is its plain version, a Python loop over the steps.
Draws come in as `LahcDraws`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from timetabling_ga_tpu_torch import kernels, work
from timetabling_ga_tpu_torch.obs import prof as obs_prof
from timetabling_ga_tpu_torch.ops import fitness
from timetabling_ga_tpu_torch.ops.delta import (
    LSDraws, LSState, a16, apply_moves, delta_one_plain, init_state,
    state_regions)
from timetabling_ga_tpu_torch.ops.moves import MoveDraws, move_probs, sample_move


class LahcState(NamedTuple):
    """Per-walker LAHC state, every field with leading axis W."""

    ls: LSState                # current positions + maintained att/occ
    hist_pen: torch.Tensor     # (W, Lh) int32 ring of penalties
    hist_scv: torch.Tensor     # (W, Lh) int32 ring of scv tie-breaks
    step: torch.Tensor         # (W,) int32 chain position
    best_slots: torch.Tensor   # (W, E) int32 best-so-far snapshot
    best_rooms: torch.Tensor   # (W, E) int32
    best_pen: torch.Tensor     # (W,) int32
    best_hcv: torch.Tensor     # (W,) int32
    best_scv: torch.Tensor     # (W,) int32


class LahcDraws(NamedTuple):
    """The draws of n LAHC steps: candidate c of walker w at step i is
    row (i, w, c) of every field."""

    mtype: torch.Tensor   # (n, W, K) int  0 Move1 / 1 Move2 / 2 Move3
    u: torch.Tensor       # (n, W, K, E) f32 uniforms (top 3 = events)
    t: torch.Tensor       # (n, W, K) int  Move1 target slot


def make_lahc_draws(gens, walkers_per_gen: int, n_steps: int, k_cands: int,
                    n_events: int, n_slots: int, p1: float, p2: float,
                    p3: float, device) -> LahcDraws:
    """LahcDraws for len(gens) * walkers_per_gen walkers, each generator
    drawing its own block of walkers in one call per field."""
    probs = move_probs(p1, p2, p3, device)
    shape = (n_steps, walkers_per_gen, k_cands)
    parts = []
    for g in gens:
        parts.append((
            torch.multinomial(probs, n_steps * walkers_per_gen * k_cands,
                              replacement=True, generator=g).to(
                torch.int32).reshape(shape),
            torch.rand(shape + (n_events,), generator=g, device=device),
            torch.randint(0, n_slots, shape, generator=g, device=device,
                          dtype=torch.int32)))
    if len(parts) == 1:
        return LahcDraws(*parts[0])
    return LahcDraws(*(torch.cat([p[i] for p in parts], 1) for i in range(3)))


def draw_bytes_per_step(walkers: int, k_cands: int, n_events: int) -> int:
    """Bytes of one step's LahcDraws: int32 type and target and E float32
    uniforms per candidate."""
    return walkers * k_cands * (4 * n_events + 8)


@obs_prof.scope("tt.lahc")
def init_lahc(pa, slots, rooms, hist_len: int) -> LahcState:
    """Walkers at the given rows, the history primed with each walker's
    initial cost (JAX lahc.py:89)."""
    ls = init_state(pa, slots, rooms)
    W = slots.shape[0]
    ones = torch.ones((W, hist_len), dtype=torch.int32, device=slots.device)
    return LahcState(
        ls=ls, hist_pen=ones * ls.pen[:, None],
        hist_scv=ones * ls.scv[:, None],
        step=torch.zeros(W, dtype=torch.int32, device=slots.device),
        best_slots=slots.clone(), best_rooms=rooms.clone(),
        best_pen=ls.pen.clone(), best_hcv=ls.hcv.clone(),
        best_scv=ls.scv.clone())


def _lex_le(p_a, s_a, p_b, s_b):
    return (p_a < p_b) | ((p_a == p_b) & (s_a <= s_b))


def _lex_lt(p_a, s_a, p_b, s_b):
    return (p_a < p_b) | ((p_a == p_b) & (s_a < s_b))


def lahc_steps_plain(pa, draws: LahcDraws, state: LahcState) -> LahcState:
    """Plain version of K10: every step of `draws` (JAX lahc.py:246-314)."""
    n, W, K = draws.mtype.shape
    ls = state.ls
    hp, hs = state.hist_pen.clone(), state.hist_scv.clone()
    step = state.step.clone()
    bs, br = state.best_slots, state.best_rooms
    bp, bh, bv = state.best_pen, state.best_hcv, state.best_scv
    Lh = hp.shape[1]
    ar = torch.arange(W, device=ls.slots.device)
    for i in range(n):
        md = MoveDraws(draws.mtype[i].reshape(-1),
                       draws.u[i].reshape(W * K, -1),
                       draws.t[i].reshape(-1))
        evs, ns, act = (x.reshape(W, K, 3) for x in sample_move(
            pa, md, ls.slots.repeat_interleave(K, 0)))
        d_hcv, d_scv, nr = delta_one_plain(pa, ls.slots, ls.rooms, ls.att,
                                           ls.occ, evs, ns, act)
        anc = ls.pen - fitness.base_penalty(ls.hcv, ls.scv)
        ch = ls.hcv[:, None] + d_hcv
        cs = ls.scv[:, None] + d_scv
        cp = (fitness.base_penalty(ch, cs) + anc[:, None]
              + fitness.anchor_delta(pa, ls.slots, evs, ns)).to(torch.int32)
        b = fitness.lex_order(cp, cs)[:, 0]
        c_pen, c_hcv, c_scv = cp[ar, b], ch[ar, b], cs[ar, b]
        v = (step % Lh).long()
        accept = (_lex_le(c_pen, c_scv, hp[ar, v], hs[ar, v])
                  | _lex_le(c_pen, c_scv, ls.pen, ls.scv))
        slots, rooms, att, occ = apply_moves(
            pa, ls.slots, ls.rooms, ls.att, ls.occ, evs[ar, b], ns[ar, b],
            nr[ar, b], accept)
        ls = LSState(slots, rooms, att, occ,
                     torch.where(accept, c_pen, ls.pen),
                     torch.where(accept, c_hcv, ls.hcv).to(torch.int32),
                     torch.where(accept, c_scv, ls.scv).to(torch.int32))
        hp[ar, v] = ls.pen
        hs[ar, v] = ls.scv
        step = step + 1
        better = _lex_lt(ls.pen, ls.scv, bp, bv)
        bs = torch.where(better[:, None], ls.slots, bs)
        br = torch.where(better[:, None], ls.rooms, br)
        bp = torch.where(better, ls.pen, bp)
        bh = torch.where(better, ls.hcv, bh)
        bv = torch.where(better, ls.scv, bv)
    return LahcState(ls, hp, hs, step, bs, br, bp, bh, bv)


# csrc/lahc.cu K10_CHUNK_BYTES: shared memory for one of the two chunks
# of steps' draws
K10_CHUNK_BYTES = 12288
# int16 entries the events buffer has beyond its (n, W, K, 3): K10 copies
# each step's events in 16-byte pieces from the boundary at or below them
EVENT_PAD = 16


def lahc_layout(pa, k_cands: int, hist_len: int) -> tuple:
    """Dynamic shared memory K10 takes per walker, the layout of
    csrc/lahc.cu `k10_smem_layout`: slots, rooms and the best snapshot's
    slots and rooms, two buffers of 18 ints per candidate, the bitset
    slot_ev (T x W u32; ops/delta.py slot_bitsets), each rounded up to 16
    bytes, and two chunks of steps' draws (a step: its events from a
    16-byte boundary, 16 bytes more than 6K rounded up, then its move
    types and its targets, 4K each rounded up; as many steps as fit in
    K10_CHUNK_BYTES, at least one); occ, amask (S u64) and att where
    they fit (kernels.stage_regions; else K10 works on the walker's att
    and occ rows in place and keeps amask in a global scratch row); then
    the conflict bitset when it still fits in SMEM_LIMIT, then the two
    history rings (2 x Lh ints) when they still fit (else K10 reads
    each from global memory). Returns (bytes, bits staged, rings
    staged, the stage mask)."""
    E, T = pa.n_events, pa.n_slots
    W = pa.conflict_bits.shape[1]
    K = k_cands
    step = a16(6 * K) + 16 + 2 * a16(4 * K)
    chunk = max(1, K10_CHUNK_BYTES // step)
    base = a16(*(4 * E,) * 4, 2 * 4 * 18 * K, 4 * T * W) + 2 * chunk * step
    total, flags = kernels.stage_regions(base, state_regions(pa))
    staged = []
    for extra in (a16(4 * E * W), 2 * a16(4 * hist_len)):
        staged.append(total + extra <= kernels.SMEM_LIMIT)
        total += extra if staged[-1] else 0
    return (total, *staged, kernels.stage_bits(flags))


def lahc_smem_bytes(pa, k_cands: int, hist_len: int) -> int:
    """Dynamic shared memory K10 takes per walker (lahc_layout)."""
    return lahc_layout(pa, k_cands, hist_len)[0]


def _as_one_individual(u: torch.Tensor) -> LSDraws:
    """The LAHC uniforms (n, W, K, E) as K8's pre-pass takes them: one
    individual's n rounds of W x K candidates."""
    n, W, K, E = u.shape
    return LSDraws(None, u.reshape(n, W * K, 1, E), None)


def lahc_events(draws: LahcDraws) -> torch.Tensor:
    """Kernel K8's pre-pass (random_ls_events) on the LAHC draws: every
    candidate's events, (n, W, K, 3) int16 flat, EVENT_PAD entries
    longer."""
    if draws.u.dtype != torch.float32:
        raise TypeError("lahc takes float32 uniforms")
    d = _as_one_individual(draws.u.contiguous())
    n, WK, _, E = d.u.shape
    out = torch.empty(n * WK * 3 + EVENT_PAD, dtype=torch.int16,
                      device=d.u.device)
    kernels.launch("random_ls_events", kernels.ptr(d.u), kernels.ptr(out),
                   1, E, WK, n, work=work.random_ls_events(d))
    return out


def lahc_steps_kernel(pa, draws: LahcDraws, state: LahcState,
                      events: torch.Tensor | None = None) -> LahcState:
    """K8's pre-pass (lahc_events; skipped when `events` holds its
    output already), then kernel K10 on its events: every step for every
    walker in one launch, one block per walker, updating the state's
    tensors in place (a contiguous copy of any that is not contiguous).
    Raises ValueError, before any launch, when one walker's state does
    not fit in shared memory; no fallback."""
    n, W, K = draws.mtype.shape
    E = state.ls.slots.shape[1]
    smem, _, _, stage = lahc_layout(pa, K, state.hist_pen.shape[1])
    kernels.check_smem("lahc", smem)
    if tuple(draws.u.shape) != (n, W, K, E) or \
            state.ls.slots.shape[0] != W:
        raise ValueError("lahc: the draws do not fit the walkers")
    ls = state.ls
    if ls.att.dtype != torch.int16 or ls.occ.dtype != torch.int16:
        raise TypeError("lahc takes int16 att/occ")
    fields = [ls.slots, ls.rooms, ls.att, ls.occ, ls.pen, ls.hcv, ls.scv,
              *state[1:]]
    if any(x.dtype != torch.int32 for i, x in enumerate(fields)
           if i not in (2, 3)):
        raise TypeError("lahc takes an int32 state")
    fields = [x.contiguous() for x in fields]
    out = LahcState(LSState(*fields[:7]), *fields[7:])
    if n == 0:
        return out
    if events is None:
        events = lahc_events(draws)
    elif events.dtype != torch.int16 or events.numel() != (
            n * W * K * 3 + EVENT_PAD) or events.data_ptr() % 16:
        raise ValueError("lahc: the events are not the pre-pass's")
    i32 = torch.int32
    dr = [draws.mtype.to(i32).contiguous(), events,
          draws.t.to(i32).contiguous()]
    # a walker's amask row where it is not staged (att and occ are its
    # own rows, worked on in place)
    amask = (None if stage & 2 else
             torch.empty((W, pa.n_students), dtype=torch.int64,
                         device=ls.slots.device))
    p = kernels.ptr
    kernels.launch(
        "lahc", *(p(x) for x in fields + dr), p(pa.possible_u8), p(pa.live),
        p(pa.student_count), p(pa.conflict_bits), p(pa.cap_rank),
        p(pa.dead), p(pa.attends_u8), p(pa.ev_ptr), p(pa.ev_stu),
        p(pa.anchor_slots), p(pa.anchor_w),
        None if amask is None else p(amask), W, E, pa.n_rooms,
        pa.n_students, pa.n_slots, pa.slots_per_day,
        pa.conflict_bits.shape[1], K, state.hist_pen.shape[1], n,
        int(pa.anchored), stage, work=work.lahc(pa, draws, state))
    return out


@obs_prof.scope("tt.lahc")
def lahc_steps(pa, draws: LahcDraws, state: LahcState) -> LahcState:
    """Advance every walker by the draws' n steps. K8's pre-pass and
    kernel K10 on CUDA tensors (in place), the plain version on CPU
    ones."""
    if not state.ls.slots.is_cuda:
        kernels.tally(work.random_ls_events(_as_one_individual(draws.u)))
        kernels.tally(work.lahc(pa, draws, state))
        return lahc_steps_plain(pa, draws, state)
    return lahc_steps_kernel(pa, draws, state)
