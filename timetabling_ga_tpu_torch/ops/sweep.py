"""Systematic sweep local search (port of timetabling_ga_tpu/ops/sweep.py).

One pass walks pivot events — an affine coprime permutation of all
events, or the top-K by violation heat (`hot_pivots`) — in steps of
`block_events`. Each step delta-evaluates, for every individual at once:
Move1 of each block pivot to every slot (`move1_sweep`), and Move2 swaps
with `swap_block` permutation partners plus, when p3 > 0, Move3 3-cycles
over adjacent partner pairs (ops/delta.py `delta_one`); it then takes the
lexicographic (penalty, scv) best with the sideways drift/descent mix and
applies it. On CUDA tensors a whole pass is one launch of kernel K5
(csrc/sweep_pass.cu): a thread-block cluster per individual, each of its
CTAs holding the individual's state (with two bitsets, ops/delta.py
`slot_bitsets`) in shared memory across every step, splitting each
step's candidates and running K3's and K4's bodies inside;
`sweep_pass_plain` is its plain version, a Python loop over the steps
where JAX has a lax.scan. K3 (`move1_sweep`) and K4 (`delta_one`) keep
their own launches as the unit checks of the device code K5 shares. The
converge loop reads one flag per pass. Randomness comes in as tensors
(`SweepDraws`, one per pass).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch

from timetabling_ga_tpu_torch import kernels, work
from timetabling_ga_tpu_torch.obs import prof as obs_prof
from timetabling_ga_tpu_torch.ops import fitness
from timetabling_ga_tpu_torch.ops.delta import (
    LSState, _day_scv, apply_moves, delta_one_plain, init_state,
    slot_bitsets, a16, state_regions)
from timetabling_ga_tpu_torch.ops.fitness import day_view, gather_rows
from timetabling_ga_tpu_torch.ops.rooms import W_COST, W_UNSUIT

BIG = 1 << 20
SMEM_LIMIT = kernels.SMEM_LIMIT
# K5's block-wide scalars and reduction scratch (K5_MISC_INTS in
# csrc/sweep_pass.cu, which asserts that its 16 warps fit)
_K5_MISC_INTS = 128
# warps of one K5 CTA, and the largest (portable) cluster of CTAs
K5_WARPS = 16
K5_MAX_CLUSTER = 8


class SweepShape(NamedTuple):
    """Static sizes of one sweep pass (sweep.py:278-343)."""

    K: int            # pivots per pass
    B: int            # pivots per step
    SB: int           # Move2 partners per pivot
    n_steps: int
    use_hot: bool
    with_move3: bool
    n_cand: int       # candidates per individual per step


def sweep_shape(n_events: int, n_slots: int, swap_block: int,
                block_events: int, hot_k: int, p3: float) -> SweepShape:
    E = n_events
    if E < 3:
        raise ValueError("padded 3-relocation form needs E >= 3")
    SB = min(max(swap_block, 0), E - 1)
    B = min(max(block_events, 1), E)
    use_hot = 0 < hot_k < E
    K = hot_k if use_hot else E
    with_move3 = p3 > 0.0 and SB >= 2
    n_cand = B * n_slots + B * SB + (2 * B * (SB - 1) if with_move3 else 0)
    return SweepShape(K, B, SB, (K + B - 1) // B, use_hot, with_move3,
                      n_cand)


class SweepDraws(NamedTuple):
    """The draws of one sweep pass for P individuals."""

    a: torch.Tensor                      # (P,) coprime multiplier
    b: torch.Tensor                      # (P,) offset
    hot_noise: Optional[torch.Tensor]    # (P, E) f32 < 0.9, hot mode
    tie_noise: Optional[torch.Tensor]    # (n_steps, P, n_cand) f32
    allow: Optional[torch.Tensor]        # (n_steps, P) bool


def coprimes(E: int) -> torch.Tensor:
    return torch.tensor([a for a in range(1, max(E, 2))
                         if math.gcd(a, E) == 1], dtype=torch.int32)


@functools.lru_cache(maxsize=64)
def _coprimes_on(E: int, device) -> torch.Tensor:
    """coprimes(E) on `device`, made once (see moves.move_probs)."""
    c = coprimes(E)
    if torch.device(device).type == "cuda":
        return c.pin_memory().to(device, non_blocking=True)
    return c.to(device)


def make_sweep_draws(gens, rows_per_gen: int, shape: SweepShape,
                     n_events: int, sideways: float, device,
                     live=None) -> SweepDraws:
    """Draw one pass's SweepDraws, each generator its own block of rows.
    With `live` (a bool a generator), a generator that is not live draws
    nothing and its rows get fixed draws (the coprime 1, pivot 0, zero
    noise, nothing allowed): a converged island, whose pass results are
    thrown away, then consumes its generator only for the passes it ran,
    so its stream does not depend on which islands share its shard."""
    cop = _coprimes_on(n_events, device)
    a, b, hot, tie, allow = [], [], [], [], []
    n = rows_per_gen
    for i, g in enumerate(gens):
        if live is not None and not live[i]:
            a.append(cop[torch.zeros(n, dtype=torch.long, device=device)])
            b.append(torch.zeros(n, dtype=torch.int32, device=device))
            if shape.use_hot:
                hot.append(torch.zeros((n, n_events), device=device))
            if sideways > 0.0:
                tie.append(torch.zeros((shape.n_steps, n, shape.n_cand),
                                       device=device))
                allow.append(torch.zeros((shape.n_steps, n),
                                         dtype=torch.bool, device=device))
            continue
        a.append(cop[torch.randint(0, cop.numel(), (n,), generator=g,
                                   device=device)])
        b.append(torch.randint(0, n_events, (n,), generator=g,
                               device=device, dtype=torch.int32))
        if shape.use_hot:
            hot.append(torch.rand((n, n_events), generator=g,
                                  device=device) * 0.9)
        if sideways > 0.0:
            tie.append(torch.rand((shape.n_steps, n, shape.n_cand),
                                  generator=g, device=device))
            allow.append(torch.rand((shape.n_steps, n), generator=g,
                                    device=device) < sideways)
    return SweepDraws(
        a=torch.cat(a), b=torch.cat(b),
        hot_noise=torch.cat(hot) if hot else None,
        tie_noise=torch.cat(tie, 1) if tie else None,
        allow=torch.cat(allow, 1) if allow else None)


def _neighbor_masks(b):
    """Distance-1/2 left/right neighbour masks of (..., D, spd) bool."""
    z = torch.zeros(b.shape[:-1] + (2,), dtype=torch.bool, device=b.device)
    bp = torch.cat([z, b, z], -1)
    return bp[..., :-4], bp[..., 1:-3], bp[..., 3:-1], bp[..., 4:]


def move1_sweep_plain(pa, slots, rooms, att, occ, pivots):
    """Plain version of K3: Move1 of pivots (P, B) to every slot ->
    d_hcv, d_scv, new_rooms, each (P, B, T) int32 (JAX sweep.py:78)."""
    P, B = pivots.shape
    T, R, S = pa.n_slots, pa.n_rooms, pa.n_students
    spd, D = pa.slots_per_day, pa.n_days
    dev = slots.device
    pi = torch.arange(P, device=dev)[:, None].expand(P, B)
    bi = torch.arange(B, device=dev)[None, :].expand(P, B)
    pl = pivots.long()
    s_old = gather_rows(slots, pivots).long()
    r_old = gather_rows(rooms, pivots).long()
    live = pa.live[pl]                                   # (P, B)

    occ32 = occ.to(torch.int32)[:, None].expand(P, B, T, R).clone()
    remove_d = -(occ32[pi, bi, s_old, r_old] - 1)
    occ32[pi, bi, s_old, r_old] -= live
    unsuit = (~pa.possible[pl]).to(torch.int32)[:, :, None, :]
    key = ((occ32 + unsuit) * W_COST + unsuit * W_UNSUIT
           + pa.cap_rank + pa.dead)                      # (P, B, T, R)
    new_rooms = torch.argmin(key, -1)                    # (P, B, T)
    add_d = torch.gather(occ32, 3, new_rooms[..., None])[..., 0]
    pair_d = remove_d[..., None] + add_d
    unsuit_d = ((~pa.possible[pl[..., None], new_rooms]).to(torch.int32)
                - (~pa.possible[pl, r_old]).to(torch.int32)[..., None])

    conf = pa.conflict[pl].clone()                       # (P, B, E)
    conf.scatter_(2, pl[..., None], 0.0)
    E = slots.shape[1]
    per_slot = torch.zeros((P, B, T), dtype=torch.float32, device=dev)
    per_slot.scatter_add_(2, slots.long()[:, None, :].expand(P, B, E), conf)
    corr_d = (per_slot - torch.gather(per_slot, 2, s_old[..., None])).to(
        torch.int32)
    d_hcv = pair_d + unsuit_d + corr_d

    sc = pa.student_count[pl]
    t_idx = torch.arange(T, device=dev)
    last_d = (torch.where(t_idx % spd == spd - 1, sc[..., None], 0)
              - torch.where(s_old % spd == spd - 1, sc, 0)[..., None])

    col = pa.attends_u8.to(torch.int32).t()[pl]          # (P, B, S)
    att32 = att.to(torch.int32)[:, None].expand(P, B, S, T)
    at_old = (t_idx == s_old[..., None]).to(torch.int32)  # (P, B, T)
    att1 = att32 - col[..., None] * at_old[:, :, None, :]
    d0 = s_old // spd
    tidx = (d0[..., None] * spd + torch.arange(spd, device=dev))
    tidx = tidx[:, :, None, :].expand(P, B, S, spd)
    before = torch.gather(att32, 3, tidx)
    after = torch.gather(att1, 3, tidx)
    rm_d = _day_scv(after > 0) - _day_scv(before > 0)    # (P, B)

    b1 = day_view(att1 > 0, D, spd)                      # (P, B, S, D, spd)
    l2, l1, r1, r2 = _neighbor_masks(b1)
    free = (~b1).to(torch.int32)
    dconsec = free * ((l2 & l1).to(torch.int32) + (l1 & r1).to(torch.int32)
                      + (r1 & r2).to(torch.int32))
    cnt = b1.sum(-1, dtype=torch.int32)
    dsingle = free * ((cnt == 0).to(torch.int32)
                      - (cnt == 1).to(torch.int32))[..., None]
    add = (col[..., None, None] * (dconsec + dsingle)).sum(2).reshape(
        P, B, T)
    d_scv = last_d + rm_d[..., None] + add
    lv = live[..., None]
    return ((d_hcv * lv).to(torch.int32), (d_scv * lv).to(torch.int32),
            new_rooms.to(torch.int32))


@obs_prof.scope("tt.sweep")
def move1_sweep(pa, slots, rooms, att, occ, pivots):
    """Move1 deltas of pivots (P, B) to every slot: (d_hcv, d_scv,
    new_rooms), each (P, B, T) int32. Kernel K3 on CUDA tensors, the
    plain version on CPU ones."""
    if not slots.is_cuda:
        kernels.tally(work.move1_sweep(pa, slots, att, occ, pivots))
        return move1_sweep_plain(pa, slots, rooms, att, occ, pivots)
    P, B = pivots.shape
    T = pa.n_slots
    if att.dtype != torch.int16 or occ.dtype != torch.int16:
        raise TypeError("move1_sweep takes int16 att/occ")
    args = [x.contiguous() for x in (slots, rooms, att, occ,
                                     *slot_bitsets(pa, slots, att),
                                     pivots.to(torch.int32))]
    out = torch.empty((3, P, B, T), dtype=torch.int32, device=slots.device)
    if P * B == 0:
        return out[0], out[1], out[2]
    p = kernels.ptr
    kernels.launch(
        "move1_sweep", *(p(a) for a in args), p(pa.possible_u8),
        p(pa.live), p(pa.student_count), p(pa.conflict_bits),
        p(pa.cap_rank), p(pa.dead), p(pa.ev_ptr), p(pa.ev_stu), p(out[0]),
        p(out[1]), p(out[2]), P, B, slots.shape[1], pa.n_rooms,
        pa.n_students, T, pa.slots_per_day, pa.conflict_bits.shape[1],
        pa.max_ev_students, work=work.move1_sweep(pa, slots, att, occ,
                                                  pivots))
    return out[0], out[1], out[2]


@obs_prof.scope("tt.sweep")
def event_heat(pa, slots, rooms, att, occ, hcv) -> torch.Tensor:
    """Per-event violation involvement (P, E) float32 (JAX sweep.py:173):
    while infeasible the clash count of its cell + unsuitable flag +
    correlated events sharing its slot; once feasible its last-slot cost
    + run-of-3 and single-day membership over its students."""
    fitness.check_no_tf32(slots)
    P, E = slots.shape
    T, S, spd, D = pa.n_slots, pa.n_students, pa.slots_per_day, pa.n_days
    dev = slots.device
    sl = slots.long()
    pi = torch.arange(P, device=dev)[:, None]
    ar = torch.arange(E, device=dev)[None, :]
    occ32 = occ.to(torch.int32)
    pair = occ32[pi, sl, rooms.long()] - 1
    unsuit = (~pa.possible[ar, rooms.long()]).to(torch.int32)
    slot_oh = (sl[..., None] == torch.arange(T, device=dev)).to(
        torch.float32)                                   # (P, E, T)
    per_slot_conf = pa.conflict @ slot_oh                # (P, E, T)
    corr = (torch.gather(per_slot_conf, 2, sl[..., None])[..., 0]
            - torch.diagonal(pa.conflict))
    hcv_heat = (pair + unsuit).to(torch.float32) + corr

    sc = pa.student_count.to(torch.float32)
    last = torch.where(slots % spd == spd - 1, sc, 0.0)
    b = day_view(att > 0, D, spd)                        # (P, S, D, spd)
    l2, l1, r1, r2 = _neighbor_masks(b)
    in_run = b & ((l2 & l1) | (l1 & r1) | (r1 & r2))
    cnt = b.sum(-1, dtype=torch.int32)
    single = b & (cnt == 1)[..., None]
    heat_slot = (in_run.to(torch.float32)
                 + single.to(torch.float32)).reshape(P, S, T)
    H = pa.attends.t() @ heat_slot                       # (P, E, T)
    scv_heat = torch.gather(H, 2, sl[..., None])[..., 0] + last
    return (torch.where(hcv[:, None] > 0, hcv_heat, scv_heat)
            * pa.event_mask)


def _distinct_pad(e1, e2, E: int):
    """An event index distinct from e1 and e2 (needs E >= 3)."""
    pad = (e1 + 1) % E
    return torch.where(pad == e2, (e1 + 2) % E, pad)


def _tile(x, n_cols: int):
    reps = -(-n_cols // x.shape[1])
    return x.repeat(1, reps)[:, :n_cols]


def hot_pivots(pa, state: LSState, hot_noise, K: int) -> torch.Tensor:
    """The K hottest events of each individual (P, K) int32: event_heat
    plus the noise, in descending order with the lower index first on
    ties (a stable sort) — JAX sweep.py:322 `lax.top_k(heat + noise, K)`."""
    heat = event_heat(pa, state.slots, state.rooms, state.att, state.occ,
                      state.hcv)
    return torch.sort(heat + hot_noise, dim=1, descending=True,
                      stable=True).indices[:, :K].to(torch.int32)


def _perms(draws: SweepDraws, E: int, dev) -> torch.Tensor:
    """The pass's affine permutations (a*j + b) mod E, (P, E) int32."""
    i32 = torch.int32
    return ((draws.a.to(i32)[:, None]
             * torch.arange(E, dtype=i32, device=dev)[None, :]
             + draws.b.to(i32)[:, None]) % E).to(i32)


def sweep_pass_plain(pa, draws: SweepDraws, state: LSState,
                     swap_block: int = 8, block_events: int = 1,
                     sideways: float = 0.0, hot_k: int = 0, p3: float = 0.0,
                     ops=None):
    """Plain version of K5: one sweep pass as a loop over its steps, in
    PyTorch on any device. Returns (state, strict_rows[, ops_out]), as
    sweep_pass."""
    P, E = state.slots.shape
    T = pa.n_slots
    sh = sweep_shape(E, T, swap_block, block_events, hot_k, p3)
    K, B, SB, n_steps = sh.K, sh.B, sh.SB, sh.n_steps
    dev = state.slots.device
    i32 = torch.int32
    perms = _perms(draws, E, dev)
    pivots = (hot_pivots(pa, state, draws.hot_noise, K) if sh.use_hot
              else perms)
    pivots_pad = _tile(pivots, n_steps * B)
    ar = torch.arange(P, device=dev)
    t_ar = torch.arange(T, dtype=i32, device=dev)
    strict_rows = torch.zeros(P, dtype=torch.bool, device=dev)
    if SB > 0:
        w_len = B - 1 + SB
        perms_tiled = _tile(perms, n_steps * B + SB + E)
        # the active flags of the Move2 (e, q, pad) and Move3 blocks
        n2 = B * SB
        n3 = 2 * B * (SB - 1) if sh.with_move3 else 0
        act_c = torch.ones((P, n2 + n3, 3), dtype=torch.bool, device=dev)
        act_c[:, :n2, 2] = False
    if ops is not None:
        # accepted moves by candidate block: Move1 | Move2 | Move3
        n_acc = ops.clone()
        bounds = torch.tensor([B * T, B * T + B * SB], device=dev)
    st = state
    for pos in range(n_steps):
        s, r = st.slots, st.rooms
        e_blk = pivots_pad[:, pos * B:(pos + 1) * B]      # (P, B)
        # ---- Move1: every pivot to every slot
        dh1, ds1, rooms1 = move1_sweep_plain(pa, s, r, st.att, st.occ,
                                             e_blk)
        if pa.anchored:
            el = e_blk.long()
            anc_e = pa.anchor_slots[el]
            cand_da = [(pa.anchor_w[el][..., None] * (
                (t_ar != anc_e[..., None]).to(i32)
                - (gather_rows(s, e_blk) != anc_e).to(i32)[..., None])
            ).reshape(P, -1)]
        p1 = _distinct_pad(e_blk, e_blk, E)
        p2 = _distinct_pad(e_blk, p1, E)
        bt = (P, B, T)
        evs1 = torch.stack([e_blk, p1, p2], -1)[:, :, None, :].expand(
            P, B, T, 3)
        ns1 = torch.stack([t_ar.expand(bt),
                           gather_rows(s, p1)[..., None].expand(bt),
                           gather_rows(s, p2)[..., None].expand(bt)], -1)
        nr1 = torch.stack([rooms1,
                           gather_rows(r, p1)[..., None].expand(bt),
                           gather_rows(r, p2)[..., None].expand(bt)], -1)
        cand_dh = [dh1.reshape(P, -1)]
        cand_ds = [ds1.reshape(P, -1)]
        cand_evs = [evs1.reshape(P, -1, 3)]
        cand_ns = [ns1.reshape(P, -1, 3)]
        cand_nr = [nr1.reshape(P, -1, 3)]

        if SB > 0:
            # ---- Move2 (and Move3) candidates
            window = perms_tiled[:, pos * B + 1:pos * B + 1 + w_len]
            partners = torch.stack([window[:, j:j + SB] for j in range(B)],
                                   1)                     # (P, B, SB)
            eb = e_blk[:, :, None].expand(P, B, SB)
            pad = _distinct_pad(eb, partners, E)
            evs2 = torch.stack([eb, partners, pad], -1).reshape(P, -1, 3)
            ns2 = torch.stack([gather_rows(s, partners), gather_rows(s, eb),
                               gather_rows(s, pad)], -1).reshape(P, -1, 3)
            invalid = [(partners == eb).reshape(P, -1)]
            evs_k, ns_k = [evs2], [ns2]
            if sh.with_move3:
                q1, q2 = partners[:, :, :-1], partners[:, :, 1:]
                e3 = e_blk[:, :, None].expand(q1.shape)
                s_q1, s_q2, s_e = (gather_rows(s, x) for x in (q1, q2, e3))
                evs3 = torch.stack([e3, q1, q2], -1)
                ns3 = torch.stack([
                    torch.stack([s_q1, s_q2, s_e], -1),     # orient True
                    torch.stack([s_q2, s_e, s_q1], -1)],    # orient False
                    1)                                  # (P, 2, B, SB-1, 3)
                evs3 = evs3[:, None].expand(ns3.shape).reshape(P, -1, 3)
                ns3 = ns3.reshape(P, -1, 3)
                evs_k.append(evs3)
                ns_k.append(ns3)
                bad = (q1 == e3) | (q2 == e3) | (q1 == q2)
                invalid.append(bad[:, None].expand(P, 2, *bad.shape[1:])
                               .reshape(P, -1))
            evs_c = torch.cat(evs_k, 1)
            ns_c = torch.cat(ns_k, 1)
            dh2, ds2, nr2 = delta_one_plain(pa, s, r, st.att, st.occ, evs_c,
                                            ns_c, act_c)
            dh2 = torch.where(torch.cat(invalid, 1), BIG, dh2)
            cand_dh.append(dh2)
            cand_ds.append(ds2)
            if pa.anchored:
                cand_da.append(fitness.anchor_delta(pa, s, evs_c, ns_c))
            cand_evs.append(evs_c)
            cand_ns.append(ns_c)
            cand_nr.append(nr2)

        cand_dh = torch.cat(cand_dh, 1)
        cand_ds = torch.cat(cand_ds, 1)
        # ---- lexicographic (penalty, scv) choice and acceptance. The
        # maintained pen carries the anchor residual (init_state's pen
        # includes the anchor term); on unanchored instances both anchor
        # terms are exactly 0 and skipped
        new_hcv = st.hcv[:, None] + cand_dh
        new_scv = st.scv[:, None] + cand_ds
        new_pen = fitness.base_penalty(new_hcv, new_scv)
        if pa.anchored:
            anc = st.pen - fitness.base_penalty(st.hcv, st.scv)
            new_pen = new_pen + anc[:, None] + torch.cat(cand_da, 1)
        row_min = new_pen.min(1, keepdim=True).values
        pen_tie = new_pen == row_min
        scv_tied = torch.where(pen_tie, new_scv, 1 << 30)
        scv_min = scv_tied.min(1, keepdim=True).values
        lex_tie = scv_tied == scv_min
        if sideways > 0.0:
            noise = draws.tie_noise[pos]
            drift_best = torch.argmax(torch.where(pen_tie, noise, -1.0), 1)
            lex_best = torch.argmax(torch.where(lex_tie, noise, -1.0), 1)
            allow = draws.allow[pos]
            best = torch.where(allow, drift_best, lex_best)
            best_pen = new_pen[ar, best]
            best_scv = new_scv[ar, best]
            strict = (best_pen < st.pen) | ((best_pen == st.pen)
                                            & (best_scv < st.scv))
            better = strict | (allow & (best_pen == st.pen))
        else:
            best = torch.argmax(lex_tie.to(torch.int32), 1)
            best_pen = new_pen[ar, best]
            best_scv = new_scv[ar, best]
            better = strict = ((best_pen < st.pen)
                               | ((best_pen == st.pen)
                                  & (best_scv < st.scv)))
        evs_b = torch.cat(cand_evs, 1)[ar, best]
        ns_b = torch.cat(cand_ns, 1)[ar, best]
        nr_b = torch.cat(cand_nr, 1)[ar, best]
        s2, r2, att2, occ2 = apply_moves(pa, s, r, st.att, st.occ, evs_b,
                                         ns_b, nr_b, better)
        st = LSState(
            slots=s2, rooms=r2, att=att2, occ=occ2,
            pen=torch.where(better, best_pen, st.pen).to(i32),
            hcv=torch.where(better, new_hcv[ar, best], st.hcv).to(i32),
            scv=torch.where(better, new_scv[ar, best], st.scv).to(i32))
        strict_rows |= strict
        if ops is not None:
            kind = torch.bucketize(best, bounds, right=True)
            n_acc += (torch.nn.functional.one_hot(kind, 3)
                      * better[:, None]).to(i32)
    if ops is not None:
        return st, strict_rows, n_acc
    return st, strict_rows


# the stage mask's bit of K5's Move1 masks (csrc/sweep_pass.cu
# K5_STAGE_MASKS), beside the state regions' (delta.state_regions)
K5_STAGE_MASKS = 8


def sweep_pass_layout(pa, shape: SweepShape) -> tuple[int, bool, int]:
    """Dynamic shared memory K5 takes per individual, the layout of
    csrc/sweep_pass.cu `k5_smem_layout`, the same in every CTA of a
    cluster: slots, rooms, pivots, the heat (hot mode), four ints per
    candidate (penalty, scv, and hcv and the new rooms packed in two),
    the reductions' scratch and the bitset slot_ev (T x W u32), each
    region rounded up to 16 bytes; the Move1 masks (8 B a student of an
    event; else a global row a CTA), occ, amask (S u64) and att where
    they fit (kernels.stage_regions: att goes to global memory first,
    then amask, then occ; att and occ then live in the individual's out
    rows, amask in a scratch row); plus the conflict bitset when the total
    still fits in SMEM_LIMIT (else K5 reads it from global memory).
    Returns (bytes, bits staged, the stage mask)."""
    E, T = pa.n_events, pa.n_slots
    W = pa.conflict_bits.shape[1]
    base = a16(4 * E, 4 * E, 4 * shape.K, 4 * E if shape.use_hot else 0,
               16 * shape.n_cand, 4 * T, 4 * _K5_MISC_INTS, 4 * T * W)
    # the Move1 scratch (a pivot's students' masks, 8 B each: read for
    # every target slot) first, then the state regions
    total, (masks, *flags) = kernels.stage_regions(
        base, [8 * max(pa.max_ev_students, 1), *state_regions(pa)])
    stage = kernels.stage_bits(flags) | (K5_STAGE_MASKS if masks else 0)
    with_bits = total + a16(4 * E * W)
    if with_bits <= SMEM_LIMIT:
        return with_bits, True, stage
    return total, False, stage


def sweep_pass_smem_bytes(pa, shape: SweepShape) -> int:
    """Dynamic shared memory K5 takes per individual (sweep_pass_layout)."""
    return sweep_pass_layout(pa, shape)[0]


def cluster_size(n_moves: int, P: int, sm_count: int) -> int:
    """K5's CTAs per individual: the smallest power of two that gives
    each of a step's `n_moves` Move2/Move3 candidates a warp of its own
    (16 a CTA), capped at K5_MAX_CLUSTER and at the card's SMs per
    individual, and at least 1."""
    need = -(-n_moves // K5_WARPS)
    cs = 1
    while cs < need:
        cs *= 2
    return max(1, min(cs, K5_MAX_CLUSTER, sm_count // max(P, 1)))


def auto_cluster(pa, shape: SweepShape, P: int, device) -> int:
    """The cluster size K5's wrapper takes on `device` for P individuals
    of this pass shape."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return cluster_size(shape.n_cand - shape.B * pa.n_slots, P, sms)


def sweep_pass_kernel(pa, draws: SweepDraws, state: LSState,
                      swap_block: int = 8, block_events: int = 1,
                      sideways: float = 0.0, hot_k: int = 0,
                      p3: float = 0.0, cluster: Optional[int] = None,
                      ops=None):
    """Kernel K5 on CUDA tensors: the whole pass in one launch, a cluster
    of `cluster` CTAs per individual (None: `auto_cluster`; an explicit
    size is for tests and the chip smoke). Returns (state, strict_rows,
    pivots[, ops_out]): pivots (P, K) int32 are the pass's pivot order
    (hot_pivots in hot mode, else the permutation); with `ops` (P, 3)
    int32, ops_out is ops plus the pass's accepted Move1/Move2/Move3
    counts of each row. Raises ValueError when one
    individual's state does not fit in shared memory, RuntimeError when
    the card refuses the cluster; there is no fallback."""
    P, E = state.slots.shape
    T = pa.n_slots
    sh = sweep_shape(E, T, swap_block, block_events, hot_k, p3)
    smem, _, stage = sweep_pass_layout(pa, sh)
    kernels.check_smem("sweep_pass", smem)
    if (state.att.dtype != torch.int16 or state.occ.dtype != torch.int16
            or any(x.dtype != torch.int32 for x in (
                state.slots, state.rooms, state.pen, state.hcv, state.scv))):
        raise TypeError("sweep_pass takes int16 att/occ and int32 "
                        "slots, rooms, pen, hcv and scv")
    side = sideways > 0.0
    if (sh.use_hot and draws.hot_noise is None) or (
            side and (draws.tie_noise is None or draws.allow is None)):
        raise ValueError("sweep_pass: the draws lack the hot or tie noise "
                         "this pass needs")
    if cluster is not None and not 1 <= cluster <= K5_MAX_CLUSTER:
        raise ValueError(f"sweep_pass: a cluster of {cluster} CTAs; K5 "
                         f"takes 1 to {K5_MAX_CLUSTER}")
    i32 = torch.int32
    ins = [x.contiguous() for x in state]
    dr = [draws.a.to(i32).contiguous(), draws.b.to(i32).contiguous(),
          draws.hot_noise.contiguous() if sh.use_hot else None,
          draws.tie_noise.contiguous() if side else None,
          draws.allow.contiguous().view(torch.uint8) if side else None]
    out = LSState(*(torch.empty_like(x) for x in ins))
    strict = torch.empty(P, dtype=torch.uint8, device=state.slots.device)
    pivots = torch.empty((P, sh.K), dtype=i32, device=state.slots.device)
    ops_out = None
    if ops is not None:
        ops = ops.contiguous()
        if ops.dtype != i32 or ops.shape != (P, 3):
            raise TypeError("sweep_pass takes (P, 3) int32 move counts")
        ops_out = torch.empty_like(ops)
    tail = () if ops is None else (ops_out,)
    if P == 0:
        return (out, strict.view(torch.bool), pivots) + tail
    # amask's rows where it is not staged (att and occ live in the out
    # rows then, one copy an individual, rank 0's)
    amask = (None if stage & 2 else
             torch.empty((P, pa.n_students), dtype=torch.int64,
                         device=state.slots.device))
    p = kernels.ptr
    args = [*(p(x) for x in ins),
            *(None if x is None else p(x) for x in dr), p(pa.possible_u8),
            p(pa.live), p(pa.student_count), p(pa.conflict_bits),
            p(pa.cap_rank), p(pa.dead), p(pa.attends_u8), p(pa.ev_ptr),
            p(pa.ev_stu), p(pa.event_mask), p(pa.anchor_slots),
            p(pa.anchor_w), *(p(x) for x in out), p(strict), p(pivots),
            *((None, None) if ops is None else (p(ops), p(ops_out))),
            None if amask is None else p(amask)]
    if cluster is None:
        cluster = auto_cluster(pa, sh, P, state.slots.device)
    # the CTAs' Move1 masks rows where they are not staged
    masks = (None if stage & K5_STAGE_MASKS else
             torch.empty((P * cluster, max(pa.max_ev_students, 1)),
                         dtype=torch.int64, device=state.slots.device))
    args.append(None if masks is None else p(masks))
    kernels.launch(
        "sweep_pass", *args, P, E, pa.n_rooms, pa.n_students, T,
        pa.slots_per_day, pa.conflict_bits.shape[1], pa.max_ev_students,
        sh.K, sh.B, sh.SB, sh.n_steps, sh.n_cand, int(sh.use_hot),
        int(side), int(pa.anchored), cluster, stage,
        work=work.sweep_pass(pa, sh, state, draws))
    return (out, strict.view(torch.bool), pivots) + tail


@obs_prof.scope("tt.sweep")
def sweep_pass(pa, draws: SweepDraws, state: LSState, swap_block: int = 8,
               block_events: int = 1, sideways: float = 0.0,
               hot_k: int = 0, p3: float = 0.0, ops=None):
    """One sweep pass over a (P, E) population. Returns (state,
    improved_rows[, ops_out]): improved_rows (P,) bool marks the
    individuals that accepted at least one STRICT improvement (sideways
    accepts do not count), the per-row form of JAX's `improved` scalar;
    with `ops` (P, 3) int32, ops_out adds each row's accepted Move1,
    Move2 and Move3 counts of this pass (every accept, sideways too: JAX
    sweep.py:567-589 return_ops, per row). Kernel K5 on CUDA tensors,
    the plain version on CPU ones."""
    if not state.slots.is_cuda:
        kernels.tally(work.sweep_pass(
            pa, sweep_shape(state.slots.shape[1], pa.n_slots, swap_block,
                            block_events, hot_k, p3), state, draws))
        return sweep_pass_plain(pa, draws, state, swap_block, block_events,
                                sideways, hot_k, p3, ops)
    st, rows, _, *tail = sweep_pass_kernel(
        pa, draws, state, swap_block, block_events, sideways, hot_k, p3,
        ops=ops)
    return (st, rows, *tail)


@obs_prof.scope("tt.sweep")
def sweep_local_search(pa, draws_fn: Callable[[int], SweepDraws], slots,
                       rooms, n_sweeps: int,
                       swap_block: int = 8, converge: bool = False,
                       block_events: int = 1, sideways: float = 0.0,
                       hot_k: int = 0, p3: float = 0.0, groups: int = 1,
                       return_passes: bool = False, scores=None,
                       return_ops: bool = False):
    """Up to `n_sweeps` sweep passes over a (P, E) population; pass i
    takes `draws_fn(i)`. converge=True stops a group of rows once one
    of its passes accepts no strict improvement (JAX's while_loop; the
    rows split into `groups` equal groups — islands — that converge
    independently, as vmapped islands do). A draws_fn with `takes_live`
    set (ga.sweep_draws_fn) is called as draws_fn(i, live) once a group
    has stopped, `live` a bool a group, so a stopped group's generator
    draws no more. `scores` are the rows'
    (penalty, hcv, scv) where the caller holds them (K6's children),
    else K2 takes them. return_ops (the quality telemetry, JAX
    sweep.py:600-677) adds a (P, 3) int32 tensor of each row's accepted
    Move1/Move2/Move3 counts over the passes its group executed: a
    converged group's rows, like its state, take nothing from the
    passes after it. Returns (slots, rooms[, passes executed][, ops])."""
    state = init_state(pa, slots, rooms, scores)
    P = slots.shape[0]
    ops = (torch.zeros((P, 3), dtype=torch.int32, device=slots.device)
           if return_ops else None)
    passes = 0
    if converge:
        alive = torch.ones(groups, dtype=torch.bool, device=slots.device)
        live = None             # every group runs
        takes_live = getattr(draws_fn, "takes_live", False)
        while passes < n_sweeps:
            d = (draws_fn(passes) if live is None or not takes_live
                 else draws_fn(passes, live))
            new, improved, *new_ops = sweep_pass(
                pa, d, state, swap_block, block_events,
                sideways, hot_k, p3, ops)
            rows = alive.repeat_interleave(P // groups)
            state = LSState(*(torch.where(
                rows.reshape((P,) + (1,) * (x.dim() - 1)), x, y)
                for x, y in zip(new, state)))
            if return_ops:
                ops = torch.where(rows[:, None], new_ops[0], ops)
            passes += 1
            alive = alive & improved.reshape(groups, -1).any(1)
            flags = alive.tolist()
            if not any(flags):
                break
            live = None if all(flags) else flags
    else:
        for i in range(n_sweeps):
            state, _, *new_ops = sweep_pass(pa, draws_fn(i), state,
                                            swap_block, block_events,
                                            sideways, hot_k, p3, ops)
            if return_ops:
                ops = new_ops[0]
        passes = n_sweeps
    out = (state.slots, state.rooms)
    if return_passes:
        out += (passes,)
    if return_ops:
        out += (ops,)
    return out
