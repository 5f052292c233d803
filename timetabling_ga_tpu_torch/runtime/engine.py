"""The single-GPU run loop (the main path of
timetabling_ga_tpu/runtime/engine.py:885-1066 and `_run_tries` :1272-).

    load -> per try: init (random slots + K1 + K2) -> chunked init polish
    -> dispatches of epochs x migration_period generations (ring
    migration per epoch) under the -t budget -> post-feasibility switch
    (post_* config, elite shrink to post_pop_size) -> stall kicks with an
    escalating depth -> budget-tail polish -> solution / runEntry records

Every dispatch ends in one host read of its (hcv, scv) best trace, which
feeds the logEntry stream, the seconds-per-generation estimate and the
control decisions. Not in this slice: pipelining, buffer donation, fault
recovery, multi-process agreement, observability, trace modes and
checkpoints (runtime/config.py refuses their flags).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import ga
from timetabling_ga_tpu_torch.parallel import islands
from timetabling_ga_tpu_torch.problem import load_tim_file
from timetabling_ga_tpu_torch.runtime import jsonl
from timetabling_ga_tpu_torch.runtime.config import RunConfig

INT_MAX = 2 ** 31 - 1
FEASIBLE_LIMIT = 1_000_000


def resolve_device(backend: str) -> torch.device:
    """The run's device: the current CUDA device for `gpu` (raising when
    there is none — never a silent CPU run), the host for `cpu`."""
    if backend == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--backend gpu: no CUDA device is visible "
                           "(pass --backend cpu to run on the host)")
    return torch.device("cuda", torch.cuda.current_device())


def build_ga_config(cfg: RunConfig) -> ga.GAConfig:
    """Run flags -> breeding hyper-parameters (JAX engine.py:453)."""
    return ga.GAConfig(
        pop_size=cfg.pop_size, p1=cfg.p1, p2=cfg.p2, p3=cfg.p3,
        ls_sweeps=cfg.ls_sweeps,
        ls_swap_block=cfg.ls_swap_block,
        ls_block_events=cfg.ls_block_events, ls_sideways=cfg.ls_sideways,
        ls_hot_k=cfg.ls_hot_k, ls_converge=cfg.ls_converge,
        init_sweeps=cfg.init_sweeps)


def build_post_config(cfg: RunConfig, gacfg: ga.GAConfig):
    """Post-feasibility breeding config, or None when no post_* flag is
    set or it equals the repair config (JAX engine.py:478)."""
    if (cfg.post_ls_sweeps is None and cfg.post_swap_block is None
            and cfg.post_hot_k is None and cfg.post_sideways is None
            and cfg.post_pop_size is None):
        return None

    def pick(v, default):
        return default if v is None else v
    post = dataclasses.replace(
        gacfg,
        pop_size=pick(cfg.post_pop_size, gacfg.pop_size),
        ls_sweeps=pick(cfg.post_ls_sweeps, gacfg.ls_sweeps),
        ls_swap_block=pick(cfg.post_swap_block, gacfg.ls_swap_block),
        ls_hot_k=pick(cfg.post_hot_k, gacfg.ls_hot_k),
        ls_sideways=pick(cfg.post_sideways, gacfg.ls_sideways))
    return None if post == gacfg else post


def island_generators(device, seed: int, trial: int, n: int):
    """One torch.Generator per island, seeded from (seed, trial, island)."""
    gens = []
    for island in range(n):
        s = int(np.random.SeedSequence([seed, trial, island])
                .generate_state(1, dtype=np.uint64)[0] >> 1)
        g = torch.Generator(device=device)
        g.manual_seed(s)
        gens.append(g)
    return gens


def _phase(out, enabled: bool, name: str, trial: int, seconds: float,
           **extra) -> None:
    if enabled:
        jsonl.phase_record(out, name, trial, seconds, **extra)


class _Try:
    """The mutable bookkeeping of one try: its clock, the per-island
    best floors and the logEntry emission."""

    def __init__(self, out, cfg: RunConfig, trial: int, n_islands: int):
        self.out = out
        self.cfg = cfg
        self.trial = trial
        self.n = n_islands
        self.t0 = time.monotonic()
        self.best = [INT_MAX] * n_islands

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def remaining(self) -> float:
        return self.cfg.time_limit - self.elapsed()

    def observe(self, island: int, hcv: int, scv: int, t: float) -> None:
        rep = jsonl.reported_best(hcv, scv)
        if rep < self.best[island]:
            self.best[island] = rep
            jsonl.log_entry(self.out, island, 0, rep, t)

    def phase(self, name: str, seconds: float, **extra) -> None:
        _phase(self.out, self.cfg.trace, name, self.trial, seconds, **extra)


def _polish_chunks(tr: _Try, pa, gens, state, gacfg, name: str,
                   max_sweeps, sec_per_sweep):
    """Budget-aware chunked polish (JAX engine.py:1074): chunks of up to
    4 converge passes while the pass budget lasts, the next chunk is
    predicted to fit the budget (x1.25), and the population's penalty
    sum keeps falling (two flat chunks end it under sideways
    acceptance, one without). Returns (state, sec_per_sweep)."""
    done = 0
    prev_sum = None
    stalls = 0
    while max_sweeps is None or done < max_sweeps:
        chunk = 4 if max_sweeps is None else min(4, max_sweeps - done)
        if sec_per_sweep is not None and sec_per_sweep > 0:
            fit = int(tr.remaining() / (1.25 * sec_per_sweep))
            chunk = 0 if fit < 1 else min(chunk, fit)
        elif tr.remaining() <= 0:
            chunk = 0
        else:
            chunk = min(chunk, 1)   # first chunk: one pass, measured
        if chunk < 1:
            break
        tp0 = time.monotonic()
        state, stats = islands.polish(pa, gens, state, gacfg, chunk)
        stats = stats.cpu().numpy()
        tp1 = time.monotonic()
        tr.phase(name, tp1 - tp0, sweeps=chunk)
        sps = (tp1 - tp0) / chunk
        sec_per_sweep = (sps if sec_per_sweep is None
                         else 0.7 * sps + 0.3 * sec_per_sweep)
        done += chunk
        hcv = stats[1].reshape(tr.n, -1)
        scv = stats[2].reshape(tr.n, -1)
        for i in range(tr.n):
            tr.observe(i, hcv[i, 0], scv[i, 0], tp1 - tr.t0)
        cur_sum = int(stats[0].astype(np.int64).sum())
        if prev_sum is not None and cur_sum >= prev_sum:
            stalls += 1
            if stalls >= 2 or gacfg.ls_sideways == 0.0:
                break
        else:
            stalls = 0
        prev_sum = cur_sum
    return state, sec_per_sweep


def _dispatch_size(cfg, remaining_gens: int, sec_per_gen, remaining_t):
    """(n_epochs, gens_per_epoch) of the next dispatch, or None when not
    one more generation is predicted to fit the budget."""
    g = cfg.migration_period
    if remaining_gens >= g:
        n_ep = max(1, min(cfg.epochs_per_dispatch, remaining_gens // g))
    else:
        n_ep, g = 1, remaining_gens
    if remaining_t <= 0:
        return None
    if sec_per_gen is None:
        # no estimate yet: a one-generation probe, so an unmeasured
        # dispatch cannot overrun -t by a whole fused chunk (the JAX CLI
        # seeds its estimate with the same one-generation probe before
        # the clock starts)
        return 1, 1
    if sec_per_gen > 0:
        g_fit = int(remaining_t / sec_per_gen)
        if g_fit < 1:
            return None
        if n_ep * g > g_fit:
            n_ep, g = (g_fit // g, g) if g_fit >= g else (1, g_fit)
    return n_ep, g


def _run_try(cfg, out, pa, trial: int, seed: int, n_islands: int,
             gacfg, post) -> int:
    """One try: init, polish, the generation loop, tail polish and the
    final records. Returns the try's best reported evaluation."""
    tr = _Try(out, cfg, trial, n_islands)
    gens = island_generators(pa.device, seed, trial, n_islands)
    t = time.monotonic()
    state = islands.init_island_population(pa, gens, cfg.pop_size)
    state.penalty.cpu()
    tr.phase("init", time.monotonic() - t)
    sps = {}
    if gacfg.init_sweeps > 0:
        state, sps[gacfg] = _polish_chunks(tr, pa, gens, state, gacfg,
                                           "polish", gacfg.init_sweeps,
                                           None)
    cur = gacfg
    sec_per_gen = None
    gens_done = 0

    def maybe_switch():
        nonlocal cur, state, sec_per_gen
        if cur is gacfg and post is not None and min(tr.best) < \
                FEASIBLE_LIMIT:
            cur = post
            if post.pop_size != gacfg.pop_size:
                state = islands.shrink(state, n_islands, post.pop_size)
            if sec_per_gen is not None:
                # post generations cost about their LS-depth ratio more
                # (JAX engine.py:316 _spg_for)
                ratio = max(1.0, post.ls_sweeps / max(gacfg.ls_sweeps, 1))
                if gacfg.ls_hot_k > 0 and post.ls_hot_k == 0:
                    ratio *= 2.0
                sec_per_gen *= ratio * post.pop_size / gacfg.pop_size
            tr.phase("phase-switch", 0.0, at_gen=gens_done)

    maybe_switch()
    kick_stall, kick_best, kick_streak = 0, min(tr.best), 0
    time_stopped = False
    n_dispatch = 0
    t_loop = time.monotonic()
    while gens_done < cfg.generations:
        size = _dispatch_size(cfg, cfg.generations - gens_done, sec_per_gen,
                              tr.remaining())
        if size is None:
            time_stopped = True
            break
        n_ep, g = size
        td0 = time.monotonic()
        state, trace = islands.run_epochs(pa, gens, state, cur, n_ep, g)
        trace = trace.cpu().numpy()
        td1 = time.monotonic()
        gens_run = n_ep * g
        gens_done += gens_run
        n_dispatch += 1
        dt = td1 - td0
        tr.phase("dispatch", dt, epochs=n_ep, gens=gens_run)
        spg = dt / gens_run
        sec_per_gen = spg if sec_per_gen is None else (
            0.7 * spg + 0.3 * sec_per_gen)
        for i in range(n_islands):
            for gi in range(gens_run):
                tr.observe(i, trace[i, gi, 0], trace[i, gi, 1],
                           (td0 - tr.t0) + (gi + 1) / gens_run * dt)
        maybe_switch()
        if cur is post and cfg.kick_stall > 0 and cur.pop_size >= 2:
            nb = min(tr.best)
            if nb < kick_best:
                kick_stall = kick_streak = 0
            else:
                kick_stall += 1
            kick_best = nb
            if kick_stall >= cfg.kick_stall and tr.remaining() > 0:
                n_moves = min(3 << kick_streak, islands.KICK_MAX_MOVES)
                t = time.monotonic()
                state = islands.kick(pa, gens, state, cur, n_moves)
                state.penalty.cpu()
                tr.phase("kick", time.monotonic() - t, at_gen=gens_done,
                         moves=n_moves)
                kick_streak += 1
                kick_stall = 0
    tr.phase("gen-loop", time.monotonic() - t_loop, dispatches=n_dispatch,
             pipelined=False)

    # budget-tail polish: the slice too short for one more generation
    # goes to sweep passes, when a measured sec/sweep says one fits
    if time_stopped and sps.get(cur):
        state, _ = _polish_chunks(tr, pa, gens, state, cur, "tail-polish",
                                  None, sps[cur])

    t = time.monotonic()
    P = cur.pop_size
    packed = torch.cat([state.slots, state.rooms, state.hcv[:, None],
                        state.scv[:, None]], 1).cpu().numpy()
    tr.phase("fetch", time.monotonic() - t)
    E = pa.n_events
    slots = packed[:, :E].reshape(n_islands, P, E)
    rooms = packed[:, E:2 * E].reshape(n_islands, P, E)
    hcv = packed[:, 2 * E].reshape(n_islands, P)[:, 0]
    scv = packed[:, 2 * E + 1].reshape(n_islands, P)[:, 0]
    total_time = tr.elapsed()
    for i in range(n_islands):
        feas = bool(hcv[i] == 0)
        jsonl.solution_record(
            out, i, 0, total_time, jsonl.reported_best(hcv[i], scv[i]),
            feas, timeslots=slots[i, 0].tolist() if feas else None,
            rooms=rooms[i, 0].tolist() if feas else None)
    trial_best = min(jsonl.reported_best(hcv[i], scv[i])
                     for i in range(n_islands))
    feasible = bool((hcv == 0).any())
    jsonl.run_entry(out, trial_best, feasible)
    jsonl.run_entry(out, trial_best, feasible, procs_num=n_islands,
                    threads_num=cfg.threads, total_time=total_time)
    return trial_best


def run(cfg: RunConfig, out=None) -> int:
    """Execute the configured run; emit the JSONL protocol on `out` (or
    -o, or stdout). Returns the best reported evaluation."""
    device = resolve_device(cfg.backend)
    if device.type == "cuda":
        # the plain float32 contractions (event heat) must stay exact
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.build()
    close_out = False
    if out is None:
        if cfg.output:
            out = open(cfg.output, "w")
            close_out = True
        else:
            out = sys.stdout
    try:
        t0 = time.monotonic()
        problem = load_tim_file(cfg.input)
        if cfg.auto_tune:
            cfg.apply_tuned_defaults(problem.n_events)
        pa = problem.device_arrays(device)
        n_islands = cfg.islands if cfg.islands is not None else 1
        gacfg = build_ga_config(cfg)
        post = build_post_config(cfg, gacfg)
        if post is not None and not 1 <= post.pop_size <= gacfg.pop_size:
            raise ValueError(f"post_pop_size {post.pop_size} must be in "
                             f"[1, pop_size={gacfg.pop_size}]")
        seed = cfg.resolved_seed()
        _phase(out, cfg.trace, "load", 0, time.monotonic() - t0)
        best = INT_MAX
        for trial in range(cfg.tries):
            best = min(best, _run_try(cfg, out, pa, trial, seed, n_islands,
                                      gacfg, post))
        return best
    finally:
        if close_out:
            out.close()
