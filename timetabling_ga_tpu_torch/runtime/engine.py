"""The single-GPU run loop (the main path of
timetabling_ga_tpu/runtime/engine.py:885-1066 and `_run_tries` :1272-).

    load -> per try: init (random slots + K1 + K2) -> chunked init polish
    -> dispatches of epochs x migration_period generations (ring
    migration per epoch) under the -t budget -> post-feasibility switch
    (post_* config, elite shrink to post_pop_size) -> stall kicks with an
    escalating depth -> budget-tail polish -> solution / runEntry records;
    with --post-lahc the phase switch hands the rest of the budget to the
    LAHC walkers instead (no kick, no tail polish after them)

Every dispatch ends in one host read of its best trace — the full
(hcv, scv) trace, or under `--trace-mode deltas|stats` the packed leaf
of its improvements that K13 computes on the card (islands.
compress_trace) — decoded as JAX's dispatch_core.decode_telemetry does
(without the quality split): the events feed the logEntry stream with
the generation index each carries, dropped events count into
`engine.trace_delta_overflow`, and stats mode sets the
`engine.trace_best_*`, `engine.polish_*` and `engine.lahc_best_*` gauges
(obs/metrics.py REGISTRY). The record stream is the same in all three
modes.

`--checkpoint` saves the population, the generation counter, the
per-island best floor, the seed and the island generators' states
(runtime/checkpoint.py) after a dispatch once `--checkpoint-every`
epochs have passed since the last save (JAX engine.py:1846-1933). The
loop is serial, so the save runs in line: no writer thread, no
in-flight trace to fold into the saved floor. The LAHC endgame writes
none. `--resume` loads it under the run's fingerprint (JAX
engine.py:1329-1343): an explicit conflicting -s is refused, no -s
adopts the saved seed, the init and its polish are skipped, and the
generation count and the best floor continue, so the resumed logEntry
stream stays monotone. The generators are restored from the file when
it was written on the same device type, else reseeded from (seed,
trial, island, generation).

Not in the port yet: pipelining, buffer donation, fault recovery,
multi-process agreement, the quality telemetry and the metrics
exposition (runtime/config.py refuses their flags).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.obs.metrics import REGISTRY
from timetabling_ga_tpu_torch.ops import ga, lahc
from timetabling_ga_tpu_torch.parallel import islands
from timetabling_ga_tpu_torch.problem import load_tim_file
from timetabling_ga_tpu_torch.runtime import checkpoint as ckpt
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
    """Run flags -> breeding hyper-parameters (JAX engine.py:453). The
    reference's LS budget counts candidate evaluations (maxSteps); a
    random-LS round evaluates ls_candidates of them, so rounds =
    maxSteps // ls_candidates keeps the budget comparable."""
    return ga.GAConfig(
        pop_size=cfg.pop_size, p1=cfg.p1, p2=cfg.p2, p3=cfg.p3,
        ls_steps=max(1, cfg.resolved_max_steps() // cfg.ls_candidates),
        ls_candidates=cfg.ls_candidates, ls_delta=not cfg.ls_full_eval,
        ls_mode=cfg.ls_mode, ls_sweeps=cfg.ls_sweeps,
        ls_swap_block=cfg.ls_swap_block,
        ls_block_events=cfg.ls_block_events, ls_sideways=cfg.ls_sideways,
        ls_hot_k=cfg.ls_hot_k, ls_converge=cfg.ls_converge,
        init_sweeps=cfg.init_sweeps, rooms_mode=cfg.rooms_mode,
        multi_objective=cfg.nsga2)


def build_post_config(cfg: RunConfig, gacfg: ga.GAConfig):
    """Post-feasibility breeding config, or None when no post_* flag is
    set or it equals the repair config (JAX engine.py:478). With
    --post-lahc it is returned even when equal: the LAHC endgame needs
    the phase switch, and takes its pop size and move probabilities."""
    if (cfg.post_ls_sweeps is None and cfg.post_swap_block is None
            and cfg.post_hot_k is None and cfg.post_sideways is None
            and cfg.post_pop_size is None and cfg.post_lahc <= 0):
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
    if cfg.post_lahc > 0:
        return post
    return None if post == gacfg else post


def island_generators(device, seed: int, trial: int, n: int,
                      generation: int = None):
    """One torch.Generator per island, seeded from (seed, trial, island),
    or from (seed, trial, island, generation) when a resume reseeds."""
    gens = []
    for island in range(n):
        words = [seed, trial, island] + (
            [] if generation is None else [generation])
        s = int(np.random.SeedSequence(words)
                .generate_state(1, dtype=np.uint64)[0] >> 1)
        g = torch.Generator(device=device)
        g.manual_seed(s)
        gens.append(g)
    return gens


def generator_states(gens) -> np.ndarray:
    """(L, n) uint8: each island generator's state."""
    return np.stack([g.get_state().numpy() for g in gens])


def resume_generators(device, loaded: ckpt.Loaded, seed: int, trial: int,
                      n: int):
    """The island generators of a resumed try: restored from the
    checkpoint when it holds their states from this device type, else
    reseeded from (seed, trial, island, generation) with a note."""
    if (loaded.generators is not None
            and loaded.generator_device == device.type
            and len(loaded.generators) == n):
        gens = [torch.Generator(device=device) for _ in range(n)]
        for g, st in zip(gens, loaded.generators):
            g.set_state(torch.from_numpy(np.array(st)))
        return gens
    where = ("the JAX package" if loaded.generators is None
             else f"a {loaded.generator_device} device")
    print(f"note: checkpoint written by {where}; reseeding the "
          f"{device.type} island generators from (seed, trial, island, "
          f"generation {loaded.generation})", file=sys.stderr)
    return island_generators(device, seed, trial, n, loaded.generation)


def decode_trace(trace, trace_mode: str, overflow_warned: bool):
    """Decode a fetched trace leaf (JAX dispatch_core.decode_telemetry
    without the quality split): its events and moments, with dropped
    improvement events counted into engine.trace_delta_overflow and
    warned about once. Returns (events, moments, overflow_warned)."""
    events, counts, moments = islands.trace_events(trace, trace_mode)
    if counts is not None:
        dropped = int(sum(max(0, int(c) - len(e))
                          for c, e in zip(counts, events)))
        if dropped:
            REGISTRY.counter("engine.trace_delta_overflow").inc(dropped)
            if not overflow_warned:
                overflow_warned = True
                print(f"warning: --trace-mode {trace_mode} dropped "
                      f"{dropped} improvement event(s) this dispatch (cap "
                      f"{islands.TRACE_DELTAS_CAP}; raise "
                      f"TT_TRACE_DELTAS_CAP)", file=sys.stderr)
    return events, moments, overflow_warned


def _set_moment_gauges(prefix: str, mom) -> None:
    """Gauges `<prefix>_{mean,min,max}` from (4, ...) float32 moment
    rows (mean, var, min, max), aggregated over their columns."""
    REGISTRY.gauge(f"{prefix}_mean").set(float(mom[0].mean()))
    REGISTRY.gauge(f"{prefix}_min").set(float(mom[2].min()))
    REGISTRY.gauge(f"{prefix}_max").set(float(mom[3].max()))


def _moment_view(rows) -> np.ndarray:
    return np.ascontiguousarray(
        rows[:islands.TRACE_N_MOMENTS]).view(np.float32)


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
        state, stats = islands.polish(pa, gens, state, gacfg, chunk,
                                      tr.cfg.trace_mode == "stats")
        stats = stats.cpu().numpy()
        tp1 = time.monotonic()
        if stats.shape[0] > 3:
            # stats mode: row 3 the executed pass count, rows 4.. the
            # polished population's moments (JAX engine.py:1134-1156)
            REGISTRY.gauge("engine.polish_passes").set(int(stats[3].max()))
            _set_moment_gauges("engine.polish_best", _moment_view(stats[4:]))
            stats = stats[:3]
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


# the longest chunk of LAHC steps (JAX engine.py DISPATCH_CAP_S)
LAHC_CHUNK_CAP_S = 30.0


def _lahc_loop(tr: _Try, pa, gens, state, post, cfg):
    """The LAHC endgame (JAX engine.py:1185 _lahc_loop): the try's
    remaining budget in chunks of steps sized from the measured sec/step
    (a 256-step probe until there is one; the first chunk's timing, which
    carries the first launch's set-up, is not kept), one (3, L) stats
    read a chunk feeding the logEntry stream and a `lahc` phase record.
    Returns each island's best snapshots, sorted, as the population."""
    lstate = lahc.init_lahc(pa, state.slots, state.rooms, cfg.post_lahc)
    sec_per_step = None
    warm = False
    while True:
        remaining = tr.remaining()
        if sec_per_step is not None and sec_per_step > 0:
            n = int(min(remaining / 1.1, LAHC_CHUNK_CAP_S) / sec_per_step)
        else:
            n = 256 if remaining > 0 else 0
        if n < 1:
            break
        t0 = time.monotonic()
        lstate, stats = islands.lahc_run(pa, gens, lstate, post, n,
                                         cfg.post_lahc_k,
                                         cfg.trace_mode == "stats")
        stats = stats.cpu().numpy()
        t1 = time.monotonic()
        if stats.shape[0] > 3:
            # stats mode: rows 3.. the walkers' moments per island (JAX
            # engine.py:1238-1251)
            _set_moment_gauges("engine.lahc_best", _moment_view(stats[3:]))
            stats = stats[:3]
        tr.phase("lahc", t1 - t0, steps=n)
        if warm:
            sps = (t1 - t0) / n
            sec_per_step = (sps if sec_per_step is None
                            else 0.7 * sps + 0.3 * sec_per_step)
        warm = True
        for i in range(tr.n):
            tr.observe(i, stats[1][i], stats[2][i], t1 - tr.t0)
    return islands.lahc_finalize(lstate, tr.n)


def probe_sec_per_gen(pa, state: ga.PopState, cfg: ga.GAConfig,
                      n_islands: int, trace_mode: str = "full") -> float:
    """Seconds of one generation of `cfg` (its ring migration included)
    on a clone of `state`, drawn from throwaway generators: the first
    sec/gen estimate, taken as the JAX engine takes it in precompile
    (timetabling_ga_tpu/runtime/engine.py:817-836), so that the run's
    state and generators do not advance and its first dispatch is a
    full one."""
    gens = [torch.Generator(device=pa.device).manual_seed(i)
            for i in range(n_islands)]
    clone = ga.PopState(*(x.clone() for x in state))
    t0 = time.monotonic()
    _, trace = islands.run_epochs(pa, gens, clone, cfg, 1, 1, trace_mode)
    trace.cpu()
    return time.monotonic() - t0


def _dispatch_size(cfg, remaining_gens: int, sec_per_gen: float,
                   remaining_t):
    """(n_epochs, gens_per_epoch) of the next dispatch, or None when not
    one more generation is predicted to fit the budget."""
    g = cfg.migration_period
    if remaining_gens >= g:
        n_ep = max(1, min(cfg.epochs_per_dispatch, remaining_gens // g))
    else:
        n_ep, g = 1, remaining_gens
    if remaining_t <= 0:
        return None
    if sec_per_gen > 0:
        g_fit = int(remaining_t / sec_per_gen)
        if g_fit < 1:
            return None
        if n_ep * g > g_fit:
            n_ep, g = (g_fit // g, g) if g_fit >= g else (1, g_fit)
    return n_ep, g


def _fetch_state(state: ga.PopState) -> ga.PopState:
    """Host (numpy) copy of a population in one device read."""
    packed = torch.cat([state.slots, state.rooms, state.penalty[:, None],
                        state.hcv[:, None], state.scv[:, None]],
                       1).cpu().numpy()
    E = state.slots.shape[1]
    return ga.PopState(packed[:, :E], packed[:, E:2 * E], packed[:, 2 * E],
                       packed[:, 2 * E + 1], packed[:, 2 * E + 2])


def _resume(cfg, seed: int, fingerprint: str):
    """Load --checkpoint for a --resume (JAX engine.py:1329-1343): the
    checkpoint (None when the file does not exist) and the seed the try
    runs under — the saved one when no -s was given; an explicit
    conflicting -s is refused."""
    try:
        loaded = ckpt.load(cfg.checkpoint, fingerprint)
    except FileNotFoundError:
        return None, seed
    if loaded.seed is not None:
        if cfg.seed is not None and cfg.seed != loaded.seed:
            raise ValueError(
                f"checkpoint was written with seed {loaded.seed}, but -s "
                f"{cfg.seed} given — refusing to mix RNG streams")
        seed = loaded.seed
    return loaded, seed


def _run_try(cfg, out, pa, trial: int, seed: int, n_islands: int,
             gacfg, post, fingerprint: str) -> int:
    """One try: init (or the resumed checkpoint), polish, the generation
    loop with its checkpoints, tail polish and the final records.
    Returns the try's best reported evaluation."""
    tr = _Try(out, cfg, trial, n_islands)
    loaded = None
    if cfg.resume and cfg.checkpoint:
        loaded, seed = _resume(cfg, seed, fingerprint)
    sps = {}
    gens_done = 0
    if loaded is not None:
        gens = resume_generators(pa.device, loaded, seed, trial, n_islands)
        state = ga.PopState(*(torch.from_numpy(np.ascontiguousarray(
            x, np.int32)).to(pa.device) for x in loaded.state))
        gens_done = loaded.generation
        if loaded.best_seen is not None:
            tr.best = [int(b) for b in loaded.best_seen]
    else:
        gens = island_generators(pa.device, seed, trial, n_islands)
        t = time.monotonic()
        state = islands.init_island_population(pa, gens, cfg.pop_size)
        state.penalty.cpu()
        tr.phase("init", time.monotonic() - t)
        if gacfg.init_sweeps > 0:
            state, sps[gacfg] = _polish_chunks(tr, pa, gens, state, gacfg,
                                               "polish", gacfg.init_sweeps,
                                               None)
    cur = gacfg
    sec_per_gen = None
    lahc_done = False

    def maybe_switch():
        nonlocal cur, state, sec_per_gen, lahc_done
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
            if cfg.post_lahc > 0:
                # the endgame leaves the GA: the rest of the budget
                # belongs to the LAHC walkers
                state = _lahc_loop(tr, pa, gens, state, post, cfg)
                lahc_done = True

    maybe_switch()
    if not lahc_done and gens_done < cfg.generations:
        # the first estimate, from the config the loop starts with (the
        # post one, shrunk, when the polish reached feasibility), outside
        # the try's clock
        t = time.monotonic()
        sec_per_gen = probe_sec_per_gen(pa, state, cur, n_islands,
                                        cfg.trace_mode)
        tr.t0 += time.monotonic() - t
    kick_stall, kick_best, kick_streak = 0, min(tr.best), 0
    time_stopped = False
    n_dispatch = 0
    epochs_done = epochs_at_ckpt = 0
    overflow_warned = False
    t_loop = time.monotonic()
    while not lahc_done and gens_done < cfg.generations:
        size = _dispatch_size(cfg, cfg.generations - gens_done, sec_per_gen,
                              tr.remaining())
        if size is None:
            time_stopped = True
            break
        n_ep, g = size
        td0 = time.monotonic()
        state, trace = islands.run_epochs(pa, gens, state, cur, n_ep, g,
                                          cfg.trace_mode)
        trace = trace.cpu().numpy()
        td1 = time.monotonic()
        gens_run = n_ep * g
        gens_done += gens_run
        epochs_done += n_ep
        n_dispatch += 1
        dt = td1 - td0
        tr.phase("dispatch", dt, epochs=n_ep, gens=gens_run)
        spg = dt / gens_run
        sec_per_gen = spg if sec_per_gen is None else (
            0.7 * spg + 0.3 * sec_per_gen)
        events, moments, overflow_warned = decode_trace(
            trace, cfg.trace_mode, overflow_warned)
        for i in range(n_islands):
            for gi, h, sc in events[i]:
                tr.observe(i, h, sc,
                           (td0 - tr.t0) + (gi + 1) / gens_run * dt)
        if moments is not None:
            # the per-generation best's moments, across islands (JAX
            # engine.py:1676-1684)
            _set_moment_gauges("engine.trace_best", moments.T)
        maybe_switch()
        if lahc_done:
            break
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
        if (cfg.checkpoint
                and epochs_done - epochs_at_ckpt >= cfg.checkpoint_every):
            t = time.monotonic()
            ckpt.save(cfg.checkpoint, _fetch_state(state),
                      ckpt.key_words(seed, trial, gens_done), gens_done,
                      fingerprint, list(tr.best), seed,
                      generator_states(gens), pa.device.type)
            epochs_at_ckpt = epochs_done
            tr.phase("checkpoint", time.monotonic() - t)
            REGISTRY.counter("engine.checkpoints").inc()
    tr.phase("gen-loop", time.monotonic() - t_loop, dispatches=n_dispatch,
             pipelined=False)

    # budget-tail polish: the slice too short for one more generation
    # goes to sweep passes, when a measured sec/sweep says one fits
    if time_stopped and sps.get(cur):
        state, _ = _polish_chunks(tr, pa, gens, state, cur, "tail-polish",
                                  None, sps[cur])

    t = time.monotonic()
    P = cur.pop_size
    host = _fetch_state(state)
    tr.phase("fetch", time.monotonic() - t)
    E = pa.n_events
    slots = host.slots.reshape(n_islands, P, E)
    rooms = host.rooms.reshape(n_islands, P, E)
    hcv = host.hcv.reshape(n_islands, P)[:, 0]
    scv = host.scv.reshape(n_islands, P)[:, 0]
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
    if cfg.ls_time_limit != 99999.0:
        # -l is retired, as on the JAX path (engine.py:894-901): the
        # local search is bounded by candidate count, not wall clock
        print("warning: -l (LS time limit) is retired on the GPU path; "
              "the local search is bounded by -m (maxSteps) candidate "
              "evaluations instead", file=sys.stderr)
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
        if (cfg.checkpoint and post is not None
                and post.pop_size != gacfg.pop_size):
            # the mid-run shape change cannot round-trip a checkpoint
            # (parse_args refuses the flags; this guards programmatic
            # configs, as JAX engine.py:657-663 does)
            raise ValueError("post_pop_size with checkpoint is unsupported")
        if post is not None and not 1 <= post.pop_size <= gacfg.pop_size:
            raise ValueError(f"post_pop_size {post.pop_size} must be in "
                             f"[1, pop_size={gacfg.pop_size}]")
        fingerprint = ckpt.config_fingerprint(problem, gacfg, n_islands)
        seed = cfg.resolved_seed()
        _phase(out, cfg.trace, "load", 0, time.monotonic() - t0)
        best = INT_MAX
        for trial in range(cfg.tries):
            best = min(best, _run_try(cfg, out, pa, trial, seed, n_islands,
                                      gacfg, post, fingerprint))
        return best
    finally:
        if close_out:
            out.close()
