"""The run loop (the main path of timetabling_ga_tpu/runtime/engine.py:
551-587, 885-1066 and `_run_tries` :1272-), on an island mesh of one or
more cards and one or more processes.

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
compress_trace) — decoded by dispatch_core.decode_telemetry, the
decode the serve scheduler shares: the events feed the logEntry stream with
the generation index each carries, dropped events count into
`engine.trace_delta_overflow`, and stats mode sets the
`engine.trace_best_*`, `engine.polish_*` and `engine.lahc_best_*` gauges
(obs/metrics.py REGISTRY). The record stream is the same in all three
modes.

`--checkpoint` saves the population, the generation counter, the
per-island best floor, the seed and the island generators' states
(runtime/checkpoint.py) after a dispatch once `--checkpoint-every`
epochs have passed since the last save (JAX engine.py:1846-1933); the
npz is written on the record writer's thread. The LAHC endgame writes
none. `--resume` loads it under the run's fingerprint (JAX
engine.py:1329-1343): an explicit conflicting -s is refused, no -s
adopts the saved seed, the init and its polish are skipped, and the
generation count and the best floor continue, so the resumed logEntry
stream stays monotone. The generators are restored from the file when
it was written on the same device type, else reseeded from (seed,
trial, island, generation).

Dispatches are sized under JAX's watchdog cap (engine.py:296,
:1988-2041): no dispatch is predicted to take more than DISPATCH_CAP_S
seconds (`TT_DISPATCH_CAP_S`, read at import as JAX reads it), an epoch
predicted over it runs shortened and migration closes it, and a single
generation predicted over it ends the generation loop for the tail
polish. LAHC chunks take the same cap.

`--quality` (JAX engine.py:1687-1705, 1809-1845) packs each dispatch's
quality block onto its trace leaf (islands.run_epochs): decoded into the
`quality.*` counters and gauges of REGISTRY, and, with `--stall-window`
> 0, fed to a StallDetector whose stalls set `engine.stalled` and write
a quality/stall `faultEntry`; `--auto-kick-on-stall` then fires the same
kick routine as the post phase's stall kick (a quality/kick
`faultEntry`, `engine.kicks`) and re-arms the detector. The record
stream without the auto-kick is the same with it on or off.

Dispatch pipeline (JAX engine.py:1515-1546, 1938-2150): chunk N+1 is
enqueued before chunk N's trace is read, so N's telemetry is decoded
while N+1 runs. Each chunk's trace leaves the card by a non-blocking
copy into pinned memory with a CUDA event behind it
(dispatch_core.HostCopy); retiring the chunk waits on that event alone.
The loop is serial with a post config (the phase switch and the stall
kick read chunk N before choosing chunk N+1), with the quality
auto-kick, and under --no-pipeline; the records are the same either
way. A chunk's time runs from the previous fence when pipelined, and
the budget reserves the in-flight chunk's predicted cost before sizing
the next. Under --no-precompile there is no sec/gen probe, and the loop
retires each chunk before the next until one has been measured.

In-run fault recovery (JAX engine.py:1370-1440, 1940-2375): the init
is retried (at most twice) on a transient error; from then on a
Supervisor (runtime/dispatch_core.py) holds a rolling host snapshot —
population, generator states, counters, best floor, phase and kick
state — taken after init or resume and at every checkpoint fence. A
transient error (runtime/retry.py) anywhere in the loop, the tail
polish or the final read re-places the snapshot on the same card (or
the durable checkpoint, when the placement fails) and replays from
there; the emitted floor keeps replayed improvements off the stream, so
a recovered run's records equal an uninjected run's under strip_timing,
plus faultEntry records (recover with `lostGens`, degrade and restore
on the ladder, abort when --max-recoveries is spent, after which the
run raises with a final checkpoint written from the snapshot). Every
control-fence read goes through dispatch_core.fetch (the `fetch` fault
site, the --fetch-timeout watchdog), and the `dispatch` site fires
before every generation, polish, LAHC and kick dispatch, in JAX's
order. A fault never moves a run off its device.

`--obs` (JAX engine.py:965-971) emits host timing spans through the
run's writer (obs/spans.py SpanTracer), at JAX's sites with JAX's names,
`cat` and attributes: `init`, `polish` / `tail-polish`, `lahc`, one flow
a chunk over its `dispatch`, `fetch`, `fetch-read` (the watchdog thread)
and `process` spans, `kick`, `checkpoint` with `ckpt-write` on the
writer thread under its own flow, the final read's `fetch` (`endTry`)
and `recover`. The clocks are the pipeline's own, read at the fences it
already has: a span adds no device synchronization. Every
`--metrics-every` dispatches, and once at the end of each try, a
`metricsEntry` snapshots REGISTRY; under `--quality` each dispatch's
aggregate is a `qualityEntry`. The records are timing records: the
stream is the same under strip_timing with --obs on or off.

The pull front and the flight recorder (JAX engine.py:954-1040):
`--obs-listen HOST:PORT` serves /metrics, /healthz, /readyz and
/metrics/history from a daemon thread (obs/http.py); any obs surface
starts the history ring (obs/history.py, `--history-every`);
`--incident-dir` tees the record stream into the flight recorder
(obs/flight.py), which dumps a bundle on a faultEntry or a readiness
flip; under `--obs` or `--obs-listen` the memory poller (obs/cost.py,
`--mem-poll-every`) feeds the `device.mem_*` gauges from the caching
allocator. None of them writes a record: the stream is the same with
them on or off.

Profiling (JAX engine.py:976-1005, 1534-1612, 2105-2139): every
program call goes through the cost observatory (obs/cost.py
CostProgram, under JAX's program names: `init`, `polish`, `runner` for
full epochs, `dyn_runner` for the sec/gen probe and a shortened
dispatch, `kick`, `shrink`, `lahc_init`, `lahc_run`, `lahc_fin`), whose
costEntry records bind to the run's writer under --obs; each retired
chunk feeds the live roofline gauges with its call's counted work over
its wall, unless that call counted as a compile. `--trace-profile DIR`
captures one warm dispatch a try with torch.profiler on the dispatch
thread (started at its enqueue, stopped at its fetch, a `profile` phase
record; it forces the serial loop). `--profile-for N` or
`--obs-listen` wires a ProfileCapture (its own worker thread; the loop
takes a ticket as it enqueues a chunk and ticks `on_dispatch` with it
once the chunk retires, so a capture counts only chunks launched after
it started), whose finished captures
attribute themselves (obs/prof.capture_hook: gauges, and a profEntry
under --obs); `--profile-for N` triggers it at launch and /profile on
the pull front on demand. None of it changes a record of the stream
under strip_timing.

Islands across cards and processes (JAX engine.py:551-587, 640-660,
911-929, 2190-2257): the run's islands are split over an island mesh
(parallel/islands.py Mesh), whose shards are this process's visible
cards (cut to --islands) and, across processes, each rank's shards in
rank order; --islands defaults to the total shard count. Every program
runs on each local shard on its card; only the generation runner
crosses shards, by the migration's halo and one all_reduce(MIN) of the
global best. `--coordinator h:p --num-processes N --process-id i` (or
`--distributed` with torch's env:// variables) starts the process group
on a TCPStore process 0 hosts (maybe_init_distributed); every control
read gathers every rank's shards (dispatch_core.fetch), so each rank
sees the whole result and takes the same decisions; the decisions read
from a process's own clock (dispatch sizes, polish and LAHC chunks, the
kick's budget check, resume yes/no) are agreed through the accord
channel (runtime/control_channel.py), or under --no-accord broadcast
from process 0 (`_sync_vals`). Only process 0 writes the record stream
and the checkpoint, whose state and generators are the whole mesh's, so
a run resumes on any layout. The pipeline is off across processes. A
peer whose heartbeat stops past --peer-timeout is a PeerLost: the abort
faultEntry (`lostProc`), a final checkpoint from the snapshot on process
0, and the error propagates (cli.py exits 70 without teardown); any
other recoverable fault is agreed on first (Supervisor.agree_on_fault),
its records carrying `proc`, `agreed` and `decider`.

`--no-donate` changes nothing: no dispatch writes into its input state.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.obs import cost as obs_cost
from timetabling_ga_tpu_torch.obs import flight as obs_flight
from timetabling_ga_tpu_torch.obs import metrics as obs_metrics
from timetabling_ga_tpu_torch.obs import prof as obs_prof
from timetabling_ga_tpu_torch.obs import quality as obs_quality
from timetabling_ga_tpu_torch.obs.spans import NULL_TRACER, SpanTracer
from timetabling_ga_tpu_torch.ops import ga
from timetabling_ga_tpu_torch.parallel import comm, islands
from timetabling_ga_tpu_torch.problem import load_tim_file
from timetabling_ga_tpu_torch.runtime import checkpoint as ckpt
from timetabling_ga_tpu_torch.runtime import control_channel
from timetabling_ga_tpu_torch.runtime import dispatch_core as dcore
from timetabling_ga_tpu_torch.runtime import faults, jsonl, retry
from timetabling_ga_tpu_torch.runtime.config import RunConfig

INT_MAX = 2 ** 31 - 1
FEASIBLE_LIMIT = 1_000_000
# The longest a dispatch (or an LAHC chunk) is predicted to take, in
# seconds (JAX engine.py:296, the same variable and default): a fused
# dispatch is sized so sec_per_gen * gens stays under it. JAX also
# bounds n_epochs by what its precompile built (_MAX_EP_CACHE); the port
# compiles nothing per shape, so it has no such bound.
DISPATCH_CAP_S = float(os.environ.get("TT_DISPATCH_CAP_S", "30.0"))


def resolve_device(backend: str) -> torch.device:
    """The run's device: the current CUDA device for `gpu` (raising when
    there is none — never a silent CPU run), the host for `cpu`."""
    if backend == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--backend gpu: no CUDA device is visible "
                           "(pass --backend cpu to run on the host)")
    return torch.device("cuda", torch.cuda.current_device())


def run_shards(cfg: RunConfig) -> list:
    """This process's shards: its visible cards (the host for `cpu`),
    cut to its share of --islands when given (JAX engine.py:640-660
    takes jax.devices() the same way)."""
    resolve_device(cfg.backend)
    devices = islands.visible_devices(cfg.backend)
    if cfg.islands is not None:
        world = (cfg.num_processes if cfg.coordinator is not None
                 else int(os.environ.get("WORLD_SIZE", "1"))
                 if cfg.distributed else 1)
        devices = devices[:max(1, cfg.islands // max(1, world))]
    return devices


def maybe_init_distributed(cfg: RunConfig, devices) -> None:
    """The multi-process entry point (JAX engine.py:551; the role
    MPI_Init plays for the reference, ga.cpp:373-380), before any other
    device use. `--coordinator h:p --num-processes N --process-id i`
    starts a TCPStore at h:p that process 0 hosts, as it hosts JAX's
    coordinator; `--distributed` alone reads torch's env:// variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; a torchrun agent's
    store is joined, not hosted). The process group is built on that
    store (parallel/comm.py start: the backend decided once from the
    ranks' card ids, printed on stderr), its timeout --peer-timeout.
    Idempotent: a process joins one group for its life."""
    if comm.active().world > 1 or not (cfg.distributed or cfg.coordinator):
        return
    import datetime

    import torch.distributed as dist
    if cfg.coordinator is not None:
        host, _, port = cfg.coordinator.rpartition(":")
        rank, world, agent = cfg.process_id, cfg.num_processes, False
    else:
        host = os.environ["MASTER_ADDR"]
        port = os.environ["MASTER_PORT"]
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    # the store's own waits are the start-up rendezvous: processes
    # started by hand may be minutes apart, whatever --peer-timeout says
    # of a peer that was already running
    timeout = datetime.timedelta(seconds=max(300.0, cfg.peer_timeout))
    store = dist.TCPStore(host, int(port), world,
                          is_master=rank == 0 and not agent,
                          timeout=timeout)
    comm.start(store, rank, world, devices, cfg.backend == "cpu",
               cfg.peer_timeout)


def _sync_vals(*vals):
    """Schedule agreement across processes (JAX engine.py:337): every
    process must take the same dispatch decisions (chunk sizes, epoch
    counts, break or continue) or their collective sequences diverge
    near the -t boundary and the run deadlocks. Decisions computed from
    each process's own clock are replaced by process 0's, through the
    accord channel (process-0-wins on the store, off the device path),
    or under --no-accord by a broadcast from process 0. The identity in
    one process."""
    group = comm.active()
    if group.world > 1:
        ch = control_channel.active()
        if ch is not None:
            return tuple(int(v)
                         for v in ch.agree("s", [int(v) for v in vals]))
        return tuple(group.broadcast(vals))
    return tuple(int(v) for v in vals)


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
                      generation: int = None, first: int = 0):
    """One torch.Generator per island of islands [first, first + n),
    seeded from (seed, trial, island), or from (seed, trial, island,
    generation) when a resume reseeds: an island's stream depends on its
    global index alone, whichever shard or process holds it."""
    gens = []
    for island in range(first, first + n):
        words = [seed, trial, island] + (
            [] if generation is None else [generation])
        s = int(np.random.SeedSequence(words)
                .generate_state(1, dtype=np.uint64)[0] >> 1)
        g = torch.Generator(device=device)
        g.manual_seed(s)
        gens.append(g)
    return gens


def mesh_generators(mesh, seed: int, trial: int, L: int,
                    generation: int = None) -> list:
    """Each local shard's island generators, on its card, for the
    islands the shard holds (island_generators)."""
    return [island_generators(dev, seed, trial, L, generation,
                              first=(mesh.first_shard + s) * L)
            for s, dev in enumerate(mesh.devices)]


def generator_states(gens) -> np.ndarray:
    """(n, k) uint8: each island generator's state; for a mesh's
    generators (a list a shard) every island's, gathered from every
    process in island order."""
    if gens and isinstance(gens[0], list):
        local = np.stack([g.get_state().numpy() for sh in gens for g in sh])
        return comm.active().all_gather(local, 0)
    return np.stack([g.get_state().numpy() for g in gens])


def restore_generators(device, states) -> list:
    """Island generators on `device` set to the (L, n) uint8 `states`."""
    gens = [torch.Generator(device=device) for _ in range(len(states))]
    for g, st in zip(gens, states):
        g.set_state(torch.from_numpy(np.array(st)))
    return gens


def restore_mesh_generators(mesh, states) -> list:
    """A mesh's generators from every island's (N, k) `states`: each
    local shard takes its islands' rows onto its card."""
    return [restore_generators(dev, states[a:b])
            for (a, b), dev in zip(mesh.local_rows(len(states)),
                                   mesh.devices)]


def resume_generators(mesh, loaded: ckpt.Loaded, seed: int, trial: int,
                      n: int):
    """The island generators of a resumed try: restored from the
    checkpoint when it holds the states of all `n` islands from this
    device type (written on any layout), else reseeded from (seed,
    trial, island, generation) with a note."""
    dtype = mesh.devices[0].type
    if (loaded.generators is not None
            and loaded.generator_device == dtype
            and len(loaded.generators) == n):
        return restore_mesh_generators(mesh, loaded.generators)
    where = ("the JAX package" if loaded.generators is None
             else f"a {loaded.generator_device} device")
    print(f"note: checkpoint written by {where}; reseeding the "
          f"{dtype} island generators from (seed, trial, island, "
          f"generation {loaded.generation})", file=sys.stderr)
    return mesh_generators(mesh, seed, trial,
                           islands.local_islands(mesh, n), loaded.generation)


def record_quality(qrows) -> dict:
    """One dispatch's quality block into REGISTRY (JAX engine.py:
    1687-1699): counters take the dispatch's deltas, gauges its
    cross-island view. Returns the aggregate."""
    agg = obs_quality.aggregate(obs_quality.decode_rows(qrows))
    for name, v in agg["counters"].items():
        obs_metrics.REGISTRY.counter(name).inc(v)
    for name, v in agg["gauges"].items():
        obs_metrics.REGISTRY.gauge(name).set(v)
    return agg


def _set_moment_gauges(prefix: str, mom) -> None:
    """Gauges `<prefix>_{mean,min,max}` from (4, ...) float32 moment
    rows (mean, var, min, max), aggregated over their columns."""
    obs_metrics.REGISTRY.gauge(f"{prefix}_mean").set(float(mom[0].mean()))
    obs_metrics.REGISTRY.gauge(f"{prefix}_min").set(float(mom[2].min()))
    obs_metrics.REGISTRY.gauge(f"{prefix}_max").set(float(mom[3].max()))


def _moment_view(rows) -> np.ndarray:
    return np.ascontiguousarray(
        rows[:islands.TRACE_N_MOMENTS]).view(np.float32)


def _phase(out, enabled: bool, name: str, trial: int, seconds: float,
           **extra) -> None:
    if enabled:
        jsonl.phase_record(out, name, trial, seconds, **extra)


class _Try:
    """The mutable bookkeeping of one try: its clock, the per-island
    best floors and the logEntry emission. `best` is the control floor
    (phase switch, kick, checkpoint), which a recovery rewinds to its
    snapshot; `emitted` is the emission floor, which it never rewinds,
    so replayed improvements are not written twice (JAX best_seen and
    emitted)."""

    def __init__(self, out, cfg: RunConfig, trial: int, n_islands: int,
                 mesh):
        self.out = out
        self.cfg = cfg
        self.trial = trial
        self.n = n_islands
        self.mesh = mesh
        self.L = islands.local_islands(mesh, n_islands)
        self.t0 = time.monotonic()
        self.best = [INT_MAX] * n_islands
        self.emitted = [INT_MAX] * n_islands

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def remaining(self) -> float:
        return self.cfg.time_limit - self.elapsed()

    def observe(self, island: int, hcv: int, scv: int, t: float) -> None:
        rep = jsonl.reported_best(hcv, scv)
        if rep < self.best[island]:
            self.best[island] = rep
        if rep < self.emitted[island]:
            self.emitted[island] = rep
            jsonl.log_entry(self.out, island, 0, rep, t)

    def phase(self, name: str, seconds: float, **extra) -> None:
        _phase(self.out, self.cfg.trace, name, self.trial, seconds, **extra)


def _polish_chunks(tr: _Try, pa, gens, state, gacfg, name: str,
                   max_sweeps, sec_per_sweep, tracer=NULL_TRACER):
    """Budget-aware chunked polish (JAX engine.py:1074): chunks of up to
    4 converge passes while the pass budget lasts, the next chunk is
    predicted to fit the budget (x1.25), and the population's penalty
    sum keeps falling (two flat chunks end it under sideways
    acceptance, one without). Chunk sizes go through _sync_vals; the
    stats are every island's (the fetch gathers the mesh), so every
    process stops at the same chunk. `pa`, `gens` and `state` hold one
    item a local shard. Returns (state, sec_per_sweep)."""
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
        chunk, = _sync_vals(chunk)
        if chunk < 1:
            break
        tp0 = time.monotonic()
        faults.maybe_fail("dispatch")
        state, stats = dcore.program("polish", islands.mesh_polish)(
            tr.mesh, pa, gens, state, gacfg, chunk,
            tr.cfg.trace_mode == "stats")
        stats = dcore.fetch(stats, axis=1)
        tp1 = time.monotonic()
        tr.phase(name, tp1 - tp0, sweeps=chunk)
        tracer.record(name, tp0, tp1 - tp0, cat="device", sweeps=chunk)
        if stats.shape[0] > 3:
            # stats mode: row 3 the executed pass count, rows 4.. the
            # polished population's moments (JAX engine.py:1134-1156)
            obs_metrics.REGISTRY.gauge("engine.polish_passes").set(
                int(stats[3].max()))
            _set_moment_gauges("engine.polish_best", _moment_view(stats[4:]))
            stats = stats[:3]
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


def _lahc_loop(tr: _Try, pa, gens, state, post, cfg, tracer=NULL_TRACER):
    """The LAHC endgame (JAX engine.py:1185 _lahc_loop): the try's
    remaining budget in chunks of steps sized from the measured sec/step
    (a 256-step probe until there is one; the first chunk's timing, which
    carries the first launch's set-up, is not kept; chunk sizes agreed
    by _sync_vals), one (3, L) stats read a chunk feeding the logEntry
    stream and a `lahc` phase record. Returns each island's best
    snapshots, sorted, as the population."""
    mesh = tr.mesh
    lstate = dcore.program("lahc_init", islands.mesh_lahc_init)(
        mesh, pa, state, cfg.post_lahc)
    sec_per_step = None
    warm = False
    while True:
        remaining = tr.remaining()
        if sec_per_step is not None and sec_per_step > 0:
            n = int(min(remaining / 1.1, DISPATCH_CAP_S) / sec_per_step)
        else:
            n = 256 if remaining > 0 else 0
        n, = _sync_vals(n)
        if n < 1:
            break
        t0 = time.monotonic()
        faults.maybe_fail("dispatch")
        lstate, stats = dcore.program("lahc_run", islands.mesh_lahc_run)(
            mesh, pa, gens, lstate, post, n, cfg.post_lahc_k,
            cfg.trace_mode == "stats")
        stats = dcore.fetch(stats, axis=1)
        t1 = time.monotonic()
        if stats.shape[0] > 3:
            # stats mode: rows 3.. the walkers' moments per island (JAX
            # engine.py:1238-1251)
            _set_moment_gauges("engine.lahc_best", _moment_view(stats[3:]))
            stats = stats[:3]
        tr.phase("lahc", t1 - t0, steps=n)
        tracer.record("lahc", t0, t1 - t0, cat="device", steps=n)
        if warm:
            sps = (t1 - t0) / n
            sec_per_step = (sps if sec_per_step is None
                            else 0.7 * sps + 0.3 * sec_per_step)
        warm = True
        for i in range(tr.n):
            tr.observe(i, stats[1][i], stats[2][i], t1 - tr.t0)
    state = dcore.program("lahc_fin", islands.mesh_lahc_finalize)(
        mesh, lstate, tr.L)
    dcore.fetch([st.penalty for st in state])
    return state


def probe_sec_per_gen(mesh, pa, state, cfg: ga.GAConfig, L: int,
                      trace_mode: str = "full",
                      quality: bool = False) -> float:
    """Seconds of one generation of `cfg` (its ring migration included)
    on a clone of the mesh's `state` (one PopState a local shard), drawn
    from throwaway generators: the first sec/gen estimate, taken as the
    JAX engine takes it in precompile (timetabling_ga_tpu/runtime/
    engine.py:817-836), so that the run's state and generators do not
    advance and its first dispatch is a full one. It runs as the
    `dyn_runner` program, as JAX's first probe is its dynamic runner's
    one generation. It measures this process's own shards: their ring
    closes among them and no collective runs, so a peer still starting
    (its first launches) does not enter the estimate — an estimate of
    seconds a generation would cut the first epoch short, and a
    shortened epoch migrates early."""
    # every shard's throwaway generators on seeds 0..L-1: the probe's
    # draws are discarded with its clone, only its time is kept
    # tt-analyze: ignore[TT402]
    gens = [[torch.Generator(device=p.device).manual_seed(i)
             for i in range(L)] for p in pa]
    clone = [ga.PopState(*(x.clone() for x in st)) for st in state]
    local = islands.Mesh(mesh.devices, comm.SOLO)
    t0 = time.monotonic()
    _, trace, _ = dcore.program("dyn_runner", islands.mesh_run_epochs)(
        local, pa, gens, clone, cfg, 1, 1, trace_mode, quality)
    for t in trace:
        # the fence is the measurement: the probe's chunk is timed to
        # the card's end of it
        # tt-analyze: ignore[TT303]
        t.cpu()
    return time.monotonic() - t0


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1), JAX engine.py:145."""
    return 1 << (n.bit_length() - 1)


def _dispatch_size(cfg, remaining_gens: int, sec_per_gen, remaining_t,
                   scale: float = 1.0):
    """(n_epochs, gens_per_epoch) of the next dispatch, or None to stop
    the generation loop: when the budget is spent, when not one more
    generation is predicted to fit it, or when one generation is
    predicted over DISPATCH_CAP_S (the rest of the budget then goes to
    the tail polish). JAX engine.py:1988-2075, in its order: n_epochs a
    power of two, bounded so the dispatch is predicted under the cap;
    an epoch predicted over the cap shortened to the generations that
    fit (one epoch, migration closing it); a tail shorter than
    migration_period bounded by the cap too; then everything bounded by
    the remaining budget, a full-epoch count again a power of two. At a
    degradation-ladder `scale` below 1 the dispatch is one epoch of that
    share of its generations (JAX engine.py:2042-2051), before the
    budget bounds it."""
    spg = sec_per_gen if sec_per_gen is not None and sec_per_gen > 0 \
        else None
    if remaining_t <= 0 or (spg is not None and spg > DISPATCH_CAP_S):
        return None
    g = cfg.migration_period
    short = None                 # the generations of a shortened epoch
    if remaining_gens >= g:
        n_ep = _pow2_floor(max(1, min(cfg.epochs_per_dispatch,
                                      remaining_gens // g)))
        if spg is not None:
            fit_cap = int(DISPATCH_CAP_S / (spg * g))
            n_ep = max(1, min(n_ep, _pow2_floor(max(1, fit_cap))))
            if spg * g > DISPATCH_CAP_S:
                n_ep, short = 1, max(1, min(g, int(DISPATCH_CAP_S / spg)))
    else:
        n_ep, short = 1, remaining_gens
        if spg is not None:
            short = max(1, min(short, int(DISPATCH_CAP_S / spg)))
    if scale < 1.0:
        n_ep, short = 1, max(1, int((g if short is None else short)
                                    * scale))
    if spg is not None:
        g_fit = int(remaining_t / spg)
        if g_fit < 1:
            return None
        if short is not None:
            short = min(short, g_fit)
        elif g_fit // g < 1:
            n_ep, short = 1, min(g_fit, g)
        elif g_fit // g < n_ep:
            n_ep = _pow2_floor(g_fit // g)
    return (1, short) if short is not None else (n_ep, g)


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


def _ladder_mode(level: int) -> str:
    return ("pipelined" if level == 0 else "serial" if level == 1
            else f"chunk-1/{2 ** (level - 1)}")


def _mesh_arrays(problem, mesh) -> list:
    """The problem's arrays on each local shard's card (one copy a
    distinct device)."""
    by_dev = {}
    for d in mesh.devices:
        if d not in by_dev:
            by_dev[d] = problem.device_arrays(d)
    return [by_dev[d] for d in mesh.devices]


def _run_try(cfg, out, problem, mesh, trial: int, seed: int,
             n_islands: int, gacfg, post, fingerprint: str,
             tracer=NULL_TRACER, profiler=None) -> int:
    """One try: init (or the resumed checkpoint), polish, the generation
    loop with its checkpoints, tail polish and the final records, the
    loop supervised (module docstring), on every shard of `mesh`.
    Returns the try's best reported evaluation."""
    tr = _Try(out, cfg, trial, n_islands, mesh)
    L = tr.L
    group = comm.active()
    pa = _mesh_arrays(problem, mesh)
    gen_device = mesh.devices[0].type
    loaded = None
    if cfg.resume and cfg.checkpoint:
        loaded, seed = _resume(cfg, seed, fingerprint)
        # every process must take the same resume path: a checkpoint
        # visible to some processes only fails fast (JAX engine.py:1344)
        found = int(loaded is not None)
        agreed, = _sync_vals(found)
        if agreed != found:
            raise RuntimeError(
                "--resume: the checkpoint file is visible on some "
                "processes but not others — a multi-process resume needs "
                "the checkpoint on a filesystem all hosts share")
    sps = {}
    gens_done = 0
    host_loaded = None      # the resumed host state, the first snapshot
    if loaded is not None:
        gens = resume_generators(mesh, loaded, seed, trial, n_islands)
        host_loaded = loaded.state
        state = dcore.reshard_state(loaded.state, mesh)
        gens_done = loaded.generation
        if loaded.best_seen is not None:
            tr.best = [int(b) for b in loaded.best_seen]
        tr.emitted = list(tr.best)
    else:
        # the init before the first snapshot, retried on a transient
        # error: the same generators replay the same trajectory, and the
        # emitted floor keeps replayed polish bests off the stream (JAX
        # engine.py:1364-1438); no retry at --max-recoveries 0
        init_tries = 1 + (2 if cfg.max_recoveries > 0
                          and group.world == 1 else 0)
        for attempt in range(init_tries):
            try:
                t = time.monotonic()
                faults.maybe_fail("init")
                gens = mesh_generators(mesh, seed, trial, L)
                state = dcore.program("init", islands.mesh_init)(
                    mesh, pa, gens, cfg.pop_size)
                dcore.fetch([st.penalty for st in state])
                tr.phase("init", time.monotonic() - t)
                tracer.record("init", t, time.monotonic() - t,
                              cat="device")
                if gacfg.init_sweeps > 0:
                    state, sps[gacfg] = _polish_chunks(
                        tr, pa, gens, state, gacfg, "polish",
                        gacfg.init_sweeps, None, tracer)
                break
            except Exception as e:
                if attempt + 1 >= init_tries or not retry.is_transient(e):
                    raise
                jsonl.fault_entry(out, getattr(e, "tt_site", "init"),
                                  "recover", e, trial, attempt + 1, 0,
                                  tr.elapsed(), init=True)
                state = None
                pa = _mesh_arrays(problem, mesh)
    cur = gacfg
    sec_per_gen = None
    spg_of = {}             # the last sec/gen estimate of each config
    lahc_done = False

    def maybe_switch():
        nonlocal cur, state, sec_per_gen, lahc_done
        if cur is gacfg and post is not None and min(tr.best) < \
                FEASIBLE_LIMIT:
            cur = post
            if post.pop_size != gacfg.pop_size:
                state = dcore.program("shrink", islands.mesh_shrink)(
                    mesh, state, L, post.pop_size)
            if sec_per_gen is not None:
                # post generations cost about their LS-depth ratio more
                # (JAX engine.py:316 _spg_for)
                ratio = max(1.0, post.ls_sweeps / max(gacfg.ls_sweeps, 1))
                if gacfg.ls_hot_k > 0 and post.ls_hot_k == 0:
                    ratio *= 2.0
                sec_per_gen *= ratio * post.pop_size / gacfg.pop_size
                spg_of[cur] = sec_per_gen
            tr.phase("phase-switch", 0.0, at_gen=gens_done)
            if cfg.post_lahc > 0:
                # the endgame leaves the GA: the rest of the budget
                # belongs to the LAHC walkers
                state = _lahc_loop(tr, pa, gens, state, post, cfg, tracer)
                lahc_done = True

    maybe_switch()
    if (cfg.precompile and not lahc_done
            and gens_done < cfg.generations):
        # the first estimate, from the config the loop starts with (the
        # post one, shrunk, when the polish reached feasibility), outside
        # the try's clock; --no-precompile skips it
        t = time.monotonic()
        sec_per_gen = spg_of[cur] = probe_sec_per_gen(
            mesh, pa, state, cur, L, cfg.trace_mode, cfg.quality)
        tr.t0 += time.monotonic() - t
    kick_stall, kick_best, kick_streak = 0, min(tr.best), 0
    # the stall detector, fed once a dispatch (JAX engine.py:1469-1478)
    stall_det = (obs_quality.StallDetector(cfg.stall_window,
                                           cfg.stall_hamming)
                 if cfg.quality and cfg.stall_window > 0 else None)
    obs_metrics.REGISTRY.gauge("engine.stalled").set(0.0)

    # the run supervisor and its first snapshot (JAX engine.py:1491-1513)
    sup = dcore.Supervisor(cfg)
    obs_metrics.REGISTRY.gauge("engine.degrade_level").set(sup.level)
    obs_metrics.REGISTRY.gauge("engine.recovery_budget_configured").set(
        cfg.max_recoveries)
    obs_metrics.REGISTRY.gauge("engine.recovery_budget_remaining").set(
        cfg.max_recoveries)
    if sup.enabled:
        host0 = (host_loaded
                 if host_loaded is not None and cur is gacfg
                 and not lahc_done else dcore.fetch_state(state))
        sup.snapshot(state=host0, generators=generator_states(gens),
                     gens_done=gens_done, epochs_done=0, epochs_at_ckpt=0,
                     best_seen=list(tr.best),
                     post=post is not None and cur is post,
                     kick=(kick_stall, kick_best, kick_streak),
                     lahc_done=lahc_done)

    def dispatch_kick() -> int:
        """The kick, shared by the post phase's stall kick and the
        quality auto-kick (JAX engine.py:1744-1776 _dispatch_kick):
        reseed each island's worst half from its best at the escalating
        depth, record, count. Returns the depth."""
        nonlocal state, kick_streak
        n_moves = min(3 << kick_streak, islands.KICK_MAX_MOVES)
        t = time.monotonic()
        faults.maybe_fail("dispatch")
        state = dcore.program("kick", islands.mesh_kick)(
            mesh, pa, gens, state, cur, n_moves)
        dcore.fetch([st.penalty for st in state])
        tr.phase("kick", time.monotonic() - t, at_gen=gens_done,
                 moves=n_moves)
        tracer.record("kick", t, time.monotonic() - t, cat="device",
                      moves=n_moves)
        obs_metrics.REGISTRY.counter("engine.kicks").inc()
        kick_streak += 1
        return n_moves

    def save_checkpoint(host_state, gen_states, gens_at, best) -> None:
        # process 0 writes (JAX engine.py:1892): the state and the
        # generators are the whole mesh's on every process
        if group.rank != 0:
            return
        ckpt.save(cfg.checkpoint, host_state,
                  ckpt.key_words(seed, trial, gens_at), gens_at,
                  fingerprint, list(best), seed, gen_states, gen_device)

    # the pipeline runs only where no control read falls between
    # dispatches, not across processes (a gather must not interleave
    # with the next dispatch's collectives, and two processes' clocks
    # could size it apart near -t), and not under --trace-profile, whose
    # capture must enclose exactly one dispatch (JAX engine.py:1534-1539)
    pipelined_cfg = bool(cfg.pipeline and post is None
                         and group.world == 1
                         and cfg.trace_profile is None
                         and not (cfg.quality and cfg.auto_kick_on_stall))
    profiled = False       # this try's --trace-profile capture taken
    open_prof = [None]     # a --trace-profile capture not stopped yet
    ev_mode = islands.effective_trace_mode(cfg.trace_mode, cfg.quality)
    time_stopped = False
    n_dispatch = 0
    epochs_done = epochs_at_ckpt = 0
    overflow_warned = False
    last_fence = None      # host time of the previous chunk's fence
    host_gap_s = 0.0       # card-idle time between chunks
    t_loop = time.monotonic()

    def process(chunk, inflight=None):
        """Retire one chunk (JAX engine.py:1548-1933 _process): read its
        trace, emit its telemetry, update the sec/gen estimate, then the
        control checks (phase switch, kick, stall, checkpoint). Serial
        mode calls it right after the chunk's dispatch; pipelined mode
        with the next chunk already enqueued, passed as `inflight`."""
        nonlocal state, cur, sec_per_gen, lahc_done, kick_stall
        nonlocal kick_best, kick_streak, epochs_at_ckpt, last_fence
        nonlocal host_gap_s, overflow_warned, profiled
        td0, n_ep, gens_run, tcopy, flow, tprof, chunk_cost, ticket = \
            chunk
        tf0 = time.monotonic()
        trace = dcore.fetch(tcopy, tracer=tracer, flow=flow or None)
        td1 = time.monotonic()
        tracer.record("fetch", tf0, td1 - tf0, cat="engine", gens=gens_run,
                      flow=flow)
        if tprof is not None:
            # the --trace-profile capture ends at the chunk's fetch
            # (JAX engine.py:1568-1573)
            open_prof[0] = None
            tprof.stop()
            profiled = True
            _phase(out, True, "profile", trial, td1 - td0,
                   dir=cfg.trace_profile)
        # when the chunk started on the card: at its enqueue when serial,
        # at the previous fence when pipelined (JAX engine.py:1573-1592)
        t_start = (last_fence if pipe.enabled and last_fence is not None
                   else td0)
        dt = td1 - t_start
        if last_fence is not None:
            host_gap_s += max(0.0, td0 - last_fence)
        last_fence = td1
        tr.phase("dispatch", dt, epochs=n_ep, gens=gens_run)
        tracer.record("dispatch", t_start, dt, cat="device", epochs=n_ep,
                      gens=gens_run, flow=flow)
        mreg = obs_metrics.REGISTRY
        mreg.counter("engine.dispatches").inc()
        mreg.counter("engine.gens").inc(gens_run)
        # the exemplar joins a latency spike back to its dispatch ordinal
        mreg.histogram("engine.dispatch_seconds").observe(
            dt, exemplar={"dispatch": str(n_dispatch)})
        if dt > 0:
            mreg.gauge("engine.gens_per_sec").set(gens_run / dt)
        # the live roofline: the chunk's counted work over its wall
        obs_cost.set_live_roofline(chunk_cost, dt)
        loop_s = td1 - t_loop
        if loop_s > 0:
            mreg.gauge("engine.device_busy_frac").set(
                max(0.0, 1.0 - host_gap_s / loop_s))
        if gens_done > 0:
            mreg.gauge("engine.host_gap_ms_per_gen").set(
                1e3 * host_gap_s / gens_done)
        spg = dt / gens_run
        sec_per_gen = spg_of[cur] = spg if sec_per_gen is None else (
            0.7 * spg + 0.3 * sec_per_gen)
        events, moments, qrows, overflow_warned = \
            dcore.decode_telemetry(
                trace, cfg.quality, cfg.trace_mode, metrics=mreg,
                overflow_counter="engine.trace_delta_overflow",
                overflow_warned=overflow_warned)
        for i in range(n_islands):
            for gi, h, sc in events[i]:
                tr.observe(i, h, sc, (t_start - tr.t0)
                           + (gi + 1) / gens_run * (td1 - t_start))
        if moments is not None:
            # the per-generation best's moments, across islands (JAX
            # engine.py:1676-1684)
            _set_moment_gauges("engine.trace_best", moments.T)
        q_agg = None
        if qrows is not None:
            q_agg = record_quality(qrows)
            if cfg.obs:
                jsonl.quality_entry(out, obs_quality.entry_payload(q_agg),
                                    ts=tracer.now(), dispatch=n_dispatch)
        tracer.record("process", td1, time.monotonic() - td1,
                      cat="engine", gens=gens_run, flow=flow)
        if profiler is not None:
            # tick the on-demand capture (a lock-guarded counter: the
            # profiler's start and stop happen on its worker)
            profiler.on_dispatch(ticket)
        if (cfg.obs and cfg.metrics_every > 0
                and n_dispatch % cfg.metrics_every == 0):
            jsonl.metrics_entry(out, mreg.snapshot(), ts=tracer.now())
        maybe_switch()
        if lahc_done:
            return
        if cur is post and cfg.kick_stall > 0 and cur.pop_size >= 2:
            nb = min(tr.best)
            if nb < kick_best:
                kick_stall = kick_streak = 0
            else:
                kick_stall += 1
            kick_best = nb
            # the budget check reads this process's clock: the launch
            # is agreed (JAX engine.py:1797-1806)
            do_kick, = _sync_vals(kick_stall >= cfg.kick_stall
                                  and tr.remaining() > 0)
            if do_kick:
                dispatch_kick()
                kick_stall = 0
        if stall_det is not None and q_agg is not None:
            # a plateau of stall_window dispatches with the most-collapsed
            # island's Hamming sample at or below stall_hamming (JAX
            # engine.py:1809-1845)
            hmin = q_agg["gauges"]["quality.diversity.hamming_min"]
            was_stalled = stall_det.stalled
            stalled = stall_det.update(min(tr.best), hmin)
            mreg.gauge("engine.stalled").set(1.0 if stalled else 0.0)
            if stalled and not was_stalled:
                jsonl.fault_entry(
                    out, "quality", "stall",
                    f"no new best for {stall_det.streak} dispatches with "
                    f"diversity {hmin:.4f} <= {cfg.stall_hamming}",
                    trial, sup.recoveries, sup.level, tr.elapsed(),
                    streak=stall_det.streak, hamming=round(hmin, 6))
            if (stalled and cfg.auto_kick_on_stall and cur.pop_size >= 2
                    and _sync_vals(tr.remaining() > 0)[0]):
                n_moves = dispatch_kick()
                jsonl.fault_entry(out, "quality", "kick", "stall auto-kick",
                                  trial, sup.recoveries, sup.level,
                                  tr.elapsed(), moves=n_moves)
                stall_det.reset()
                obs_metrics.REGISTRY.gauge("engine.stalled").set(0.0)
        if (cfg.checkpoint
                and epochs_done - epochs_at_ckpt >= cfg.checkpoint_every):
            # the state, generators and gens_done cover the in-flight
            # chunk when pipelined (the read below waits for it); its
            # improvements are folded into the saved floor only, so they
            # still emit when it retires (JAX engine.py:1846-1933)
            t = time.monotonic()
            host_state = dcore.fetch_state(state)
            gen_states = generator_states(gens)
            bs = list(tr.best)
            tr_fold = None
            if inflight is not None:
                tr_fold, _ = islands.split_quality(
                    dcore.fetch(inflight.trace), cfg.quality)
                for i, evs in enumerate(
                        islands.trace_events(tr_fold, ev_mode)[0]):
                    for _g, h, sc in evs:
                        bs[i] = min(bs[i], jsonl.reported_best(h, sc))
            ck_flow = tracer.new_flow()
            job = (lambda hs=host_state, gs=gen_states, gd=gens_done,
                   b=bs: save_checkpoint(hs, gs, gd, b))
            submit = getattr(out, "submit", None)
            if submit is not None:
                # on the writer's thread, in order; its span shares the
                # checkpoint's flow, the enqueue -> write hand-off
                def ckpt_job(job=job, f=ck_flow, gd=gens_done):
                    with tracer.span("ckpt-write", cat="writer", flow=f,
                                     gens=gd):
                        job()
                submit(ckpt_job)
            else:
                job()
            epochs_at_ckpt = epochs_done
            sup.snapshot(state=host_state, generators=gen_states,
                         gens_done=gens_done, epochs_done=epochs_done,
                         epochs_at_ckpt=epochs_done, best_seen=bs,
                         post=post is not None and cur is post,
                         kick=(kick_stall, kick_best, kick_streak),
                         inflight_trace=tr_fold)
            tr.phase("checkpoint", time.monotonic() - t)
            tracer.record("checkpoint", t, time.monotonic() - t,
                          cat="engine", gens=gens_done, flow=ck_flow)
            obs_metrics.REGISTRY.counter("engine.checkpoints").inc()

    pipe = dcore.DispatchPipeline(process, enabled=pipelined_cfg)
    while True:
        try:
            while not lahc_done and gens_done < cfg.generations:
                if (sup.enabled and sup.level > 0
                        and sup.maybe_relax(time.monotonic())):
                    obs_metrics.REGISTRY.gauge("engine.degrade_level").set(
                        sup.level)
                    jsonl.fault_entry(out, "run", "restore",
                                      "clean stretch", trial,
                                      sup.recoveries, sup.level,
                                      tr.elapsed(),
                                      mode=_ladder_mode(sup.level))
                    if sup.level < 1:
                        pipe.enabled = pipelined_cfg
                if pipe.pending is not None and sec_per_gen is None:
                    # no estimate for the chunk in flight: retire it
                    # before enqueueing another unmeasured one
                    pipe.drain()
                remaining_t = tr.remaining()
                if pipe.pending is not None and sec_per_gen is not None:
                    # the in-flight chunk spends budget the clock has not
                    # charged yet
                    remaining_t -= sec_per_gen * pipe.pending.gens_run
                size = _dispatch_size(cfg, cfg.generations - gens_done,
                                      sec_per_gen, remaining_t,
                                      sup.dispatch_scale())
                # the schedule read from this process's clock is agreed
                # (JAX engine.py:2075-2081)
                stop, n_ep, g = _sync_vals(size is None,
                                           *(size or (0, 0)))
                if stop:
                    time_stopped = True
                    break
                faults.maybe_fail("dispatch")
                # --trace-profile: one warm dispatch a try (a measured
                # sec/gen says this shape has run), on this thread
                tprof = None
                if (cfg.trace_profile is not None and not profiled
                        and sec_per_gen is not None):
                    tprof = open_prof[0] = obs_prof.TorchProfiler(
                        mesh.devices[0])
                    tprof.start(cfg.trace_profile)
                # one flow a chunk: its dispatch, fetch-read (the
                # watchdog thread) and process spans form one chain
                flow_id = tracer.new_flow()
                # full epochs run as `runner`, a shortened dispatch as
                # `dyn_runner` (JAX's static and dynamic runners)
                runner = dcore.program(
                    "runner" if g >= cfg.migration_period
                    else "dyn_runner", islands.mesh_run_epochs)
                ticket = (profiler.on_enqueue() if profiler is not None
                          else None)
                td0 = time.monotonic()
                # the global best (JAX's pmin output) is not read here
                state, trace, _ = runner(mesh, pa, gens, state, cur, n_ep,
                                         g, cfg.trace_mode, cfg.quality)
                # the trace starts for the host now; its reader waits
                # on these copies alone
                tcopy = dcore.host_copies(trace)
                gens_done += n_ep * g
                epochs_done += n_ep
                n_dispatch += 1
                # a call that counted as a compile carries no cost: its
                # wall may hold the kernels' build
                pipe.submit(dcore.Chunk(
                    td0, n_ep, n_ep * g, tcopy, flow_id, tprof,
                    None if getattr(runner, "last_compiled", False)
                    else getattr(runner, "last_cost", None), ticket))
            pipe.drain()
            if profiler is not None:
                # a capture waiting for chunks launched after its start
                # ends with the loop
                profiler.flush()
            tr.phase("gen-loop", time.monotonic() - t_loop,
                     dispatches=n_dispatch, pipelined=pipe.enabled)

            # budget-tail polish: the slice too short for one more
            # generation goes to sweep passes, when a measured sec/sweep
            # says one fits
            if time_stopped and sps.get(cur):
                state, _ = _polish_chunks(tr, pa, gens, state, cur,
                                          "tail-polish", None, sps[cur],
                                          tracer)
            t = time.monotonic()
            slots, rooms, hcv, scv = dcore.fetch_final(state, n_islands,
                                                       cur.pop_size)
            tr.phase("fetch", time.monotonic() - t)
            tracer.record("fetch", t, time.monotonic() - t, cat="engine",
                          endTry=True)
            break
        except control_channel.PeerLost as e:
            # a peer process is gone (its heartbeat silent past
            # --peer-timeout): nothing brings it back and the next
            # collective would wait for it forever. The abort record, a
            # final durable checkpoint from the snapshot (process 0: its
            # state is the whole mesh's, so the rerun resumes on any
            # layout), and the error propagates (JAX engine.py:2190)
            jsonl.fault_entry(out, "accord", "abort", e, trial,
                              sup.recoveries, sup.level, tr.elapsed(),
                              proc=group.rank, agreed=False,
                              lostProc=e.proc)
            if cfg.checkpoint and sup.snap is not None:
                snap = sup.snap
                try:
                    save_checkpoint(snap.state, snap.generators,
                                    snap.gens_done, snap.best_seen)
                except Exception as e3:
                    print(f"warning: final abort checkpoint failed: "
                          f"{e3}", file=sys.stderr)
            raise
        except Exception as e:
            site = sup.classify(e)
            if site is None:
                raise
            now = time.monotonic()
            # before any process leaves the collective program order, all
            # adopt one verdict over the control channel: the process
            # that saw the real error gives its site, one that only saw
            # the fault flag defers, an exhausted budget anywhere forces
            # the abort (JAX engine.py:2219-2239). One process: skipped,
            # the stream unchanged
            agreed = None
            ch = control_channel.active()
            if group.world > 1 and ch is not None:
                agreed = sup.agree_on_fault(ch, site, e)
                site = agreed.get("site") or site
            acc = ({} if agreed is None else
                   {"proc": group.rank, "agreed": True,
                    "decider": agreed["decider"]})
            sup.recoveries += 1
            obs_metrics.REGISTRY.gauge("engine.recovery_budget_remaining").set(
                max(0, cfg.max_recoveries - sup.recoveries))
            if (sup.recoveries > cfg.max_recoveries
                    or (agreed is not None
                        and agreed.get("action") == "abort")):
                # the budget is spent (here, or on any process): the
                # abort record, a final durable checkpoint from the
                # snapshot, and the error propagates
                jsonl.fault_entry(out, site, "abort", e, trial,
                                  sup.recoveries - 1, sup.level,
                                  now - tr.t0, **acc)
                if cfg.checkpoint:
                    snap = sup.snap
                    try:
                        save_checkpoint(snap.state, snap.generators,
                                        snap.gens_done, snap.best_seen)
                    except Exception as e3:
                        print(f"warning: final abort checkpoint failed: "
                              f"{e3}", file=sys.stderr)
                raise
            obs_metrics.REGISTRY.counter("engine.recoveries").inc()
            t_rec = time.monotonic()
            if open_prof[0] is not None:
                # the failed chunk's capture is dropped unwritten; the
                # replay takes it again
                open_prof[0].abandon()
                open_prof[0] = None
            snap = sup.snap
            if (agreed is not None and int(agreed.get("gens", -1)) >= 0
                    and int(agreed["gens"]) != snap.gens_done):
                # snapshots are taken at shared fences: an agreed resume
                # point other than this process's means the fences
                # diverged, and resuming would corrupt the collectives
                raise RuntimeError(
                    f"accord: agreed resume generation {agreed['gens']} "
                    f"!= this process's snapshot generation "
                    f"{snap.gens_done} — diverged snapshots; refusing to "
                    f"resume") from e
            jsonl.fault_entry(out, site, "recover", e, trial,
                              sup.recoveries, sup.level, now - tr.t0,
                              lostGens=max(0, gens_done - snap.gens_done),
                              **acc)
            if sup.escalate(now):
                obs_metrics.REGISTRY.gauge("engine.degrade_level").set(
                    sup.level)
                jsonl.fault_entry(out, site, "degrade", e, trial,
                                  sup.recoveries, sup.level, now - tr.t0,
                                  mode=_ladder_mode(sup.level))
            if sup.level >= 1:
                pipe.enabled = False
            # whatever the failed dispatch left on the card is dropped:
            # the problem is placed again and the snapshot re-placed on
            # the same device (no program purge: see dispatch_core)
            pipe.abandon()
            state = None
            pa = _mesh_arrays(problem, mesh)
            try:
                state = dcore.reshard_state(snap.state, mesh)
                dcore.fetch([st.penalty for st in state])
            except Exception as e2:
                if not cfg.checkpoint:
                    raise
                print(f"warning: snapshot rehydration failed "
                      f"({str(e2)[:120]}); falling back to the durable "
                      f"checkpoint", file=sys.stderr)
                ld = ckpt.load(cfg.checkpoint, fingerprint)
                b2 = (ld.best_seen if ld.best_seen is not None
                      else [INT_MAX] * n_islands)
                mp = max(1, cfg.migration_period)
                snap = sup.snap = dcore.Snapshot(
                    state=ld.state,
                    generators=generator_states(resume_generators(
                        mesh, ld, seed, trial, n_islands)),
                    gens_done=ld.generation,
                    epochs_done=ld.generation // mp,
                    epochs_at_ckpt=ld.generation // mp,
                    best_seen=list(b2),
                    post=post is not None and min(b2) < FEASIBLE_LIMIT,
                    kick=(0, min(b2), 0))
                state = dcore.reshard_state(snap.state, mesh)
                dcore.fetch([st.penalty for st in state])
            # the control state as of the snapshot: replayed decisions
            # land at the generations an uninjected run's do
            gens = restore_mesh_generators(mesh, snap.generators)
            gens_done = snap.gens_done
            epochs_done = snap.epochs_done
            epochs_at_ckpt = snap.epochs_at_ckpt
            tr.best[:] = list(snap.best_seen)
            cur = post if snap.post else gacfg
            sec_per_gen = spg_of.get(cur, sec_per_gen)
            kick_stall, kick_best, kick_streak = snap.kick
            lahc_done = snap.lahc_done
            time_stopped = False
            last_fence = None
            if snap.inflight_trace is not None:
                # the chunk in flight at the snapshot's fence: its
                # improvements were never emitted
                tnow = tr.elapsed()
                for i, evs in enumerate(islands.trace_events(
                        snap.inflight_trace, ev_mode)[0]):
                    for _g, h, sc in evs:
                        tr.observe(i, h, sc, tnow)
            tracer.record("recover", t_rec, time.monotonic() - t_rec,
                          cat="engine", site=site, level=sup.level)

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
    if cfg.obs:
        # the try's last metricsEntry holds its final counters
        jsonl.metrics_entry(out, obs_metrics.REGISTRY.snapshot(),
                            ts=tracer.now())
    return trial_best


def run(cfg: RunConfig, out=None, devices=None) -> int:
    """Execute the configured run; emit the JSONL protocol on `out` (or
    -o, or stdout) through an AsyncWriter, drained before this returns
    or raises. Returns the best reported evaluation. `devices` (the
    programmatic mesh: a list of torch devices, which may repeat one)
    replaces the visible cards as this process's shards. In a run split
    over processes only process 0 writes the stream: the others write
    into a buffer and never open -o (JAX engine.py:927)."""
    if devices is None:
        devices = run_shards(cfg)
    maybe_init_distributed(cfg, devices)
    group = comm.active()
    mesh = islands.Mesh(devices, group)
    device = mesh.devices[0]
    dcore.set_fetch_timeout(cfg.fetch_timeout)
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
    # the fault plan, its counters reset for this run; the process's
    # coordinates first, since `site@proc` scoping filters at parse
    faults.set_process(group.rank, group.world)
    faults.install(faults.active_spec(cfg.faults))
    # the accord control channel of this run (a no-op object in one
    # process), installed for the guards of the collectives
    channel = control_channel.install(
        control_channel.open_channel(cfg.accord, cfg.peer_timeout))
    close_out = False
    writer = None
    obs_srv = mem_poller = hist_ring = flight = prof_cap = None
    try:
        if group.rank != 0:
            import io
            out = io.StringIO()
        elif out is None:
            if cfg.output:
                out = open(cfg.output, "w")
                close_out = True
            else:
                out = sys.stdout
        # the history ring samples the registry on its own thread under
        # any obs surface; the flight recorder tees the record stream
        # (on the writer thread) and dumps bundles from its own thread
        # (JAX engine.py:954-966). The stream is the same either way.
        hist_ring, flight, sink = obs_flight.wire(cfg, out,
                                                  process="engine")
        writer = jsonl.AsyncWriter(sink)
        # the tracer emits through the same writer; the writer's pull
        # gauges re-bind to this run's writer
        tracer = SpanTracer(writer, enabled=cfg.obs)
        if flight is not None:
            flight.bind_tracer(tracer)
            flight.start()
        reg = obs_metrics.REGISTRY
        reg.gauge_fn("writer.queue_depth", writer.qsize)
        reg.gauge_fn("writer.records", lambda: writer.records_written)
        # the cost observatory's costEntry records go through this run's
        # writer under --obs only (a timing record either way)
        obs_cost.OBSERVATORY.bind(writer if cfg.obs else None,
                                  now=tracer.now)
        if (cfg.obs or cfg.obs_listen) and cfg.mem_poll_every > 0:
            # the device.mem_* gauges, sampled off the dispatch path
            mem_poller = obs_cost.MemPoller(
                obs_cost.torch_memory_stats_fn(device),
                cfg.mem_poll_every).start()
        if cfg.profile_for > 0 or cfg.obs_listen:
            # the on-demand capture, driven from its own worker thread;
            # finished captures attribute themselves there (gauges, and
            # the profEntry under --obs)
            tp = obs_prof.TorchProfiler(device, all_threads=True)
            prof_cap = obs_cost.ProfileCapture(tp.start, tp.stop,
                                               default_dir=cfg.profile_dir)
            prof_cap.on_complete = obs_prof.capture_hook(
                writer if cfg.obs else None, now=tracer.now)
            if cfg.profile_for > 0:
                prof_cap.trigger(cfg.profile_for)
        if cfg.obs_listen:
            # the pull front: /metrics, /healthz (this run's writer
            # thread), /readyz, /metrics/history, /profile; it writes no
            # records
            from timetabling_ga_tpu_torch.obs import http as obs_http
            obs_srv = obs_http.ObsServer(
                cfg.obs_listen,
                probes={"process": lambda: True, "writer": writer.alive},
                profile=prof_cap, history=hist_ring).start()
        try:
            best = _run_tries(cfg, writer, mesh, tracer, prof_cap)
        except BaseException:
            writer.close(raise_error=False)
            raise
        writer.close()
        return best
    finally:
        # JAX's order: the listener first (no handler may race a closing
        # ring), the capture, the poller, then the recorder and the ring
        # before the fault plan is uninstalled
        if obs_srv is not None:
            obs_srv.close()
        if prof_cap is not None:
            prof_cap.close()
        if mem_poller is not None:
            mem_poller.close()
        if flight is not None:
            flight.close()
        if hist_ring is not None:
            hist_ring.close()
        # the global must not hold this run's writer
        obs_cost.OBSERVATORY.unbind()
        if writer is not None:
            # the registry must not keep this run's writer alive
            obs_metrics.REGISTRY.freeze("writer.records",
                                        writer.records_written)
            obs_metrics.REGISTRY.freeze("writer.queue_depth", 0.0)
        # the heartbeat stops and the channel is cleared: later work in
        # this process must not guard through a closed channel
        if channel is not None:
            channel.close()
        control_channel.install(None)
        faults.install(None)
        if close_out:
            out.close()


def _run_tries(cfg: RunConfig, out, mesh, tracer=NULL_TRACER,
               profiler=None) -> int:
    t0 = time.monotonic()
    problem = load_tim_file(cfg.input)
    if cfg.auto_tune:
        cfg.apply_tuned_defaults(problem.n_events)
    # --islands defaults to every shard of the mesh (JAX: every device),
    # and is rounded down to a multiple of the shard count
    n_shards = mesh.n_shards
    n_islands = cfg.islands if cfg.islands is not None else n_shards
    if n_islands % n_shards:
        down = max(n_shards, (n_islands // n_shards) * n_shards)
        print(f"warning: {n_islands} islands is not a multiple of "
              f"{n_shards} devices; using {down}", file=sys.stderr)
        n_islands = down
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
        best = min(best, _run_try(cfg, out, problem, mesh, trial, seed,
                                  n_islands, gacfg, post, fingerprint,
                                  tracer, profiler))
    return best
