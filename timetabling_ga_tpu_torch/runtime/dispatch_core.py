"""The dispatch core (port of timetabling_ga_tpu/runtime/
dispatch_core.py:109-200, 202-341, 344-560): the pieces the engine's
run loop, the serve scheduler and the fleet replica share.

    place_state   a host (numpy) PopState onto one device, a copy per
                  field
    reshard_state a host (numpy) global PopState onto an island mesh:
                  each local shard's rows onto its card (JAX
                  `reshard_state`, :349-357)
    state_nbytes  bytes a PopState moves across the host boundary when
                  parked or placed: the unit of `serve.park_bytes` and
                  `serve.resume_bytes`
    HostCopy      a device tensor's copy to the host, started without a
                  fence (JAX's copy_to_host_async)
    fetch         the control-fence host read, on a watchdog thread
                  under the `--fetch-timeout` deadline, with the `fetch`
                  fault site inside it; given a tracer and a flow id,
                  the watchdog thread's read is a `fetch-read` span on
                  the dispatch's flow. A mesh value (one tensor a local
                  shard) is joined along its island axis and, in a run
                  split over processes, gathered from every rank behind
                  the accord guard, so every rank sees the whole result
                  (JAX :404-429); telemetry (fetch_leaf) stays local
    fetch_leaf    a telemetry leaf to the host: never a control fence,
                  never injected, never under the deadline
    fetch_state   a PopState to the host in one control-fence read
    fetch_final   the try's last read: slots, rooms and each island's
                  best row's (hcv, scv), in one control-fence read
    decode_telemetry  a fetched trace leaf's events, moments and quality
                  rows, dropped improvement events counted (JAX :520)
    Chunk / DispatchPipeline  the depth-2 dispatch pipeline: at most one
                  chunk in flight, retired with the next one enqueued
    Snapshot / Supervisor     the rolling host snapshot and the
                  recovery policy (classify, budget, degradation ladder)
    CommandFence  the fleet replica's command inbox, drained by its drive
                  loop between quanta

JAX's `purge_programs` has no counterpart: the port compiles nothing
per shape, so after a fault there is no compiled program bound to
poisoned state to drop; the kernel libraries stay loaded. Nothing here
runs at import or needs a card.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import torch

from timetabling_ga_tpu_torch.obs import cost as obs_cost
from timetabling_ga_tpu_torch.obs.spans import NULL_TRACER
from timetabling_ga_tpu_torch.ops import ga
from timetabling_ga_tpu_torch.parallel import comm, islands
from timetabling_ga_tpu_torch.runtime import faults
from timetabling_ga_tpu_torch.runtime import retry


# one dispatched chunk not yet retired: its start on the host clock,
# epochs, generations, its trace's HostCopy, its flow id (obs/spans.py
# new_flow: its dispatch, fetch-read and process spans form one chain),
# the --trace-profile capture to stop at its fetch (or None) and its
# program call's counted work for the live roofline (obs/cost.py; None
# on a call that counted as a compile), and its on-demand capture
# ticket (obs/cost.py ProfileCapture.on_enqueue; None without one)
Chunk = collections.namedtuple("Chunk",
                               "td0 n_ep gens_run trace flow prof cost "
                               "ticket",
                               defaults=(None, None, None))

# the programs under the cost observatory (obs/cost.py instrument), one
# proxy a name for the process, as JAX's program caches are
PROGRAMS: dict = {}


def program(name: str, fn):
    """`fn` as the cost observatory's program `name` (JAX's names:
    runner, dyn_runner, init, polish, kick, shrink, lahc_init, lahc_run,
    lahc_fin, lane_runner, lane_init); `fn` itself under TT_COST_OBS=0.
    A proxy is made again when `fn` is not the one it wraps."""
    p = PROGRAMS.get(name)
    if p is None or getattr(p, "_fn", p) is not fn:
        # keyed by name alone: the check above rebuilds the proxy when
        # `fn` is not the one it wraps
        # tt-analyze: ignore[TT202]
        p = PROGRAMS[name] = obs_cost.instrument(fn, name)
    return p


class DispatchPipeline:
    """Depth-2 dispatch pipeline (JAX dispatch_core.py:121): at most one
    chunk in flight; submitting chunk N+1 retires chunk N with N+1
    already enqueued on the card, so N's telemetry is read and processed
    while N+1 runs. `enabled` may change mid-run (the supervisor's
    degradation ladder serializes the loop); it changes when chunks
    retire, never what is dispatched, so serial and pipelined runs give
    the same records under strip_timing."""

    def __init__(self, process, enabled: bool):
        self.process = process       # process(chunk, inflight=None)
        self.enabled = enabled
        self.pending = None          # the one in-flight chunk

    def submit(self, chunk) -> None:
        """Pipelined: park `chunk` and retire its predecessor (which
        `process` sees with `chunk` as `inflight`); serial: retire it."""
        if self.enabled:
            if self.pending is not None:
                self.process(self.pending, inflight=chunk)
            self.pending = chunk
        else:
            self.process(chunk)

    def drain(self) -> None:
        """Retire the in-flight chunk, if any."""
        if self.pending is not None:
            self.process(self.pending)
            self.pending = None

    def abandon(self):
        """Forget the in-flight chunk without retiring it (recovery) and
        return it."""
        chunk, self.pending = self.pending, None
        return chunk


class CommandFence:
    """Unbounded command inbox drained at control fences: the fleet
    replica's drive loop (fleet/replicas.py) is the only thread that
    touches the card, and HTTP handlers, signal flags and tests
    reach it by enqueueing commands, which the loop takes only between
    quanta (every job at a park fence), never during one. `poll` is the
    busy tick; `wait` the idle one, bounded so the loop still sees its
    drain and kill flags promptly."""

    def __init__(self):
        import queue
        self._q = queue.Queue()
        self._empty = queue.Empty

    def put(self, cmd) -> None:
        self._q.put(cmd)

    def poll(self):
        """The next queued command, or None at once when there is none
        (the loop goes on to dispatch)."""
        try:
            return self._q.get_nowait()
        except self._empty:
            return None

    def wait(self, timeout: float):
        """Block up to `timeout` seconds for a command; None when none
        came (the loop re-checks its flags either way)."""
        try:
            return self._q.get(timeout=timeout)
        except self._empty:
            return None


@dataclasses.dataclass
class Snapshot:
    """The rolling host snapshot of the last control fence, what the
    supervisor rehydrates from (JAX dispatch_core.py:202). All host
    data: a device fault cannot poison it. Taken at init (or resume) and
    at every checkpoint fence, where the host state is in hand anyway.
    The island generators' states stand in for JAX's key."""
    state: ga.PopState          # host (numpy) population
    generators: np.ndarray      # (L, n) uint8 island generator states
    gens_done: int
    epochs_done: int
    epochs_at_ckpt: int
    best_seen: list             # control floor at this point
    post: bool                  # post-feasibility phase active
    kick: tuple                 # (kick_stall, kick_best, kick_streak)
    # a pipelined checkpoint fence covers the in-flight chunk's state,
    # whose logEntries are not emitted yet: its trace, for recovery to
    # emit them before resuming
    inflight_trace: object = None
    # the init snapshot of a run whose LAHC endgame ran before the loop
    lahc_done: bool = False


class Supervisor:
    """In-run fault recovery policy (JAX dispatch_core.py:229): the
    rolling Snapshot, classification by retry.is_transient, the
    --max-recoveries budget and the degradation ladder on failures that
    cluster inside WINDOW_S seconds (`$TT_FAULT_WINDOW_S`, default 300):

        level 0  pipelined dispatch (as configured)
        level 1  strictly serial loop
        level 2+ serial, and each dispatch halved per level

    A WINDOW_S stretch without failure steps back up one level."""

    WINDOW_S = float(os.environ.get("TT_FAULT_WINDOW_S", "300"))
    MAX_LEVEL = 4

    def __init__(self, cfg):
        self.cfg = cfg
        self.enabled = cfg.max_recoveries > 0
        self.snap = None
        self.recoveries = 0
        self.level = 0
        self.failures: list = []     # monotonic failure times
        self._relaxed_at = None      # last step back up

    def snapshot(self, **kw) -> None:
        if self.enabled:
            self.snap = Snapshot(**kw)

    def dispatch_scale(self) -> float:
        """Chunk-size multiplier at ladder levels >= 2."""
        return 0.5 ** max(0, self.level - 1)

    def classify(self, exc: BaseException):
        """The faultEntry site when `exc` is recoverable (supervisor on,
        a snapshot to rehydrate from, transient over its cause chain),
        else None: the caller re-raises."""
        if not self.enabled or self.snap is None:
            return None
        if not retry.is_transient(exc):
            return None
        return getattr(exc, "tt_site", "dispatch")

    def escalate(self, now: float) -> bool:
        """Record a failure; step the ladder when failures cluster
        inside WINDOW_S. True when the level changed."""
        self.failures.append(now)
        recent = [t for t in self.failures if now - t <= self.WINDOW_S]
        new_level = min(len(recent) - 1, self.MAX_LEVEL)
        if new_level > self.level:
            self.level = new_level
            return True
        return False

    def agree_on_fault(self, channel, site: str, error=None) -> dict:
        """Multi-process recovery consensus (JAX dispatch_core.py:299):
        this process's verdict — `recover` at the snapshot's generation
        count, or `abort` when the recovery budget is spent — merged
        with every peer's over the control channel (abort wins, else the
        lowest-pid real fault site). Host-side only: nothing here may
        touch the possibly poisoned collectives. A single-process
        channel returns the local verdict, agreed."""
        local = {
            "site": site,
            "action": ("abort"
                       if self.recoveries + 1 > self.cfg.max_recoveries
                       else "recover"),
            "gens": int(self.snap.gens_done) if self.snap else -1,
            "err": str(error)[:200] if error is not None else None,
        }
        return channel.agree_on_fault(local)

    def maybe_relax(self, now: float) -> bool:
        """Step back up one level after WINDOW_S without a failure since
        the last failure or the last relax. True when it did."""
        if self.level <= 0:
            return False
        anchor = self.failures[-1] if self.failures else None
        if self._relaxed_at is not None:
            anchor = (self._relaxed_at if anchor is None
                      else max(anchor, self._relaxed_at))
        if anchor is not None and now - anchor < self.WINDOW_S:
            return False
        self.level -= 1
        self._relaxed_at = now
        return True


def place_state(host: ga.PopState, device) -> ga.PopState:
    """Place a host (numpy) PopState on `device` as int32 tensors."""
    return ga.PopState(*(torch.from_numpy(np.ascontiguousarray(
        x, dtype=np.int32)).to(device) for x in host))


def reshard_state(host: ga.PopState, mesh) -> list:
    """Place a host (numpy) global PopState on an island mesh (JAX
    dispatch_core.py:349): every process holds the whole host copy (a
    checkpoint or a snapshot holds the global population), and each
    local shard takes its own rows onto its card. Returns one PopState a
    local shard."""
    rows = mesh.local_rows(len(host.penalty))
    return [place_state(ga.PopState(*(x[a:b] for x in host)), dev)
            for (a, b), dev in zip(rows, mesh.devices)]


def state_nbytes(state) -> int:
    """Bytes of a PopState's fields, host (numpy) or device (torch), or
    of a mesh state's shards; 0 for None."""
    if state is None:
        return 0
    if isinstance(state, list):
        # a mesh state: its shards'
        return sum(state_nbytes(st) for st in state)
    return int(sum(x.nbytes if isinstance(x, np.ndarray)
                   else x.numel() * x.element_size() for x in state))


class HostCopy:
    """A device tensor's copy to the host, enqueued without a fence (the
    counterpart of JAX's copy_to_host_async, engine.py:2119-2126): a
    pinned host tensor filled by a non-blocking copy, and a CUDA event
    recorded right after it. `wait` blocks on that event alone, so
    reading chunk N's trace does not wait for the launches of chunk N+1
    queued behind it. A CPU tensor is its own copy."""

    __slots__ = ("host", "event")

    def __init__(self, x: torch.Tensor):
        if x.is_cuda:
            self.host = torch.empty(x.shape, dtype=x.dtype,
                                    pin_memory=True)
            # the copy and its event on the tensor's card's stream (a
            # mesh shard may live on another card than the current one)
            with torch.cuda.device(x.device):
                self.host.copy_(x, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record()
        else:
            self.host, self.event = x, None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def host_copies(x):
    """HostCopy of a tensor, or one a shard of a mesh value (a list)."""
    if isinstance(x, list):
        return [HostCopy(t) for t in x]
    return HostCopy(x)


def _to_host(x, axis: int = 0) -> np.ndarray:
    if isinstance(x, list):
        # a mesh value: the local shards joined along the island axis
        parts = [_to_host(t) for t in x]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis)
    if isinstance(x, HostCopy):
        return x.wait()
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


# the control-fence read deadline in seconds (None: no watchdog), set
# per run from --fetch-timeout
_FETCH_TIMEOUT = None


def set_fetch_timeout(timeout) -> None:
    """Install the control-fence read deadline; 0 or None disables the
    watchdog."""
    global _FETCH_TIMEOUT
    _FETCH_TIMEOUT = timeout if timeout else None


class FetchTimeout(TimeoutError):
    """A control-fence host read outlived the watchdog deadline. Its
    message carries the 'fetch watchdog' marker, so it is transient."""


def fetch(x, tracer=NULL_TRACER, flow=None, axis: int = 0) -> np.ndarray:
    """The control-fence host read (JAX dispatch_core.py:401) of a
    device tensor, a HostCopy, an array, or a mesh value (a list of
    them, one a local shard, joined along `axis`), then gathered from
    every process of the run in rank order (comm.ProcessGroup
    all_gather, behind the accord guard; the identity in one process).
    Under a deadline the read runs on a daemon thread that the caller
    joins with the deadline: a read that outlives it raises FetchTimeout
    (site `fetch`) and the thread is abandoned. A run split over
    processes reads on this thread, since every process must enter the
    gather in program order (JAX's rule). The `fetch` fault site fires
    inside the read. With a `flow` id the watchdog thread records its
    read as a `fetch-read` span on that flow, the arrow across the
    thread boundary."""
    group = comm.active()
    timeout = _FETCH_TIMEOUT
    if not timeout or group.world > 1:
        faults.maybe_fail("fetch")
        return group.all_gather(_to_host(x, axis), axis)
    box: dict = {}

    def _read():
        tr0 = time.monotonic()
        try:
            faults.maybe_fail("fetch")
            box["value"] = _to_host(x, axis)
            if flow is not None:
                tracer.record("fetch-read", tr0, time.monotonic() - tr0,
                              cat="engine", flow=flow)
        except BaseException as e:   # re-raised on the caller's thread
            box["error"] = e

    th = threading.Thread(target=_read, name="tt-fetch-watchdog",
                          daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        err = FetchTimeout(
            f"fetch watchdog: control-fence host read exceeded "
            f"{timeout:.0f}s deadline")
        err.tt_site = "fetch"
        raise err
    if "error" in box:
        e = box["error"]
        e.tt_site = "fetch"
        raise e
    return group.all_gather(box["value"], axis)


def fetch_leaf(x) -> np.ndarray:
    """A telemetry leaf (a trace) on the host: no fault site, no
    deadline, no gather (telemetry stays local to each process)."""
    return _to_host(x)


def _packed(state, fields):
    """A PopState's (N, ...) fields packed side by side, or one such
    tensor a shard of a mesh state (a list of PopStates)."""
    if isinstance(state, list):
        return [_packed(st, fields) for st in state]
    return torch.cat([getattr(state, f) if f in ("slots", "rooms")
                      else getattr(state, f)[:, None] for f in fields], 1)


def fetch_state(state) -> ga.PopState:
    """Host (numpy) copy of a population — a PopState, or a mesh state
    whose shards are gathered into the global one — in one control-fence
    read: slots, rooms, penalty, hcv and scv packed into one (N, 2E + 3)
    int32 array, fetched once and sliced apart."""
    packed = fetch(_packed(state, ga.PopState._fields))
    E = (packed.shape[1] - 3) // 2
    return ga.PopState(packed[:, :E], packed[:, E:2 * E], packed[:, 2 * E],
                       packed[:, 2 * E + 1], packed[:, 2 * E + 2])


def fetch_final(state, n_islands: int, pop: int):
    """The try's last read in one control fence (JAX dispatch_core.py:
    475): (slots (N, P, E), rooms (N, P, E), each island's best row's hcv
    (N,) and scv (N,)), N every island of the mesh."""
    packed = fetch(_packed(state, ("slots", "rooms", "hcv", "scv")))
    E = (packed.shape[1] - 2) // 2
    slots = packed[:, :E].reshape(n_islands, pop, E)
    rooms = packed[:, E:2 * E].reshape(n_islands, pop, E)
    hcv = packed[:, 2 * E].reshape(n_islands, pop)[:, 0]
    scv = packed[:, 2 * E + 1].reshape(n_islands, pop)[:, 0]
    return slots, rooms, hcv, scv


def decode_telemetry(trace, quality: bool, trace_mode: str, metrics,
                     overflow_counter: str, overflow_warned: bool,
                     warn_label: str = ""):
    """The telemetry decode of a retired dispatch or quantum, shared by
    the engine and the serve scheduler (JAX dispatch_core.py:520): the
    quality rows split off the fetched leaf, its events decoded under
    the effective trace mode (a `full` trace packs as deltas under
    quality; the record stream is the same), and the improvement events
    the event block could not hold counted into `overflow_counter` of
    `metrics` (engine.trace_delta_overflow, serve.trace_delta_overflow),
    with one warning on stderr, prefixed by `warn_label`. Returns
    (events, moments, quality rows or None, overflow_warned)."""
    trace, qrows = islands.split_quality(trace, quality)
    events, counts, moments = islands.trace_events(
        trace, islands.effective_trace_mode(trace_mode, quality))
    if counts is not None:
        dropped = int(sum(max(0, int(c) - len(e))
                          for c, e in zip(counts, events)))
        if dropped:
            metrics.counter(overflow_counter).inc(dropped)
            if not overflow_warned:
                overflow_warned = True
                print(f"warning: {warn_label}--trace-mode {trace_mode} "
                      f"dropped {dropped} improvement event(s) this "
                      f"dispatch (cap {islands.TRACE_DELTAS_CAP}; raise "
                      f"TT_TRACE_DELTAS_CAP)", file=sys.stderr)
    return events, moments, qrows, overflow_warned
