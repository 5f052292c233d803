"""The cost observatory (port of timetabling_ga_tpu/obs/cost.py, under
the same names): program accounting, the live roofline, device-memory
polling and on-demand profiler capture.

  PROGRAM ACCOUNTING  `instrument(fn, program)` wraps one of the port's
          programs (the engine's `runner`, `dyn_runner`, `init`,
          `polish`, `kick`, `shrink`, `lahc_init`, `lahc_run`,
          `lahc_fin`; serve's `lane_runner`, `lane_init`) in a
          `CostProgram`, under JAX's program names. JAX compiles each
          program once per input signature and reads XLA's
          cost_analysis off the executable. The port compiles nothing
          per shape, so its counterparts are these:
            - a "compile" is the first call of a signature (shapes and
              dtypes of the tensors, the types of the scalars: `_sig`);
            - its `compileSeconds` is the wall `kernels.build()` spent
              inside that call (kernels.BUILD_INFO's growth), 0.0 when
              the libraries were already loaded; `lowerSeconds` is
              0.0;
            - `last_compiled` and `last_compile_s` keep JAX's meaning
              (the most recent call was a signature's first, and what
              it paid);
            - `last_cost` is the work the call launched: the growth of
              kernels.WORK over the call (work.py TABLE, counted from
              the launches' shapes, no device read): `flops` the
              kernels' operation count (integer operations, apart from
              K5's hot-mode float rank compares), `bytes_accessed`,
              `intensity`, and `arg_bytes` / `out_bytes`, the tensors
              the call took and gave. XLA's `temp_bytes` has no
              counterpart (a kernel's scratch is its shared memory,
              never a buffer of the program), so `cost.temp_bytes.<p>`
              is left out.
          The registry then carries JAX's families: `compile.count`
          (and `compile.count.<program>`), `compile.cache_hits`,
          `compile.seconds` (exemplar {program, sig}) and, under
          --obs, a `costEntry` record per compile.

  ROOFLINE  `set_live_roofline(cost, dt)` turns a call's counted work
          and its measured wall into `cost.achieved_tflops`,
          `cost.flop_utilization_pct` and `cost.logical_gbps`, against
          this card's peaks: the NVIDIA H100 SXM data sheet's 3.35e12
          HBM3 bytes/s and its INT32 rate, 16.75e12 operations/s (a
          quarter of the 67e12 float32 FMA-counted rate: INT32 issues
          on 64 lanes an SM, one operation each). The gauge names are
          JAX's; the unit of `achieved_tflops` is 1e12 counted
          operations a second.

  MEMORY  `MemPoller` samples a stats function on its own daemon
          thread every `interval_s` seconds and feeds the `device.mem_*`
          gauges (`bytes_in_use`, `bytes_limit`, `peak_bytes_in_use`,
          `frac_used`) and the `device.mem_polls` counter. The pull
          front's /readyz turns `device.mem_frac_used` >= NEAR_HBM_FRAC
          (`TT_MEM_READY_FRAC`, read at import, default 0.92) into the
          `near_hbm_limit` reason (obs/http.py).
          `torch_memory_stats_fn` is the stats source on the card, the
          counterpart of JAX's `jax_memory_stats_fn`.

  PROFILE  `ProfileCapture` drives profiler start/stop from a worker
          thread (the engine and serve pass obs/prof.TorchProfiler's
          closures, a torch.profiler capture into the capture dir):
          `profile URL --for N` (or GET /profile?for=N on the
          --obs-listen front, or --profile-for N at launch) captures
          the next N dispatches. The dispatch loop only ticks a counter
          (`on_dispatch`), so a hung or dying capture (fault site
          `profile`) never stalls dispatch, serve or writer drain. A
          loop that takes a ticket at each enqueue (`on_enqueue`) has
          only dispatches enqueued after the capture went live counted.

The standing invariant: the record stream is the same with the
observatory on or off. `costEntry` and `profEntry` are timing records,
counters and gauges write no records, and a CostProgram calls the same
function. TT_COST_OBS=0 (read at import) makes `instrument` the
identity.

Stdlib only at import: torch is imported inside the stats function and
the capture, and the kernels' totals are read through a lazy import, so
the readers that import this module (`profile`, the pull front) stay
torch-free.
"""

from __future__ import annotations

import atexit
import dataclasses as _dc
import hashlib
import os
import sys
import threading
import time

from timetabling_ga_tpu_torch.obs import metrics as obs_metrics

# kill switch: TT_COST_OBS=0 makes instrument() the identity
ENABLED = os.environ.get("TT_COST_OBS", "1") != "0"

# NVIDIA H100 SXM data sheet peaks: HBM3 bytes/s; float32 outside the
# tensor cores, 67e12/s, which counts an FMA as two operations on 128
# lanes an SM. The kernels' work is integer: Hopper issues INT32 on 64
# lanes an SM, one operation each, a quarter of that rate; a plain
# float32 operation (a compare, an add) issues at half of it.
H100_HBM_BYTES_S = 3.35e12
H100_INT32_OPS_S = 67e12 / 4
H100_FP32_OPS_S = 67e12 / 2
HBM_PEAK_GBPS = H100_HBM_BYTES_S / 1e9
INT32_PEAK_TOPS = H100_INT32_OPS_S / 1e12

# /readyz's near_hbm_limit threshold on device.mem_frac_used
NEAR_HBM_FRAC = float(os.environ.get("TT_MEM_READY_FRAC", "0.92"))


def _faults():
    from timetabling_ga_tpu_torch.runtime import faults
    return faults


def _sig(args) -> tuple:
    """Input-signature key of a program call: the structure of tuples,
    lists, dicts and dataclasses, the dtype and shape of every tensor
    leaf and the type of every other leaf (JAX's stdlib fallback walk,
    with torch tensors as the leaves). Two problems of different shapes
    never share a signature; two seeds of one shape do."""
    out: list = []

    def walk(x):
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            out.append((str(x.dtype), tuple(x.shape)))
        elif isinstance(x, (list, tuple)):
            out.append(type(x).__name__)
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for k in sorted(x):
                out.append(str(k))
                walk(x[k])
        elif _dc.is_dataclass(x) and not isinstance(x, type):
            out.append(type(x).__name__)
            for f in _dc.fields(x):
                walk(getattr(x, f.name))
        else:
            out.append(type(x).__name__)

    walk(args)
    return tuple(out)


def sig_tag(sig: tuple) -> str:
    """Short deterministic label for a signature (the exemplar /
    costEntry `sig` value a dashboard joins buckets on)."""
    return hashlib.md5(repr(sig).encode()).hexdigest()[:10]


def _tensor_bytes(x) -> int:
    """Bytes of the tensors in a nested argument (shapes only)."""
    if hasattr(x, "element_size") and hasattr(x, "numel"):
        return int(x.numel() * x.element_size())
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_tensor_bytes(y) for y in x.values())
    if _dc.is_dataclass(x) and not isinstance(x, type):
        return sum(_tensor_bytes(getattr(x, f.name))
                   for f in _dc.fields(x))
    return 0


def roofline(flops_per_eval: float, bytes_per_eval: float,
             per_sec: float) -> dict:
    """The roofline placement of a program run `per_sec` times a second
    doing `flops_per_eval` counted operations and `bytes_per_eval`
    bytes: achieved tera-operations/s against the H100's INT32 peak,
    logical GB/s against its HBM peak, and the share of the logical
    bytes the HBM provably never served (the counted bytes are each
    input read once: any excess over the HBM peak is data a kernel kept
    on chip)."""
    out = {"flops_per_eval": round(flops_per_eval, 1),
           "logical_bytes_per_eval": round(bytes_per_eval, 1),
           "arithmetic_intensity_flops_per_byte":
               (round(flops_per_eval / bytes_per_eval, 3)
                if bytes_per_eval else None)}
    if bytes_per_eval and per_sec:
        logical_gbps = bytes_per_eval * per_sec / 1e9
        tflops = flops_per_eval * per_sec / 1e12
        out["achieved_tflops"] = round(tflops, 1)
        out["int32_peak_tops"] = INT32_PEAK_TOPS
        out["flop_utilization_vs_int32_peak_pct"] = round(
            100 * tflops / INT32_PEAK_TOPS, 1)
        out["logical_gbps_at_measured_rate"] = round(logical_gbps, 1)
        out["hbm_peak_gbps"] = HBM_PEAK_GBPS
        out["min_fused_fraction_pct"] = round(
            max(0.0, 100 * (1 - HBM_PEAK_GBPS / logical_gbps)), 1)
    return out


def set_live_roofline(cost: dict | None, dt: float,
                      registry=None) -> None:
    """Update the live achieved-vs-peak gauges from one program call's
    counted work (`CostProgram.last_cost`) and its measured wall time —
    THE formula, owned here next to the peaks so the engine's chunk
    retire and the serve scheduler's quantum cannot drift on it:
    `cost.achieved_tflops`, `cost.flop_utilization_pct`,
    `cost.logical_gbps`."""
    if not cost or dt <= 0:
        return
    reg = obs_metrics.REGISTRY if registry is None else registry
    fl = cost.get("flops")
    if fl:
        tf = fl / dt / 1e12
        reg.gauge("cost.achieved_tflops").set(tf)
        reg.gauge("cost.flop_utilization_pct").set(
            100.0 * tf / INT32_PEAK_TOPS)
    by = cost.get("bytes_accessed")
    if by:
        reg.gauge("cost.logical_gbps").set(by / dt / 1e9)


class Observatory:
    """Process-global costEntry emission target. The registry half of
    the observatory is always on (counters and gauges); record emission
    binds per run: engine.run / SolveService `bind(writer,
    now=tracer.now)` under `--obs` and unbind in their finallys, so the
    global never holds a finished run's writer alive and the JSONL
    stream is the same with the observatory on or off (costEntry is a
    timing record either way)."""

    def __init__(self, registry=None):
        self.registry = (obs_metrics.REGISTRY if registry is None
                         else registry)
        self._lock = threading.Lock()
        self._out = None
        self._now = None
        # recent compile entries (program, sig, cost dict)
        self.entries: list = []

    def bind(self, out, now=None) -> None:
        with self._lock:
            self._out = out
            self._now = now

    def unbind(self) -> None:
        self.bind(None)

    def record_compile(self, program: str, sig: tuple, lower_s: float,
                       compile_s: float, cost: dict,
                       retries: int = 0) -> None:
        reg = self.registry
        reg.counter("compile.count").inc()
        reg.counter(f"compile.count.{program}").inc()
        tag = sig_tag(sig)
        reg.histogram("compile.seconds").observe(
            lower_s + compile_s, exemplar={"program": program,
                                           "sig": tag})
        if retries:
            reg.counter("compile.retries").inc(retries)
        fl = cost.get("flops")
        if fl is not None:
            reg.gauge(f"cost.flops.{program}").set(fl)
        by = cost.get("bytes_accessed")
        if by is not None:
            reg.gauge(f"cost.bytes.{program}").set(by)
        ai = cost.get("intensity")
        if ai is not None:
            reg.gauge(f"cost.intensity.{program}").set(ai)
        with self._lock:
            self.entries.append({"program": program, "sig": tag,
                                 "lower_s": lower_s,
                                 "compile_s": compile_s, **cost})
            del self.entries[:-256]
            out, now = self._out, self._now
        if out is not None:
            try:
                from timetabling_ga_tpu_torch.runtime import jsonl
                extra = {k: (round(v, 3) if isinstance(v, float) else v)
                         for k, v in cost.items()}
                if retries:
                    extra["retries"] = retries
                if now is not None:
                    extra["ts"] = round(max(0.0, float(now())), 6)
                jsonl.cost_entry(out, program, sig=tag,
                                 lowerSeconds=round(lower_s, 4),
                                 compileSeconds=round(compile_s, 4),
                                 **extra)
            except Exception:
                pass   # telemetry must never fail a call

    def hit(self, program: str) -> None:
        self.registry.counter("compile.cache_hits").inc()


OBSERVATORY = Observatory()


def compile_hit_rate(registry=None) -> float:
    """Warm-call fraction: cache_hits / (cache_hits + count)."""
    reg = OBSERVATORY.registry if registry is None else registry
    hits = reg.counter("compile.cache_hits").value
    total = hits + reg.counter("compile.count").value
    return hits / total if total else 0.0


def _kernel_counters() -> tuple:
    """(operations, bytes, build seconds) the kernels have counted so
    far (kernels.WORK, kernels.BUILD_INFO), through a lazy import: the
    program proxies only run inside engine and serve processes."""
    from timetabling_ga_tpu_torch import kernels
    return (kernels.WORK["ops"], kernels.WORK["bytes"],
            kernels.BUILD_INFO["total_seconds"])


def _cost_of(ops: float, nbytes: float, arg_bytes: int = 0,
            out_bytes: int = 0) -> dict:
    """A call's cost dict in JAX's field order (extract_cost): a field
    only when it is positive, `intensity` when both counts are."""
    out: dict = {}
    if ops > 0:
        out["flops"] = float(ops)
    if nbytes > 0:
        out["bytes_accessed"] = float(nbytes)
    if arg_bytes > 0:
        out["arg_bytes"] = float(arg_bytes)
    if out_bytes > 0:
        out["out_bytes"] = float(out_bytes)
    if ops > 0 and nbytes > 0:
        out["intensity"] = float(ops) / float(nbytes)
    return out


class CostProgram:
    """Accounting proxy around one of the port's programs (module
    docstring: what a compile and a cost are here).

    Per input signature the FIRST call counts as the compile: recorded
    (compile.count, compile.seconds, the cost.* gauges, a costEntry
    under a bound emitter) after the call returns, with the work it
    launched; later calls of that signature tick `compile.cache_hits`.
    `last_cost` holds the most recent call's counted work (None when it
    launched nothing), `last_compiled` whether that call was a
    signature's first and `last_compile_s` the kernel build wall it
    paid (0.0 on a warm call): callers skip the roofline update on a
    compiling call, whose wall may hold the kernels' build.
    `counters` (default: the kernels' totals) returns (ops, bytes,
    build seconds), so a plain-Python function can be accounted in
    tests."""

    __slots__ = ("_fn", "program", "_obs", "_seen", "_lock", "_counters",
                 "last_cost", "last_compiled", "last_compile_s")

    def __init__(self, fn, program: str, observatory=None, counters=None):
        self._fn = fn
        self.program = program
        self._obs = OBSERVATORY if observatory is None else observatory
        self._counters = (_kernel_counters if counters is None
                          else counters)
        self._seen: set = set()
        self._lock = threading.Lock()
        self.last_cost: dict | None = None
        self.last_compiled = False
        self.last_compile_s = 0.0

    def __call__(self, *args, **kwargs):
        sig = _sig((args, kwargs))
        with self._lock:
            first = sig not in self._seen
            self._seen.add(sig)
        o0, b0, s0 = self._counters()
        result = self._fn(*args, **kwargs)
        o1, b1, s1 = self._counters()
        compile_s = max(0.0, float(s1 - s0)) if first else 0.0
        cost = _cost_of(o1 - o0, b1 - b0, _tensor_bytes((args, kwargs)),
                       _tensor_bytes(result))
        self.last_compiled = first
        self.last_compile_s = compile_s
        self.last_cost = cost if "flops" in cost else None
        if first:
            self._obs.record_compile(self.program, sig, 0.0, compile_s,
                                     cost)
        else:
            self._obs.hit(self.program)
        return result


def instrument(fn, program: str, observatory=None):
    """Wrap `fn` (one of the port's programs) in accounting; the
    identity when the observatory is disabled (TT_COST_OBS=0)."""
    if not ENABLED or fn is None or isinstance(fn, CostProgram):
        return fn
    return CostProgram(fn, program, observatory=observatory)


# ------------------------------------------------------------ mem poller


def torch_memory_stats_fn(device):
    """A stats source for MemPoller reading the caching allocator of
    `device`: `bytes_in_use` is its current allocated bytes,
    `peak_bytes_in_use` their peak, and `bytes_limit` the card's total
    memory from `torch.cuda.mem_get_info`, read once here. On the CPU
    the source returns None, as JAX's does on a backend without
    allocator stats.

    The reads are host-side allocator counters: they never synchronize
    a stream, so the poller thread cannot stall a dispatch."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return lambda: None
    limit = int(torch.cuda.mem_get_info(device)[1])

    def read():
        return {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
                "bytes_limit": limit,
                "peak_bytes_in_use": int(
                    torch.cuda.max_memory_allocated(device))}

    return read


class MemPoller:
    """Off-dispatch-path device memory telemetry: a daemon thread
    samples `stats_fn()` every `interval_s` seconds and feeds the
    `device.mem_*` gauges (`bytes_in_use`, `bytes_limit`,
    `peak_bytes_in_use`, `frac_used`) plus a `device.mem_polls`
    counter. /readyz turns `device.mem_frac_used` >= NEAR_HBM_FRAC into
    the `near_hbm_limit` degraded reason.

    Fault site `mem_poll` fires once per sample on THIS thread: `hang`
    parks the poller (gauges go stale, nothing else notices), `die`
    ends it silently — dispatch, serve, and writer drain never wait on
    it. Writes no records, so the JSONL stream is identical with the
    poller on or off."""

    def __init__(self, stats_fn, interval_s: float = 1.0, registry=None):
        self._stats_fn = stats_fn
        self._interval = max(0.05, float(interval_s))
        self._reg = (obs_metrics.REGISTRY if registry is None
                     else registry)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="tt-mem-poll", daemon=True)

    def start(self) -> "MemPoller":
        self._thread.start()
        # stop the poller before interpreter teardown even on abrupt
        # exits (close() is idempotent; owners still call it from their
        # finallys)
        atexit.register(self.close)
        return self

    def alive(self) -> bool:
        return self._thread.is_alive()

    def poll_once(self) -> bool:
        """One sample; False when the thread should exit (injected
        death)."""
        if sys.is_finalizing():
            return False
        try:
            _faults().maybe_fail("mem_poll")
            stats = self._stats_fn()
        except SystemExit:
            return False            # injected death: exit silently
        except Exception:
            self._reg.counter("device.mem_poll_errors").inc()
            return True
        self._reg.counter("device.mem_polls").inc()
        if not stats:
            return True
        in_use = stats.get("bytes_in_use")
        limit = stats.get("bytes_limit")
        if in_use is not None:
            self._reg.gauge("device.mem_bytes_in_use").set(in_use)
        if limit:
            self._reg.gauge("device.mem_bytes_limit").set(limit)
            if in_use is not None:
                self._reg.gauge("device.mem_frac_used").set(
                    in_use / limit)
        peak = stats.get("peak_bytes_in_use")
        if peak is not None:
            self._reg.gauge("device.mem_peak_bytes_in_use").set(peak)
        return True

    def _loop(self) -> None:
        while True:
            if not self.poll_once():
                return
            if self._stop.wait(self._interval):
                return

    def close(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:   # never-started: no join
            self._thread.join(timeout=2.0)   # a hung poller is
            #                                  abandoned (daemon)
        atexit.unregister(self.close)


# -------------------------------------------------------- profile capture


# how long close() waits for a capture's stop that is under way
STOP_WAIT_S = 60.0


class ProfileCapture:
    """On-demand profiler capture spanning N dispatches, driven
    entirely OFF the dispatch path (JAX's state machine, unchanged).

    A worker thread owns the profiler start/stop calls (`start_fn(dir)`
    / `stop_fn()` — the engine and serve pass obs/prof.TorchProfiler's,
    keeping this module torch-free); the dispatch loop only calls
    `on_dispatch()` — a lock-guarded counter decrement — and the HTTP
    front only calls `trigger(n)` — a state flip plus a worker wake. A
    short run may end before its capture starts; close() then
    guarantees the late start is abandoned rather than leaving a stray
    session (the `_closed` re-check below). For one-dispatch captures
    of short runs `--trace-profile` (the dispatch thread, synchronous)
    remains the tool.

    A capture the worker starts records the card's kernels process-wide
    (CUPTI); whether the dispatch thread's `tt.*` ranges reach it is
    the profiler's business, and the kernel map alone attributes every
    hand-kernel launch either way (obs/prof.py). Fault site
    `profile` fires on the worker around each start/stop: `hang` parks
    the worker (the capture never materializes; dispatches continue),
    `die` ends it — either way nothing on the solve path blocks (tests
    pin it). One capture at a time: `trigger` while one is active
    answers busy instead of queueing.

    The card's profiler records the kernels launched while it is live,
    so a dispatch already enqueued when the capture starts lies in it
    only in part, down to none of its work. A loop that takes a ticket
    from `on_enqueue()` before it launches a dispatch and hands it to
    `on_dispatch(ticket)` when that dispatch retires has such a
    dispatch left uncounted: the N counted are whole. A tick without a
    ticket counts, as JAX's does. Such a loop calls `flush()` when it
    has no more dispatches to run, so that a live capture still waiting
    for its whole ones stops then, with what it holds.

    The phase profiler rides the worker too: set `on_complete` to a
    callable of the finished capture's directory (obs/prof.capture_hook
    — kernel-map write + attribution + gauge/profEntry publish) and it
    runs ON THIS WORKER after each successful stop; its return value is
    kept as `last()` for the /profile?last=1 poll `tt profile --attribute`
    reads. Hook failures warn and never break the capture machinery;
    the close-race teardown path skips the hook (the capture being
    abandoned was never cleanly stopped)."""

    def __init__(self, start_fn, stop_fn, default_dir: str | None = None,
                 registry=None):
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self.default_dir = default_dir or "tt-profile"
        self._reg = (obs_metrics.REGISTRY if registry is None
                     else registry)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._cmd = None          # ("start", n, dir) | ("stop",) | close
        self._busy = False        # trigger accepted, capture not closed
        self._remaining = 0       # dispatches left in the live capture
        self._closed = False
        self.on_complete = None   # callable(dir) after a clean stop
        self._active_dir = None   # dir of the live capture
        self._last_attr = None    # last on_complete return (tt-prof)
        self._completed = 0       # captures fully stopped
        self._tickets = 0         # on_enqueue tickets handed out
        self._first_ticket = 0    # the first one the live capture counts
        self._stopping = False    # the worker is in a stop and its hook
        self._thread = threading.Thread(
            target=self._worker, name="tt-profile", daemon=True)
        self._thread.start()
        # close (stopping any live capture) before interpreter
        # teardown on abrupt exits — an active profiler session plus a
        # half-destroyed backend is a crash at exit, not an error.
        # Idempotent; normal owners still close() from their finallys.
        atexit.register(self.close)

    def trigger(self, n: int, out_dir: str | None = None) -> dict:
        """Request a capture of the next `n` dispatches. Returns the
        ack the /profile endpoint serializes."""
        n = max(1, int(n))
        with self._lock:
            if self._closed:
                return {"ok": False, "reason": "capture closed"}
            if self._busy:
                return {"ok": False, "reason": "capture already active"}
            self._busy = True
            self._cmd = ("start", n, out_dir or self.default_dir)
        self._wake.set()
        return {"ok": True, "dispatches": n,
                "dir": out_dir or self.default_dir}

    def on_enqueue(self) -> int:
        """A ticket for the dispatch about to be launched, for its
        `on_dispatch` (never blocks beyond the counter lock)."""
        with self._lock:
            self._tickets += 1
            return self._tickets - 1

    def on_dispatch(self, ticket: int | None = None) -> None:
        """One dispatch retired (called by the engine/serve loops;
        never blocks beyond the counter lock). A `ticket` from before
        the live capture started does not count."""
        with self._lock:
            if self._remaining <= 0:
                return
            if ticket is not None and ticket < self._first_ticket:
                return
            self._remaining -= 1
            if self._remaining > 0:
                return
            self._cmd = ("stop",)
        self._wake.set()

    def flush(self) -> None:
        """No more dispatches come: a live capture stops now, on the
        worker, as on its last counted dispatch."""
        with self._lock:
            if self._remaining <= 0:
                return
            self._remaining = 0
            self._cmd = ("stop",)
        self._wake.set()

    def active(self) -> bool:
        with self._lock:
            return self._busy

    def last(self) -> dict:
        """Completed-capture count plus the newest attribution result
        (None until an on_complete hook has produced one). Served by
        /profile?last=1 — a pure read, like every handler-path touch
        of this object."""
        with self._lock:
            return {"completed": self._completed,
                    "result": self._last_attr}

    def _worker(self) -> None:
        while True:
            self._wake.wait()
            self._wake.clear()
            with self._lock:
                cmd, self._cmd = self._cmd, None
                if self._closed and cmd is None:
                    return
            if cmd is None:
                continue
            if cmd[0] == "start":
                try:
                    _faults().maybe_fail("profile")
                except SystemExit:
                    return          # injected death: dispatches go on
                with self._lock:
                    if self._closed:
                        # close() won the race while this worker was
                        # parked (the `hang` fault): starting now
                        # would leave a stray profiler session nobody
                        # stops — poisoning every later capture in the
                        # process
                        self._busy = False
                        return
                try:
                    self._start_fn(cmd[2])
                except SystemExit:
                    return
                except Exception as e:
                    print(f"warning: profiler capture failed to start: "
                          f"{str(e)[:120]}", file=sys.stderr)
                    with self._lock:
                        self._busy = False
                    continue
                self._reg.counter("profile.captures").inc()
                with self._lock:
                    self._remaining = cmd[1]
                    self._active_dir = cmd[2]
                    self._first_ticket = self._tickets
            elif cmd[0] == "stop":
                stopped = True
                try:
                    _faults().maybe_fail("profile")
                    self._stopping = True
                    self._stop_fn()
                except SystemExit:
                    return
                except Exception as e:
                    stopped = False
                    print(f"warning: profiler capture failed to stop: "
                          f"{str(e)[:120]}", file=sys.stderr)
                with self._lock:
                    self._busy = False
                    self._remaining = 0
                    hook, cdir = self.on_complete, self._active_dir
                    self._active_dir = None
                # the attribution on THIS worker (never the dispatch
                # path): kernel map + parse + publish; a hook
                # failure degrades to an unattributed capture, the
                # capture machinery itself never breaks on it
                res = None
                if stopped and hook is not None and cdir is not None:
                    try:
                        res = hook(cdir)
                    except Exception as e:
                        print(f"warning: profile attribution failed: "
                              f"{str(e)[:120]}", file=sys.stderr)
                with self._lock:
                    self._last_attr = res
                    self._completed += 1
                    self._stopping = False
            # a close() that arrived WITH the command just processed
            # (its wake was consumed above) must end the worker now —
            # looping back to wait() would park the thread forever and
            # make every such close() burn its full join timeout. And
            # if close() raced the START just performed (it checked
            # _remaining before this worker set it, so it queued no
            # stop), the live session must be stopped HERE — returning
            # with it open would leave a stray profiler session nobody
            # ever stops (the docstring's abandonment guarantee).
            with self._lock:
                if not (self._closed and self._cmd is None):
                    continue
                live = self._remaining > 0
                self._busy = False
                self._remaining = 0
            if live:
                try:
                    self._stop_fn()
                except Exception:
                    pass
            return

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._busy and self._remaining > 0:
                self._remaining = 0
                self._cmd = ("stop",)
        self._wake.set()
        self._thread.join(timeout=2.0)   # hung worker: abandoned daemon
        if self._stopping:
            # a stop past its fault site is writing the capture: a
            # reader after close finds it whole
            self._thread.join(timeout=STOP_WAIT_S)
        atexit.unregister(self.close)


# ---------------------------------------------------------- profile (CLI)


def main_profile(argv) -> int:
    """`profile <url> [--for N] [--attribute [--timeout S]]` — trigger
    an on-demand profiler capture on a live run/serve process through
    its `--obs-listen` front (GET /profile?for=N). `--attribute` then
    polls GET /profile?last=1 until the capture lands and renders the
    phase breakdown (obs/prof.render). Stdlib-only and device-free,
    like `trace`/`stats`: it talks to the process, it is not one (JAX's
    client, usage text byte for byte)."""
    url, n, attrib, timeout_s = None, 1, False, 120.0
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print("usage: tt profile <http://host:port> [--for N] "
                  "[--attribute [--timeout S]]\n\n"
                  "ask a live run (--obs-listen) to capture a "
                  "jax.profiler trace of its next N dispatches into "
                  "its --profile-dir; view with tensorboard/xprof.\n"
                  "--attribute waits for the capture to land and "
                  "renders the tt-prof per-phase device-time table")
            return 0
        if a == "--for":
            if i + 1 >= len(argv):
                raise SystemExit("flag --for needs a value")
            n = int(argv[i + 1])
            i += 2
            continue
        if a == "--attribute":
            attrib = True
            i += 1
            continue
        if a == "--timeout":
            if i + 1 >= len(argv):
                raise SystemExit("flag --timeout needs a value")
            timeout_s = float(argv[i + 1])
            i += 2
            continue
        if url is None:
            url = a
            i += 1
            continue
        raise SystemExit(f"unknown argument: {a}")
    if url is None:
        raise SystemExit("usage: tt profile <http://host:port> "
                         "[--for N] [--attribute]")
    if "://" not in url:
        url = "http://" + url
    import json as _json
    import urllib.error
    import urllib.request

    def get(path: str) -> dict:
        try:
            with urllib.request.urlopen(
                    f"{url.rstrip('/')}{path}", timeout=10) as resp:
                return _json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            try:
                return _json.loads(e.read().decode())
            except Exception:
                return {"ok": False, "reason": str(e)}
        except Exception as e:
            raise SystemExit(f"tt profile: {e}") from None

    before = get("/profile?last=1").get("completed", 0) if attrib else 0
    body = get(f"/profile?for={int(n)}")
    print(_json.dumps(body))
    if not body.get("ok"):
        return 1
    if not attrib:
        return 0
    # poll until the capture's stop (and its worker-side attribution)
    # lands — the completed counter bumps exactly once per capture
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        last = get("/profile?last=1")
        if last.get("completed", 0) > before:
            res = last.get("result")
            if res is None:
                print("tt profile: capture landed but no attribution "
                      "(no on-complete hook or parse failed)",
                      file=sys.stderr)
                return 1
            from timetabling_ga_tpu_torch.obs import prof as obs_prof
            print(obs_prof.render(res))
            return 0
        time.sleep(0.5)
    print(f"tt profile: capture did not land within {timeout_s:.0f}s "
          f"(needs {int(n)} more dispatches?)", file=sys.stderr)
    return 1
