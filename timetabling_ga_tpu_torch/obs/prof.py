"""The phase profiler (port of timetabling_ga_tpu/obs/prof.py, under the
same names): phase-level device-time attribution of torch.profiler
captures, hotspot ranking and diffing, and the profEntry feed.

  PHASE SCOPES  `scope(name)` takes a name from the one registry
                (`PHASES`, JAX's) and gives a `torch.profiler.
                record_function(name)` range, usable as a context
                manager and as a decorator, at the port's counterparts
                of JAX's decorator sites (ops/, parallel/islands.py).
                The port's generation is paced by the host, a few dozen
                small launches each, so a range entered at every call
                would cost host time on every generation: a scope does
                nothing but check one flag unless a capture is live (a
                --trace-profile dispatch, or a ProfileCapture between
                its start and its stop, `TorchProfiler`). Scopes change
                no number: the record stream is the same with them on,
                off or live. TT_PROF_SCOPES=0 (read at import) makes
                `scope` return the function itself (and a null context).

  KERNEL MAP    JAX joins trace events to phases through a map from the
                compiled HLO to phases (its sidecar, written at compile
                time). The port compiles no HLO: its join table is
                `KERNEL_PHASES`, a fixed map from each kernel entry point
                (every key of kernels.SIGNATURES and kernels.FORMS) to
                the phase of the JAX program it replaces. A kernel's
                trace event is named `<entry>_kernel...`.
                `write_scope_map(dir)` drops the map into a capture as
                `tt_scope_map.json`, so a copied capture still
                attributes with the map it was taken under.

  ATTRIBUTION   `attribute(capture_dir)` reads the newest run's Chrome
                trace (`<dir>/plugins/profile/<run>/<host>.pt.trace.
                json.gz`, as `TorchProfiler` writes it; a dir of trace
                files or one trace file also do). The device events are
                the trace's GPU events (kernels, memcpys, memsets);
                where a trace has none, as on the CPU, its `cpu_op`
                events. Each event's SELF time (a stack pass subtracts
                nested events on the same thread, JAX's `_self_times`)
                goes to, in order: the innermost `tt.*` range enclosing
                it (`gpu_user_annotation` for a GPU event,
                `user_annotation` on its own thread for a CPU one); the
                kernel map; JAX's scan of the event's own strings for a
                `tt.*` token; else the honest `unattributed` bucket.
                The result dict is JAX's, key for key and rounding for
                rounding.

  WIRING        `capture_hook(out, registry, now)` is ProfileCapture's
                on-complete callback: map write, attribution, `publish`
                into the `prof.phase_seconds.<phase>`,
                `prof.total_seconds` and `prof.unattributed_seconds`
                gauges and, with an emitter bound (--obs), a `profEntry`
                record (a timing record: the stream is the same with
                profiling on or off).

  CLI           `hotspots DIR|LOG [--top K] [--json]` and `hotspots
                --diff A B` render as JAX's do (the same bytes on equal
                inputs).

Stdlib only at import (`hotspots` runs on a machine with no torch);
torch is imported inside the capture and inside a live scope.
"""

from __future__ import annotations

import functools
import glob
import gzip
import json
import os
import socket
import sys
import time

from timetabling_ga_tpu_torch.obs import metrics as obs_metrics

# THE scope registry (JAX's, name for name): one entry per algorithmic
# phase of the memetic loop
PHASES = ("tt.fitness", "tt.rooms", "tt.delta", "tt.sweep", "tt.ga",
          "tt.moves", "tt.migrate", "tt.lahc", "tt.polish",
          "tt.quality")

_PHASE_SET = frozenset(PHASES)

# kill switch: TT_PROF_SCOPES=0 turns every scope off, read at import
SCOPES_ENABLED = os.environ.get("TT_PROF_SCOPES", "1") != "0"

# the join-table file written into a capture dir
SIDECAR = "tt_scope_map.json"

# Kernel entry point -> the phase of the JAX program it replaces: where
# JAX's innermost scope falls over the code each kernel stands in for
KERNEL_PHASES = {
    # K1, JAX rooms.py:107 assign_rooms (tt.rooms)
    "assign_rooms": "tt.rooms",
    # K2, JAX fitness.py compute_hcv / scv_from_attendance (tt.fitness)
    "batch_penalty": "tt.fitness",
    # K3, JAX sweep.py:77 _move1_sweep (tt.sweep)
    "move1_sweep": "tt.sweep",
    # K4, JAX delta.py:89 _delta_one (tt.delta)
    "delta_one": "tt.delta",
    # K5, JAX sweep.py:229 sweep_pass (tt.sweep)
    "sweep_pass": "tt.sweep",
    # K6, JAX ga.py:167 _make_child (tt.ga), lane form alike
    "breed": "tt.ga",
    "breed_lanes": "tt.ga",
    # K6's relocation chain, JAX moves.py:173 random_move (tt.moves)
    "relocate": "tt.moves",
    # K7, JAX ga.py:220 generation's truncation (tt.ga)
    "survivors": "tt.ga",
    # K7's migrate, JAX islands.py:212 _migrate (tt.migrate)
    "migrate": "tt.migrate",
    "migrate_halo": "tt.migrate",
    # K8's pre-pass, the top 3 of JAX delta.py:211's candidates (tt.delta)
    "random_ls_events": "tt.delta",
    # K8's chain, JAX delta.py:211 batch_local_search_delta (tt.delta)
    "random_ls": "tt.delta",
    "random_ls_lanes": "tt.delta",
    # K12, JAX local_search.py:40 (unscoped): its time is the full
    # evaluations, JAX fitness.py's (tt.fitness)
    "full_eval_ls": "tt.fitness",
    # K9, JAX rooms.py:303 parallel_assign_rooms (tt.rooms)
    "parallel_rooms": "tt.rooms",
    # K10, JAX lahc.py:105 lahc_steps (tt.lahc)
    "lahc": "tt.lahc",
    # K11, JAX nsga.py (unscoped) inside ga.py:220 generation (tt.ga)
    "nsga_rank": "tt.ga",
    "nsga_survivors": "tt.ga",
    # K13, JAX islands.py:595/:445 (unscoped trace packing, beside the
    # quality telemetry it shares the leaf with): tt.quality
    "compress_trace": "tt.quality",
    "compress_trace_lanes": "tt.quality",
    "moment_rows": "tt.quality",
    # K14's quality_ops, JAX ga.py:221 inside generation (tt.ga)
    "quality_ops": "tt.ga",
    # K14's div_stats, JAX islands.py:494 _div_stats (tt.quality)
    "div_stats": "tt.quality",
    "div_stats_lanes": "tt.quality",
}

# live captures (TorchProfiler between start and stop): scopes open
# ranges only while this is non-zero
_LIVE = [0]

# the trace categories of device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short(phase: str) -> str:
    """Gauge/JSON key for a phase: the registry name minus the `tt.`
    prefix (`prof.phase_seconds.sweep`, profEntry `phases.sweep`)."""
    return phase[3:] if phase.startswith("tt.") else phase


class _NullScope:
    """The scope with scopes off: a null context, and as a decorator
    the function itself."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return fn


class _Scope:
    """A phase range: a torch.profiler.record_function while a capture
    is live, else one flag check."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if _LIVE[0]:
            import torch
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            if not _LIVE[0]:
                return fn(*args, **kwargs)
            import torch
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return scoped


def scope(name: str):
    """Phase scope `name` (must be in PHASES), as a context manager or a
    function decorator: a `tt.*` record_function range while a capture
    is live, one flag check otherwise (module docstring). Returns a
    null scope when scopes are disabled (TT_PROF_SCOPES=0)."""
    if name not in _PHASE_SET:
        raise ValueError(
            f"unknown phase scope {name!r}: tt-prof scopes must come "
            f"from obs/prof.py PHASES {sorted(_PHASE_SET)}")
    if not SCOPES_ENABLED:
        return _NullScope()
    return _Scope(name)


# ------------------------------------------------------------ the capture


class TorchProfiler:
    """One torch.profiler capture into a capture dir: `start(dir)` opens
    a `torch.profiler.profile` (CPU activity, plus CUDA on a card) and
    makes scopes live; `stop()` waits for the card, closes it and writes
    the gzipped Chrome trace as `<dir>/plugins/profile/<run>/<host>.
    pt.trace.json.gz`, the run named by the stop's time, so the newest
    capture is the newest run. Returns the trace path.

    The profiler records the CPU ops and ranges of the thread that
    starts it; a capture started on a worker thread (ProfileCapture)
    passes `all_threads`, which asks torch.profiler to record every
    thread's (`profile_all_threads`, where this torch has it), so the
    dispatch thread's ranges and CPU ops reach it. The card's kernels
    are recorded process-wide either way (CUPTI)."""

    def __init__(self, device=None, all_threads: bool = False):
        self.device = device
        self.all_threads = all_threads
        self._prof = None
        self._dir = None

    def start(self, capture_dir: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        cuda = (self.device is not None
                and torch.device(self.device).type == "cuda")
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        kwargs = {}
        if self.all_threads:
            try:
                kwargs["experimental_config"] = \
                    torch._C._profiler._ExperimentalConfig(
                        profile_all_threads=True)
            except (AttributeError, TypeError):
                pass            # a torch without the option
        prof = profile(activities=acts, **kwargs)
        prof.start()
        self._prof, self._dir = prof, capture_dir
        _LIVE[0] += 1

    def abandon(self) -> None:
        """Close a capture without writing it (a failed dispatch)."""
        prof, self._prof, self._dir = self._prof, None, None
        if prof is None:
            return
        _LIVE[0] = max(0, _LIVE[0] - 1)
        try:
            prof.stop()
        except Exception:
            pass

    def stop(self) -> str:
        import torch
        prof, cdir = self._prof, self._dir
        if prof is None:
            return None
        self._prof = self._dir = None
        try:
            if (self.device is not None
                    and torch.device(self.device).type == "cuda"):
                torch.cuda.synchronize(self.device)
            prof.stop()
        finally:
            _LIVE[0] = max(0, _LIVE[0] - 1)
        run = time.strftime("%Y_%m_%d_%H_%M_%S") + \
            f"_{int(time.time() * 1e6) % 1000000:06d}"
        rdir = os.path.join(cdir, "plugins", "profile", run)
        os.makedirs(rdir, exist_ok=True)
        raw = os.path.join(rdir, f".{os.getpid()}.json")
        prof.export_chrome_trace(raw)
        path = os.path.join(rdir, f"{socket.gethostname()}.pt.trace.json.gz")
        with open(raw, "rb") as f, gzip.open(path, "wb") as g:
            g.write(f.read())
        os.remove(raw)
        return path


# ------------------------------------------------------ the kernel map


def write_scope_map(capture_dir: str):
    """Drop the kernel map as `tt_scope_map.json` inside `capture_dir`
    (next to `plugins/`), so a copied capture attributes with the map
    it was taken under. Returns the path, or None on a write error."""
    try:
        path = os.path.join(capture_dir, SIDECAR)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"kernels": dict(KERNEL_PHASES)}, f)
        return path
    except OSError:
        return None


def _load_sidecar(capture_dir: str, trace_files: list) -> dict:
    """The kernel map of a capture: its sidecar next to the capture root
    or next to the trace files, else the package's."""
    cands = []
    if os.path.isdir(capture_dir):
        cands.append(os.path.join(capture_dir, SIDECAR))
    for tf in trace_files:
        cands.append(os.path.join(os.path.dirname(tf), SIDECAR))
    for path in cands:
        if os.path.isfile(path):
            try:
                with open(path, encoding="utf-8") as f:
                    got = json.load(f).get("kernels")
                if isinstance(got, dict):
                    return got
            except (OSError, ValueError):
                continue
    return dict(KERNEL_PHASES)


def kernel_entry(name: str):
    """The entry point of a kernel event name (`void sweep_pass_kernel
    <8>(int const*, ...)` -> `sweep_pass`), or None."""
    s = str(name)
    if s.startswith("void "):
        s = s[5:]
    i = s.find("_kernel")
    if i <= 0:
        return None
    rest = s[i + 7:i + 8]
    if rest and (rest.isalnum() or rest == "_"):
        return None
    return s[:i]


# ------------------------------------------------------------ the parser


def _find_trace_files(capture_dir: str) -> list:
    """Trace files of the NEWEST profiler run under `capture_dir` —
    `plugins/profile/<run>/<host>.pt.trace.json.gz` is where a capture
    writes; a dir holding trace files directly, or a single trace file
    path, is accepted too (synthetic fixtures, copied captures)."""
    if os.path.isfile(capture_dir):
        return [capture_dir]
    direct = sorted(
        glob.glob(os.path.join(capture_dir, "*.trace.json.gz"))
        + glob.glob(os.path.join(capture_dir, "*.trace.json")))
    if direct:
        return direct
    runs = sorted(glob.glob(os.path.join(
        capture_dir, "plugins", "profile", "*")))
    if not runs:
        return []
    newest = runs[-1]
    return sorted(
        glob.glob(os.path.join(newest, "*.trace.json.gz"))
        + glob.glob(os.path.join(newest, "*.trace.json")))


def _load_trace(path: str) -> dict:
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8", errors="replace") as f:
            return json.load(f)
    with open(path, encoding="utf-8", errors="replace") as f:
        return json.load(f)


def _self_times(events: list) -> list:
    """Per-event SELF duration for one thread's complete events.

    Container ops (`while.N`, fusion wrappers) are emitted as events
    spanning their body ops on the SAME thread — summing raw durations
    counts the body twice. Sort by (ts, -dur) so parents precede their
    children, then a stack pass subtracts each event's duration from
    its immediate parent's self time. Returns (event, self_dur) pairs;
    self is clamped at 0 against clock jitter."""
    evs = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    out = []
    stack: list = []      # [ev_index_in_out, end_ts]
    for ev in evs:
        while stack and stack[-1][1] <= ev["ts"]:
            stack.pop()
        out.append([ev, ev["dur"]])
        if stack:
            parent = out[stack[-1][0]]
            parent[1] -= ev["dur"]
        stack.append([len(out) - 1, ev["ts"] + ev["dur"]])
    return [(ev, max(0.0, s)) for ev, s in out]


def _token_phase(ev: dict, args: dict):
    """JAX's fallback (`_event_phase` without its sidecar): the
    innermost (last-occurring) `tt.*` token in the event's own
    strings, or None."""
    hay = [str(ev.get("name", ""))]
    for v in args.values():
        if isinstance(v, str):
            hay.append(v)
    text = "/".join(hay)
    best, best_pos = None, -1
    for phase in PHASES:
        pos = text.rfind(phase)
        if pos > best_pos:
            best, best_pos = phase, pos
    return best if best_pos >= 0 else None


def _event_phase(ev: dict, ranges: list, kmap: dict):
    """One device event's phase: its innermost enclosing `tt.*` range,
    else the kernel map, else the token scan. None = unattributed."""
    if ranges:
        return ranges[-1]
    entry = kernel_entry(ev.get("name", ""))
    if entry is not None:
        phase = kmap.get(entry)
        if phase in _PHASE_SET:
            return phase
    return _token_phase(ev, ev.get("args") or {})


def _enclosing(events: list, ranges: list) -> list:
    """For each of `events` (sorted by ts) the names of the `ranges`
    (ts, end, name) that enclose it, outermost first: a sweep over both
    in time order."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out = []
    active: list = []
    j = 0
    for ev in events:
        ts, end = ev["ts"], ev["ts"] + ev["dur"]
        while j < len(ranges) and ranges[j][0] <= ts:
            active.append(ranges[j])
            j += 1
        active = [r for r in active if r[1] > ts]
        out.append([r[2] for r in active if r[1] >= end])
    return out


def attribute(capture_dir: str, top_k: int = 5) -> dict:
    """Read a torch.profiler capture and return the per-phase
    device-time table (JAX's keys):

      {"capture_dir": ..., "trace_files": [...], "n_events": N,
       "total_s": t, "phases": {"sweep": {"seconds": s, "frac": f,
                                          "top_ops": [[op, s], ...]},
                                ...},
       "unattributed_s": u, "unattributed_frac": uf,
       "unattributed_top_ops": [[op, s], ...]}

    Device events are the trace's GPU events (kernels, memcpys,
    memsets), or its cpu_op events where it has none; their SELF time
    is what is bucketed, so total_s is device time counted once. The
    `unattributed` bucket is honest: everything neither a range, the
    kernel map nor the token scan can place, reported — never
    folded."""
    trace_files = _find_trace_files(capture_dir)
    if not trace_files:
        raise FileNotFoundError(
            f"no trace.json(.gz) under {capture_dir!r} (expected a "
            f"torch.profiler capture dir: plugins/profile/<run>/)")
    kmap = _load_sidecar(capture_dir, trace_files)
    phase_s: dict = {}
    phase_ops: dict = {}
    unattr_s = 0.0
    unattr_ops: dict = {}
    n_events = 0
    for tf in trace_files:
        trace = _load_trace(tf)
        dev_by_tid: dict = {}
        cpu_by_tid: dict = {}
        gpu_ranges: dict = {}
        cpu_ranges: dict = {}
        for ev in trace.get("traceEvents", []):
            if not isinstance(ev, dict) or ev.get("ph") != "X":
                continue
            try:
                ts = float(ev["ts"])
                dur = float(ev.get("dur", 0.0))
            except (KeyError, TypeError, ValueError):
                continue
            if dur <= 0:
                continue
            cat = str(ev.get("cat", "")).lower()
            name = ev.get("name")
            pid, tid = ev.get("pid"), ev.get("tid")
            rec = {"ts": ts, "dur": dur, "name": name,
                   "args": ev.get("args") or {}}
            if cat in _DEVICE_CATS:
                dev_by_tid.setdefault((pid, tid), []).append(rec)
            elif cat == "cpu_op":
                cpu_by_tid.setdefault((pid, tid), []).append(rec)
            elif name in _PHASE_SET and cat == "gpu_user_annotation":
                gpu_ranges.setdefault(pid, []).append(
                    (ts, ts + dur, name))
            elif name in _PHASE_SET and cat == "user_annotation":
                cpu_ranges.setdefault((pid, tid), []).append(
                    (ts, ts + dur, name))
        if dev_by_tid:
            groups = [(evs, gpu_ranges.get(key[0], []))
                      for key, evs in dev_by_tid.items()]
        else:
            groups = [(evs, cpu_ranges.get(key, []))
                      for key, evs in cpu_by_tid.items()]
        for evs, ranges in groups:
            timed = [(ev, s) for ev, s in _self_times(evs) if s > 0]
            timed.sort(key=lambda p: p[0]["ts"])
            encl = _enclosing([ev for ev, _ in timed], ranges)
            for (ev, self_us), names in zip(timed, encl):
                n_events += 1
                sec = self_us / 1e6
                phase = _event_phase(ev, names, kmap)
                opname = str(ev.get("name") or "?")
                if phase is None:
                    unattr_s += sec
                    unattr_ops[opname] = unattr_ops.get(opname, 0.0) + sec
                else:
                    phase_s[phase] = phase_s.get(phase, 0.0) + sec
                    ops = phase_ops.setdefault(phase, {})
                    ops[opname] = ops.get(opname, 0.0) + sec
    total = sum(phase_s.values()) + unattr_s

    def top(ops: dict) -> list:
        return [[op, round(s, 6)] for op, s in
                sorted(ops.items(), key=lambda kv: -kv[1])[:top_k]]

    phases = {}
    for phase, sec in sorted(phase_s.items(), key=lambda kv: -kv[1]):
        phases[short(phase)] = {
            "seconds": round(sec, 6),
            "frac": round(sec / total, 4) if total else 0.0,
            "top_ops": top(phase_ops.get(phase, {}))}
    return {"capture_dir": str(capture_dir),
            "trace_files": [os.path.basename(t) for t in trace_files],
            "n_events": n_events,
            "total_s": round(total, 6),
            "phases": phases,
            "unattributed_s": round(unattr_s, 6),
            "unattributed_frac": (round(unattr_s / total, 4)
                                  if total else 0.0),
            "unattributed_top_ops": top(unattr_ops)}


# ------------------------------------------------------- publish / hook


def publish(attr: dict, registry=None, out=None, now=None) -> None:
    """Feed one attribution result into the metrics registry
    (`prof.phase_seconds.<phase>`, `prof.total_seconds`,
    `prof.unattributed_seconds` — the history ring samples them for
    free) and, when an emitter is bound (`--obs`), emit the profEntry
    record. profEntry is a TIMING record: strip_timing drops it, so
    the stream identity contract (profiling on vs off) holds by
    construction."""
    reg = obs_metrics.REGISTRY if registry is None else registry
    for name, d in attr.get("phases", {}).items():
        reg.gauge(f"prof.phase_seconds.{name}").set(d["seconds"])
    reg.gauge("prof.total_seconds").set(attr.get("total_s", 0.0))
    reg.gauge("prof.unattributed_seconds").set(
        attr.get("unattributed_s", 0.0))
    if out is None:
        return
    try:
        from timetabling_ga_tpu_torch.runtime import jsonl
        payload = {"dir": attr.get("capture_dir"),
                   "totalSeconds": attr.get("total_s", 0.0),
                   "phases": {n: {"s": d["seconds"], "frac": d["frac"],
                                  "top_ops": d.get("top_ops", [])[:3]}
                              for n, d in attr.get("phases",
                                                   {}).items()},
                   "unattributedSeconds": attr.get("unattributed_s",
                                                   0.0),
                   "unattributedFrac": attr.get("unattributed_frac",
                                                0.0)}
        ts = None
        if now is not None:
            try:
                ts = max(0.0, float(now()))
            except Exception:
                ts = None
        jsonl.prof_entry(out, payload, ts=ts)
    except Exception:
        pass   # telemetry must never fail a capture


def capture_hook(out=None, registry=None, now=None):
    """The ProfileCapture on-complete callback: write the kernel map
    into the finished capture dir, attribute it, publish gauges and
    profEntry, and return the attribution (ProfileCapture keeps it as
    `last()` for the /profile?last=1 poll `profile --attribute` rides).
    Runs on the capture WORKER thread — never the dispatch path."""

    def hook(capture_dir: str):
        write_scope_map(capture_dir)
        attr = attribute(capture_dir)
        publish(attr, registry=registry, out=out, now=now)
        return attr

    return hook


# --------------------------------------------------------- render / diff


def render(attr: dict, top_k: int = 3) -> str:
    """The ranked phase table as text (`hotspots`, `profile
    --attribute`)."""
    lines = [f"== phases ({attr.get('capture_dir', '?')}: "
             f"{attr.get('n_events', 0)} device ops, "
             f"{attr.get('total_s', 0.0):.4f}s device time)"]
    rows = list(attr.get("phases", {}).items())
    rows.sort(key=lambda kv: -kv[1]["seconds"])
    for name, d in rows:
        ops = ", ".join(f"{op} {s:.4f}s"
                        for op, s in d.get("top_ops", [])[:top_k])
        lines.append(f"  {('tt.' + name):<13} {d['seconds']:>9.4f}s "
                     f"{100 * d['frac']:>5.1f}%"
                     + (f"   {ops}" if ops else ""))
    ua = attr.get("unattributed_s", 0.0)
    uf = attr.get("unattributed_frac", 0.0)
    ops = ", ".join(f"{op} {s:.4f}s"
                    for op, s in attr.get("unattributed_top_ops",
                                          [])[:top_k])
    lines.append(f"  {'unattributed':<13} {ua:>9.4f}s "
                 f"{100 * uf:>5.1f}%" + (f"   {ops}" if ops else ""))
    return "\n".join(lines)


def diff(a: dict, b: dict) -> dict:
    """Per-phase deltas B - A between two attribution results: seconds
    delta and fraction-point delta per phase (union of both sides;
    `unattributed` included as its own row)."""
    rows = {}
    pa = dict(a.get("phases", {}))
    pb = dict(b.get("phases", {}))
    for name in sorted(set(pa) | set(pb)):
        sa = pa.get(name, {}).get("seconds", 0.0)
        sb = pb.get(name, {}).get("seconds", 0.0)
        fa = pa.get(name, {}).get("frac", 0.0)
        fb = pb.get(name, {}).get("frac", 0.0)
        rows[name] = {"a_s": sa, "b_s": sb,
                      "delta_s": round(sb - sa, 6),
                      "delta_frac_pts": round(100 * (fb - fa), 2)}
    rows["unattributed"] = {
        "a_s": a.get("unattributed_s", 0.0),
        "b_s": b.get("unattributed_s", 0.0),
        "delta_s": round(b.get("unattributed_s", 0.0)
                         - a.get("unattributed_s", 0.0), 6),
        "delta_frac_pts": round(
            100 * (b.get("unattributed_frac", 0.0)
                   - a.get("unattributed_frac", 0.0)), 2)}
    return {"a": a.get("capture_dir"), "b": b.get("capture_dir"),
            "a_total_s": a.get("total_s", 0.0),
            "b_total_s": b.get("total_s", 0.0),
            "rows": rows}


def render_diff(d: dict) -> str:
    lines = [f"== phase diff  A={d.get('a')} ({d.get('a_total_s'):.4f}s)"
             f"  B={d.get('b')} ({d.get('b_total_s'):.4f}s)"]
    rows = sorted(d.get("rows", {}).items(),
                  key=lambda kv: -abs(kv[1]["delta_s"]))
    for name, r in rows:
        label = name if name == "unattributed" else "tt." + name
        lines.append(f"  {label:<13} {r['a_s']:>9.4f}s -> "
                     f"{r['b_s']:>9.4f}s   "
                     f"{r['delta_s']:+.4f}s "
                     f"({r['delta_frac_pts']:+.1f} pts)")
    return "\n".join(lines)


# ------------------------------------------------------------ log input


def prof_entries(path: str) -> list:
    """The profEntry bodies of a JSONL record stream (newest last)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "profEntry" in rec:
                out.append(rec["profEntry"])
    return out


def _entry_to_attr(entry: dict) -> dict:
    """A profEntry body re-shaped into the attribute() result shape so
    render()/diff() serve both inputs."""
    phases = {}
    for name, d in (entry.get("phases") or {}).items():
        phases[name] = {"seconds": d.get("s", 0.0),
                        "frac": d.get("frac", 0.0),
                        "top_ops": d.get("top_ops", [])}
    total = entry.get("totalSeconds", 0.0)
    return {"capture_dir": entry.get("dir", "?"),
            "trace_files": [], "n_events": entry.get("n_events", 0),
            "total_s": total, "phases": phases,
            "unattributed_s": entry.get("unattributedSeconds", 0.0),
            "unattributed_frac": entry.get("unattributedFrac", 0.0),
            "unattributed_top_ops": []}


def _load_input(path: str) -> dict:
    """One `hotspots` input: a capture dir (or trace file) is attributed
    fresh; a JSONL log yields its NEWEST profEntry."""
    if os.path.isdir(path):
        return attribute(path)
    if path.endswith((".json.gz", ".trace.json")):
        return attribute(path)
    entries = prof_entries(path)
    if entries:
        return _entry_to_attr(entries[-1])
    # not a log with profEntries — try it as a raw trace file
    return attribute(path)


# ------------------------------------------------------------------ CLI


def main_hotspots(argv) -> int:
    """`hotspots <capture-dir|log.jsonl> [--top K] [--json]` /
    `hotspots --diff A B` — ranked phase/op table from a capture dir or
    a log's profEntry records; --diff prints per-phase deltas between
    two captures. Stdlib-only and device-free (JAX's usage text, byte
    for byte)."""
    args = list(argv)
    top_k, as_json, diff_pair, inputs = 3, False, None, []
    i = 0
    while i < len(args):
        a = args[i]
        if a in ("-h", "--help"):
            print("usage: tt hotspots <capture-dir|records.jsonl> "
                  "[--top K] [--json]\n"
                  "       tt hotspots --diff A B [--json]\n\n"
                  "rank device time by tt.* phase from a jax.profiler "
                  "capture dir (plugins/profile/...) or from a log's "
                  "profEntry records; --diff prints per-phase deltas "
                  "B - A (each side a capture dir or log)")
            return 0
        if a == "--top":
            if i + 1 >= len(args):
                raise SystemExit("flag --top needs a value")
            top_k = int(args[i + 1])
            i += 2
            continue
        if a == "--json":
            as_json = True
            i += 1
            continue
        if a == "--diff":
            if i + 2 >= len(args):
                raise SystemExit("--diff needs two inputs: A B")
            diff_pair = (args[i + 1], args[i + 2])
            i += 3
            continue
        inputs.append(a)
        i += 1
    try:
        if diff_pair is not None:
            d = diff(_load_input(diff_pair[0]),
                     _load_input(diff_pair[1]))
            print(json.dumps(d) if as_json else render_diff(d))
            return 0
        if len(inputs) != 1:
            raise SystemExit("usage: tt hotspots "
                             "<capture-dir|records.jsonl> [--top K] "
                             "[--json]  (or --diff A B)")
        attr = _load_input(inputs[0])
        print(json.dumps(attr) if as_json
              else render(attr, top_k=top_k))
        return 0
    except FileNotFoundError as e:
        print(f"tt hotspots: {e}", file=sys.stderr)
        return 1
