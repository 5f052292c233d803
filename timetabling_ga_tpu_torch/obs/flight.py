"""The flight recorder: bounded black-box rings and automatic incident
bundles (port of timetabling_ga_tpu/obs/flight.py, under the same
names; the bundle files are JAX's, and either package's `incident`
reader renders the other's).

When something goes wrong in a long solve or a serve replica, the
question is "what happened in the 30 seconds BEFORE that". The recorder
keeps the answer on hand, bounded:

  SPAN TEE RING     the last spans the process emitted, under a byte
                    budget (`TT_FLIGHT_SPAN_BYTES`, default 256 KiB)
  RECORD RING       the last non-span records (logEntry / jobEntry /
                    faultEntry / metricsEntry ...), count-bounded
                    (`TT_FLIGHT_RECORDS_CAP`, default 512)

Both rings are fed by a TEE on the record stream (`FlightRecorder.tee`
wraps the stream the AsyncWriter drains into, so ingestion runs on the
WRITER thread) at O(1) a record. The tee writes nothing and reorders
nothing: the JSONL stream is the same with the recorder on or off.

TRIGGERS — when one fires, the recorder's own daemon thread (fault
site `flight_dump`: hang parks it, die ends it; dispatch and the
writer's drain never wait on it) dumps a self-contained INCIDENT BUNDLE
into `--incident-dir`:

  - a `/readyz` reason flips ON (the recorder polls obs/http.readiness
    over the registry);
  - a `faultEntry` lands on the record stream (recoveries, injected
    faults, quantum requeues — seen by the tee);
  - an owner calls `trigger(reason)` directly.

Dumps are rate-limited by `--incident-min-interval` (a storm of reasons
gives one bundle, deferred, never dropped) and retained oldest-first
under `TT_INCIDENT_KEEP` bundles a directory. A bundle carries the
trigger and readiness reasons, the config fingerprint, a registry
snapshot, the history window (obs/history.py), both rings and the
`device.mem_*` series. A bundle that names peers (`trigger(reason,
peers)` with a `peers_fn`) pulls their bundles and stitches one
timeline: the fleet gateway's, at a failover or an SLO burn.
`incident DIR` renders a bundle as Perfetto-loadable JSON, and `trace`
reads bundles next to JSONL logs.

Stdlib only, no torch: the `incident` reader runs on any machine a
bundle was copied to.
"""

from __future__ import annotations

import atexit
import collections
import hashlib
import itertools
import json
import os
import sys
import threading
import time

from timetabling_ga_tpu_torch.obs import http as obs_http
from timetabling_ga_tpu_torch.obs import metrics as obs_metrics
from timetabling_ga_tpu_torch.obs import trace_export

BUNDLE_VERSION = 1

# per-process recorder ordinal: two recorders in ONE process (a
# gateway plus in-proc replicas sharing a directory) must not collide
# on pid+seq filenames — the second os.replace would silently clobber
# the first's bundle
_RECORDER_IDS = itertools.count(1)

# span tee ring byte budget and record ring capacity (module docstring)
SPAN_BYTES = int(os.environ.get("TT_FLIGHT_SPAN_BYTES",
                                str(256 * 1024)))
RECORDS_CAP = int(os.environ.get("TT_FLIGHT_RECORDS_CAP", "512"))
# bundles retained per --incident-dir (oldest-first deletion)
INCIDENT_KEEP = int(os.environ.get("TT_INCIDENT_KEEP", "16"))
# history window captured into a bundle (seconds)
BUNDLE_HISTORY_S = float(os.environ.get("TT_FLIGHT_HISTORY_S", "120"))


def _faults():
    from timetabling_ga_tpu_torch.runtime import faults
    return faults


def config_fingerprint(cfg) -> dict:
    """A small, self-contained identity for the process's configuration
    — enough to tell two incident bundles apart ("was that the pop-256
    run?") without shipping the instance data. Values are stringified
    (a bundle must always serialize); the md5 is over the sorted field
    reprs, so two processes with identical flags fingerprint equal."""
    import dataclasses
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        items = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}
    elif isinstance(cfg, dict):
        items = dict(cfg)
    else:
        items = dict(vars(cfg)) if hasattr(cfg, "__dict__") else {}
    values = {}
    for k in sorted(items):
        v = items[k]
        if isinstance(v, (str, int, float, bool)) or v is None:
            values[k] = v
        else:
            values[k] = repr(v)[:200]
    blob = repr(sorted((k, repr(v)) for k, v in values.items()))
    return {"kind": type(cfg).__name__,
            "md5": hashlib.md5(blob.encode()).hexdigest()[:12],
            "values": values}


def _approx_bytes(obj) -> int:
    """Cheap serialized-size estimate for the span ring's byte budget.
    Deliberately NOT json.dumps: ring accounting runs on the writer
    thread per span, and bundle serialization stays off the hot paths —
    an estimate within ~20% is plenty for a retention budget."""
    if isinstance(obj, dict):
        return 2 + sum(len(str(k)) + 4 + _approx_bytes(v)
                       for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return 2 + sum(2 + _approx_bytes(v) for v in obj)
    if isinstance(obj, str):
        return len(obj) + 2
    return 8


class FlightTee:
    """Record-stream tee feeding a FlightRecorder's rings.

    Sits between the AsyncWriter and the real output stream (the fleet
    JobTail's position and discipline): every byte passes through
    unchanged, each complete line is parsed ON THE WRITER THREAD and
    handed to the recorder as a dict. Adds no records, reorders
    nothing — the stream is bit-identical with the tee on or off."""

    def __init__(self, stream, recorder: "FlightRecorder"):
        self._stream = stream
        self._rec = recorder
        self._buf = ""

    def write(self, s: str) -> None:
        self._stream.write(s)
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec:
                self._rec.note_record(rec)

    def flush(self) -> None:
        self._stream.flush()


class FlightRecorder:
    """The black-box rings + the incident-dump daemon thread.

    `note_record` (writer thread, via FlightTee) feeds the rings and
    latches faultEntry triggers; `trigger` (any thread) requests a dump
    directly; the recorder THREAD polls readiness, merges pending
    triggers, applies the rate limit, and performs every file write —
    dumps belong on this thread and nowhere else."""

    def __init__(self, incident_dir: str, registry=None, history=None,
                 min_interval_s: float = 30.0, process: str = "engine",
                 config=None, tracer=None, peers_fn=None,
                 span_bytes: int | None = None,
                 records_cap: int | None = None,
                 keep: int | None = None, readiness_fn=None,
                 poll_every: float = 0.25, now=time.monotonic):
        self.dir = incident_dir
        os.makedirs(incident_dir, exist_ok=True)
        self._reg = (obs_metrics.REGISTRY if registry is None
                     else registry)
        self.history = history
        self.min_interval = max(0.0, float(min_interval_s))
        self.process = process
        self._config = (config_fingerprint(config)
                        if config is not None else None)
        self.tracer = tracer
        self._peers_fn = peers_fn
        self._span_budget = int(span_bytes if span_bytes is not None
                                else SPAN_BYTES)
        self._rec_cap = int(records_cap if records_cap is not None
                            else RECORDS_CAP)
        self.keep = int(keep if keep is not None else INCIDENT_KEEP)
        self._readiness = (readiness_fn if readiness_fn is not None
                           else (lambda: obs_http.readiness(self._reg)))
        self._poll_every = max(0.02, float(poll_every))
        self._now = now
        self._epoch = now()   # bundle `ts` domain: seconds since the
        #                       recorder came up (raw monotonic would
        #                       read as tens of thousands of seconds)
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque()
        self._span_bytes = 0
        self.span_bytes_hw = 0          # high-water (bench extra.flight)
        self._spans_dropped = 0
        self._records: collections.deque = collections.deque(
            maxlen=self._rec_cap)
        self._records_seen = 0
        self._pending: list = []        # (trigger, t_trig, peers)
        self._prev_reasons = None       # None until the FIRST good
        #                                 readiness poll seeds the
        #                                 baseline: flip-edge detection
        #                                 must not read boot-time state
        #                                 (a gateway's replicas are
        #                                 always unprobed for its first
        #                                 seconds) as a fresh incident
        self._last_dump = None
        self._defer_counted = False     # rate_limited counted once
        #                                 per deferral stretch, not
        #                                 once per 0.25 s re-check
        self._dump_retries = 0          # failed-dump requeue budget
        #                                 for the CURRENT batch
        self._rid = next(_RECORDER_IDS)
        self._seq = 0
        self.latest_path = None
        self._latest = None             # newest bundle, in memory (the
        #                                 /v1/incident payload — served
        #                                 without file I/O)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="tt-flight", daemon=True)

    # -- ring feeds (writer thread) -------------------------------------

    def note_record(self, rec: dict) -> None:
        """One parsed record off the stream tee: spans into the
        byte-budget ring, everything else into the record ring; a
        faultEntry latches a dump trigger (performed on the recorder
        thread, never here)."""
        span = rec.get("spanEntry")
        with self._lock:
            if span is not None:
                n = _approx_bytes(span)
                self._spans.append((span, n))
                self._span_bytes += n
                while (self._span_bytes > self._span_budget
                       and len(self._spans) > 1):
                    _, dn = self._spans.popleft()
                    self._span_bytes -= dn
                    self._spans_dropped += 1
                if self._span_bytes > self.span_bytes_hw:
                    self.span_bytes_hw = self._span_bytes
                return
            self._records_seen += 1
            self._records.append(rec)
            fault = rec.get("faultEntry")
            if fault is not None:
                self._pending.append(
                    (f"fault:{fault.get('site', '?')}/"
                     f"{fault.get('action', '?')}",
                     self._now(), ()))
        if fault is not None:
            self._reg.counter("flight.triggers").inc()
            self._wake.set()

    def trigger(self, reason: str, peers=()) -> None:
        """Request an incident dump (any thread; cheap — the recorder
        thread does the work). `peers` names replicas whose bundles a
        gateway dump should pull and stitch."""
        with self._lock:
            self._pending.append((str(reason), self._now(),
                                  tuple(peers)))
        self._reg.counter("flight.triggers").inc()
        self._wake.set()

    def tee(self, stream):
        """Wrap `stream` so its records feed the rings (writer-thread
        ingestion — see FlightTee)."""
        return FlightTee(stream, self)

    def bind_tracer(self, tracer) -> None:
        """Late-bind the span tracer the `flight_dump` spans ride
        (construction order: the recorder must exist before the writer
        it tees, the tracer only after)."""
        self.tracer = tracer

    # -- the recorder thread --------------------------------------------

    def start(self) -> "FlightRecorder":
        self._thread.start()
        atexit.register(self.close)
        return self

    def alive(self) -> bool:
        return self._thread.is_alive()

    def poll_once(self, flush: bool = False) -> bool:
        """One trigger-detection + dump tick; False when the thread
        should exit (injected death). Testable without the thread.
        `flush` bypasses the rate limit — the shutdown drain's mode,
        so a deferred incident never dies with the process."""
        if sys.is_finalizing():
            return False
        # readiness-flip detection: any reason not present last tick is
        # a fresh incident (a CLEARED reason is recovery, not an
        # incident). readiness() reads one registry snapshot — the same
        # pure-observer discipline as the /readyz handler.
        try:
            _, detail = self._readiness()
            reasons = set(detail.get("reasons", ()))
        except Exception:
            # one torn poll must NOT clear _prev_reasons: a still-on
            # reason would otherwise re-read as "freshly flipped" on
            # the next good poll and dump a duplicate incident for a
            # condition that never changed
            reasons = None
        with self._lock:
            hw = self.span_bytes_hw
        # ring occupancy high-water as a gauge (recorder thread — the
        # bench extra.flight leg reads it back after the run)
        self._reg.gauge("flight.span_ring_bytes_hw").set(hw)
        if reasons is not None:
            if self._prev_reasons is None:
                # first good poll: seed the baseline, trigger nothing
                # (module docstring — a condition already on at boot
                # is /readyz's business; the recorder watches FLIPS)
                self._prev_reasons = reasons
            else:
                new = reasons - self._prev_reasons
                self._prev_reasons = reasons
                if new:
                    with self._lock:
                        for r in sorted(new):
                            self._pending.append(
                                (f"reason:{r}", self._now(), ()))
                    self._reg.counter("flight.triggers").inc(len(new))
        else:
            reasons = self._prev_reasons or set()
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return True
        peers: list = []
        for _, _, ps in pending:
            for p in ps:
                if p not in peers:
                    peers.append(p)
        now = self._now()
        if (self._last_dump is not None
                and now - self._last_dump < self.min_interval
                and not peers and not flush):
            # DEFER, never drop: the rate limit exists so a storm
            # yields ONE bundle, not ZERO — a distinct new incident
            # inside the interval (its reason already merged into
            # _prev_reasons, its faultEntry already consumed) would
            # otherwise leave no bundle at all. Re-queued triggers
            # dump as one merged bundle when the interval elapses.
            # Peer-carrying triggers (the gateway's failover/burn
            # correlation dumps) BYPASS the limit outright: losing
            # the one stitched bundle a failover asked for because a
            # reason flapped seconds earlier would defeat the
            # recorder's whole purpose.
            with self._lock:
                self._pending = pending + self._pending
            if not self._defer_counted:
                self._defer_counted = True
                self._reg.counter("flight.rate_limited").inc(
                    len(pending))
            return True
        self._defer_counted = False
        trigger, t_trig, _ = pending[0]
        if peers:
            # name the dump after the trigger that brought the peers
            trigger, t_trig, _ = next(
                p for p in pending if p[2])
        try:
            # the dump's fault site: a `hang` parks THIS thread only
            # (no bundle materializes; dispatch and settlement run on),
            # a `die` ends it — tests pin the isolation
            _faults().maybe_fail("flight_dump")
            self._dump(trigger, t_trig, peers, sorted(reasons))
            self._dump_retries = 0
        except SystemExit:
            return False
        except Exception as e:
            self._reg.counter("flight.dump_errors").inc()
            print(f"warning: flight recorder dump failed: "
                  f"{str(e)[:160]}", file=sys.stderr)
            if self._dump_retries < 3:
                # defer-never-drop applies to FAILED dumps too: a
                # transiently unwritable --incident-dir (ENOSPC for a
                # second mid-failover) must not eat the incident —
                # re-queue the batch and retry next tick, bounded so a
                # permanently dead disk degrades to the warning above
                self._dump_retries += 1
                with self._lock:
                    self._pending = pending + self._pending
            else:
                self._dump_retries = 0
        return True

    def _loop(self) -> None:
        while True:
            if not self.poll_once():
                return
            if self._stop.is_set():
                # close() raced the poll above: a trigger enqueued
                # DURING it (the drained writer's last faultEntry —
                # an abort's, say) is still pending; one final FLUSH
                # tick (still on THIS thread, so the flight_dump
                # isolation contract holds; flush bypasses the rate
                # limit so a deferred incident is not dropped either)
                # gets it its bundle instead of dying with the queue
                self.poll_once(flush=True)
                return
            self._wake.wait(self._poll_every)
            self._wake.clear()
            if self._stop.is_set():
                self.poll_once(flush=True)   # same final drain
                return

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread.ident is not None:   # never-started: no join
            self._thread.join(timeout=2.0)   # hung dumper: abandoned
            #                                  daemon, never waited out
        atexit.unregister(self.close)

    # -- bundle assembly (recorder thread only) -------------------------

    def _core(self, trigger: str, t_trig: float, reasons: list) -> dict:
        with self._lock:
            spans = [dict(s) for s, _ in self._spans]
            records = [dict(r) for r in self._records]
            spans_dropped = self._spans_dropped
            rec_dropped = max(0, self._records_seen
                              - len(self._records))
        hist = None
        mem = {}
        if self.history is not None:
            hist = self.history.window(BUNDLE_HISTORY_S)
            mem = {n: s for n, s in hist.get("series", {}).items()
                   if n.startswith("device.mem_")}
        core = {"version": BUNDLE_VERSION, "process": self.process,
                "pid": os.getpid(), "trigger": trigger,
                "reasons": reasons,
                "ts": round(t_trig - self._epoch, 6),
                "unix_time": round(time.time(), 3),
                "config": self._config,
                "metrics": self._reg.snapshot(),
                "history": hist, "mem": mem,
                "spans": spans, "records": records,
                "spans_dropped": spans_dropped,
                "records_dropped": rec_dropped}
        return core

    def _dump(self, trigger: str, t_trig: float, peers: list,
              reasons: list) -> None:
        core = self._core(trigger, t_trig, reasons)
        if peers and self._peers_fn is not None:
            fetched = []
            for label, bundle, err in self._peers_fn(peers):
                fetched.append({"label": label, "incident": bundle,
                                "error": err})
            core["stitched"] = True
            core["peers"] = fetched
            # ONE cross-process timeline, by the same stitching rules
            # as `tt trace` (pid per process lane, XFLOW ids kept
            # verbatim, local flows remapped per input): the bundle is
            # directly Perfetto-loadable via `tt incident`
            core["trace"] = trace_export.export_stitched(
                bundle_records(core))
        self._seq += 1
        slug = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in trigger)[:48]
        # pid + per-process recorder ordinal + seq: unique across
        # processes AND across several recorders sharing one directory
        # within a process (in-proc fleets)
        path = os.path.join(
            self.dir, f"incident-{os.getpid()}.{self._rid}-"
                      f"{self._seq:04d}-{slug}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"incident": core}, fh)
        os.replace(tmp, path)
        self._retain()
        self._last_dump = self._now()
        with self._lock:
            self._latest = core
            self.latest_path = path
        self._reg.counter("flight.dumps").inc()
        # time-to-dump: trigger instant -> bundle on disk (what the
        # "how fast is the black box" question actually asks)
        self._reg.histogram("flight.dump_seconds").observe(
            max(0.0, self._now() - t_trig),
            exemplar={"trigger": trigger})
        tracer = self.tracer
        if tracer is not None and getattr(tracer, "enabled", False):
            try:
                # time-to-dump: trigger instant -> bundle on disk (the
                # `tt stats` "== incidents" latency source)
                tracer.record("flight_dump", t_trig,
                              self._now() - t_trig, cat="flight",
                              trigger=trigger,
                              path=os.path.basename(path))
            except Exception:
                pass   # a dying writer must not fail the dump

    def _retain(self) -> None:
        """Oldest-first retention: at most `keep` bundles in the
        directory (by mtime — robust across process restarts)."""
        try:
            paths = sorted(_bundle_paths(self.dir),
                           key=lambda p: (os.path.getmtime(p), p))
            for p in paths[:max(0, len(paths) - self.keep)]:
                os.unlink(p)
        except OSError:
            pass

    def latest(self) -> dict | None:
        """The newest bundle, in memory — the replica/gateway
        `GET /v1/incident` payload (read-only: no file I/O on the
        handler thread)."""
        with self._lock:
            return self._latest


def wire(cfg, out, registry=None, process: str = "engine",
         peers_fn=None, now=time.monotonic,
         history_always: bool = False):
    """The one wiring engine.run, SolveService.__init__ and the fleet
    Gateway share: build the history ring (under any obs surface, or
    always for a gateway), the recorder, and the teed record sink.
    Returns (history, flight, sink); the caller still owns
    `bind_tracer(...)` + `start()` (the tracer exists only after the
    writer the sink feeds) and the teardown ordering. If the recorder's
    construction fails, the just-started sampler is closed before the
    error propagates — no half-wired thread leaks. `peers_fn` is the
    gateway's pull of its replicas' bundles (stitched dumps)."""
    history = None
    if cfg.history_every > 0 and (
            history_always or getattr(cfg, "obs", False)
            or getattr(cfg, "obs_listen", None) or cfg.incident_dir):
        from timetabling_ga_tpu_torch.obs import history as obs_history
        history = obs_history.HistoryRing(
            registry=registry, every_s=cfg.history_every,
            now=now).start()
    flight = None
    sink = out
    if cfg.incident_dir:
        try:
            flight = FlightRecorder(
                cfg.incident_dir, registry=registry, history=history,
                min_interval_s=cfg.incident_min_interval,
                process=process, config=cfg, peers_fn=peers_fn,
                now=now)
        except BaseException:
            if history is not None:
                history.close()
            raise
        if sink is not None:
            sink = flight.tee(sink)
    return history, flight, sink


def incident_response(flight) -> tuple:
    """THE `GET /v1/incident` (status, body) — shared by the replica
    and gateway Api surfaces (fleet/replicas.py, fleet/gateway.py) so
    the wire shape cannot drift between them. Read-only over the
    recorder's in-memory `latest()`; no file I/O on the handler
    thread."""
    if flight is None:
        return 404, {"error": "no flight recorder wired "
                              "(--incident-dir)"}
    core = flight.latest()
    if core is None:
        return 404, {"error": "no incident recorded yet"}
    return 200, {"incident": core}


# -------------------------------------------------- bundle -> records


def bundle_records(core: dict) -> list:
    """An incident bundle's processes as `tt trace` inputs:
    [(label, records), ...] where records are ordinary JSONL record
    dicts (spanEntry bodies re-wrapped + the record ring verbatim).
    A stitched bundle contributes one input per process — the same
    pid-lane layout `export_stitched` gives a fleet's log files."""
    def recs(c: dict) -> list:
        return ([{"spanEntry": dict(s)} for s in c.get("spans", ())]
                + [dict(r) for r in c.get("records", ())])

    inputs = [(str(core.get("process", "?")), recs(core))]
    for p in core.get("peers", ()) or ():
        inc = p.get("incident")
        if inc:
            inputs.append((str(p.get("label", "?")), recs(inc)))
    return inputs


def load_bundle(path: str) -> dict:
    """Read one bundle file; returns the inner `incident` object.
    Raises ValueError on anything that is not a bundle."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    core = doc.get("incident") if isinstance(doc, dict) else None
    if not isinstance(core, dict):
        raise ValueError(f"{path}: not an incident bundle "
                         f"(no 'incident' object)")
    return core


def _bundle_paths(dir_path: str) -> list:
    """incident-*.json files EXCLUDING `tt incident`'s own rendered
    `*.trace.json` artifacts — those would otherwise be re-picked as
    'the newest bundle' (and counted against retention) once a render
    lands in the incident directory."""
    return [os.path.join(dir_path, n) for n in os.listdir(dir_path)
            if n.startswith("incident-") and n.endswith(".json")
            and not n.endswith(".trace.json")]


def list_bundles(dir_path: str) -> list:
    """Bundle paths in a directory, oldest first (mtime order — the
    retention order)."""
    return sorted(_bundle_paths(dir_path),
                  key=lambda p: (os.path.getmtime(p), p))


def summarize_bundle(core: dict, path: str | None = None) -> str:
    """One human block per bundle — what `tt incident` prints."""
    lines = []
    head = f"== incident: {core.get('trigger', '?')}"
    if path:
        head += f"  ({os.path.basename(path)})"
    lines.append(head)
    lines.append(f"  process {core.get('process', '?')} "
                 f"pid {core.get('pid', '?')} "
                 f"v{core.get('version', '?')} "
                 f"ts {core.get('ts', 0.0):.1f}s")
    if core.get("reasons"):
        lines.append(f"  readiness reasons: "
                     f"{', '.join(core['reasons'])}")
    cfg = core.get("config") or {}
    if cfg:
        lines.append(f"  config {cfg.get('kind', '?')} "
                     f"md5 {cfg.get('md5', '?')}")
    lines.append(
        f"  rings: {len(core.get('spans', ()))} spans "
        f"(+{core.get('spans_dropped', 0)} dropped), "
        f"{len(core.get('records', ()))} records "
        f"(+{core.get('records_dropped', 0)} dropped)")
    hist = core.get("history") or {}
    if hist:
        lines.append(f"  history: {len(hist.get('series', {}))} series"
                     f" @ {hist.get('every_s', '?')}s cadence")
    mets = core.get("metrics") or {}
    counters = mets.get("counters") or {}
    for name in ("engine.recoveries", "serve.jobs_failed",
                 "fleet.jobs_failed_over", "faults.injected"):
        if counters.get(name):
            lines.append(f"  {name}: {counters[name]}")
    peers = core.get("peers") or ()
    if peers:
        got = sum(1 for p in peers if p.get("incident"))
        lines.append(f"  stitched: {got}/{len(peers)} peer bundle(s) "
                     + ", ".join(str(p.get("label")) for p in peers))
    faults = [r["faultEntry"] for r in core.get("records", ())
              if "faultEntry" in r]
    if faults:
        last = faults[-1]
        lines.append(f"  last fault: {last.get('site')}/"
                     f"{last.get('action')} "
                     f"{str(last.get('error', ''))[:80]}")
    return "\n".join(lines)


# ------------------------------------------------------- tt incident


def main_incident(argv) -> int:
    """`tt incident <dir-or-bundle.json> [--job ID] [-o trace.json]
    [--list]` — summarize incident bundles and render one (the newest,
    or the named file) as Perfetto-loadable Chrome trace JSON via the
    same stitching rules as `tt trace`. Stdlib only, no torch."""
    target, out, job, list_only = None, None, None, False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print("usage: tt incident <dir-or-bundle.json> [--job ID] "
                  "[-o trace.json] [--list]\n\n"
                  "summarize the flight recorder's incident bundles "
                  "(--incident-dir) and export the newest (or the\n"
                  "named bundle) as Chrome trace-event JSON — a "
                  "stitched gateway bundle renders the cross-process\n"
                  "timeline (gateway + replica lanes, XFLOW arrows); "
                  "--job ID filters to one job's chain; --list only\n"
                  "lists the directory's bundles")
            return 0
        if a == "--list":
            list_only = True
            i += 1
            continue
        if a in ("-o", "--job"):
            if i + 1 >= len(argv):
                raise SystemExit(f"flag {a} needs a value")
            if a == "-o":
                out = argv[i + 1]
            else:
                job = argv[i + 1]
            i += 2
            continue
        if a.startswith("-"):
            raise SystemExit(f"unknown argument: {a}")
        if target is not None:
            raise SystemExit("tt incident takes one directory or "
                             "bundle file")
        target = a
        i += 1
    if target is None:
        raise SystemExit("usage: tt incident <dir-or-bundle.json> "
                         "[--job ID] [-o trace.json] [--list]")
    if os.path.isdir(target):
        paths = list_bundles(target)
        if not paths:
            raise SystemExit(f"no incident bundles in {target} "
                             f"(incident-*.json)")
        if list_only:
            for p in paths:
                try:
                    core = load_bundle(p)
                except ValueError as e:
                    print(f"  {os.path.basename(p)}: {e}")
                    continue
                print(f"  {os.path.basename(p)}: "
                      f"{core.get('trigger', '?')} "
                      f"({len(core.get('spans', ()))} spans, "
                      f"{len(core.get('records', ()))} records"
                      + (", stitched" if core.get("stitched") else "")
                      + ")")
            return 0
        path = paths[-1]              # newest
    else:
        path = target
    core = load_bundle(path)
    print(summarize_bundle(core, path))
    doc = trace_export.export_stitched(bundle_records(core), job=job)
    if out is None:
        out = path + ".trace.json"
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    n = len(doc["traceEvents"])
    tag = f" (job {job})" if job is not None else ""
    print(f"tt incident: {n} trace event{'s' if n != 1 else ''}{tag} "
          f"-> {out}", file=sys.stderr)
    return 0
