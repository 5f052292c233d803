"""JSONL reporting protocol (copy of timetabling_ga_tpu/runtime/jsonl.py
:42-262, 265-426, 527-550, 552-621): one compact JSON object per line, the
reference's field names (ga.cpp:169-257, 469-470, 604-607).

  {"logEntry":{"procID":i,"threadID":0,"best":b,"time":s}}
  {"solution":{"procID":i,"threadID":0,"totalTime":s,"totalBest":b,
               "feasible":f[,"timeslots":[...],"rooms":[...]]}}
  {"runEntry":{"totalBest":b,"feasible":f}} then the same with
               procsNum/threadsNum/totalTime appended
  {"phase":{"name":n,"trial":k,"seconds":s,...}}   under --trace only
  {"faultEntry":{"site":...,"action":...,"error":...,"trial":k,
                 "recovery":r,"level":l,"time":s,...}}   always
  {"jobEntry":{"job":id,"event":e,...}}     the serve path's lifecycle
  {"metricsEntry":{"counters":...,"gauges":...,"histograms":...}}
                                            a serve `stats` request, and
                                            every --metrics-every
                                            dispatches under --obs
  {"spanEntry":{"name":n,"cat":c,"ts":s,"dur":s,"depth":d,"tid":t,...}}
                                            a host timing span (--obs)
  {"qualityEntry":{"quality.*":...,"ts":s[,"job":id]}}
                                            --obs --quality
  {"usageEntry":{"dispatch":n,"gens":g,...,"lanes":[...]}}
                                            the serve path's meter
                                            (--obs, metering on)

On the serve path logEntry, solution and runEntry carry the job's id as
`job`. `best` is scv when feasible, else hcv*1e6+scv. threadID is 0: an
island's breeding is one batched launch with no thread identity.

The engine and the serve path write through an `AsyncWriter`: a
background thread behind a bounded queue, so a dispatch never waits on
the disk; `submit` queues a job (a checkpoint's npz write) in order with
the records around it.
"""

from __future__ import annotations

import json
import queue
import threading
from typing import IO, List, Optional

from timetabling_ga_tpu_torch.runtime import faults


def _write(stream: IO, obj: dict) -> dict:
    stream.write(json.dumps(obj, separators=(",", ":")) + "\n")
    stream.flush()
    return obj


class AsyncWriter:
    """A file-like writer whose lines a background thread hands to
    `stream` (JAX jsonl.py:53). Each `write` enqueues one whole record
    line, which the worker writes and flushes in one call, so a killed
    run leaves whole records. `submit(job)` enqueues a callable on the
    same queue. `drain` and `close` block until everything queued is
    written; an error on the worker (a full disk) is raised on the
    producer at its next write, submit, drain or close. The queue is
    bounded (backpressure), and every wait on it checks that the worker
    is alive, so a dead worker raises instead of hanging the producer.
    The worker fires the fault site `site` once per dequeued item."""

    _STOP = object()

    def __init__(self, stream: IO, maxsize: int = 1024,
                 site: str = "writer"):
        self._stream = stream
        self._site = site
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._records = 0       # lines enqueued (writer.records)
        self._error = None
        self._failed = False    # a write failed mid-record: never write
        #                         again (the next line would splice)
        self._closed = False
        self._thread = threading.Thread(
            target=self._worker, name="tt-jsonl-writer", daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                faults.maybe_fail(self._site)
            except SystemExit:
                return          # an injected death: no task_done
            try:
                if item is self._STOP:
                    return
                if callable(item):
                    if self._error is None:
                        item()
                elif not self._failed:
                    try:
                        self._stream.write(item)
                        self._stream.flush()
                    except BaseException:
                        self._failed = True
                        raise
            except BaseException as e:
                self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("AsyncWriter is closed")

    def _put(self, item) -> None:
        """Enqueue in bounded waits, checking the worker is alive."""
        while True:
            if not self._thread.is_alive():
                self._raise_pending()
                raise RuntimeError(
                    "AsyncWriter worker thread died; enqueue would "
                    "never drain")
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _await_drained(self) -> None:
        """Queue.join, but raising when the worker dies meanwhile."""
        q = self._q
        with q.all_tasks_done:
            while q.unfinished_tasks:
                if not self._thread.is_alive():
                    self._raise_pending()
                    raise RuntimeError(
                        "AsyncWriter worker thread died with items "
                        "still queued")
                q.all_tasks_done.wait(0.1)

    def write(self, s: str) -> None:
        if threading.current_thread() is self._thread:
            # from a submitted job: the worker is the stream's only
            # writer and it is here, so write directly (enqueueing could
            # wait on a drain only this thread performs)
            if not self._failed:
                self._records += 1
                try:
                    self._stream.write(s)
                    self._stream.flush()
                except BaseException:
                    self._failed = True
                    raise
            return
        self._check_open()
        self._raise_pending()
        self._records += 1
        self._put(s)

    def alive(self) -> bool:
        """Whether the worker thread is alive."""
        return self._thread.is_alive()

    def qsize(self) -> int:
        """Queue occupancy: the `writer.queue_depth` pull gauge."""
        return self._q.qsize()

    @property
    def records_written(self) -> int:
        """Lines enqueued over this writer's life: the `writer.records`
        pull gauge."""
        return self._records

    def flush(self) -> None:
        """No-op: the worker flushes after every record."""

    def submit(self, job) -> None:
        """Enqueue `job()` behind every record already queued."""
        self._check_open()
        self._raise_pending()
        self._put(job)

    def drain(self) -> None:
        """Block until every queued item is written."""
        self._await_drained()
        self._raise_pending()

    def close(self, raise_error: bool = True) -> None:
        """Drain, then stop the worker; idempotent. The stream stays
        open. `raise_error=False` (on an error path) swallows a pending
        worker error so it cannot mask the run's own."""
        if not self._closed:
            self._closed = True
            try:
                self._put(self._STOP)
                self._await_drained()
            except BaseException:
                if raise_error:
                    self._thread.join(timeout=1.0)
                    raise
            self._thread.join(timeout=5.0)
        if raise_error:
            self._raise_pending()


def reported_best(hcv: int, scv: int) -> int:
    """scv when feasible, else hcv*1e6+scv (ga.cpp:205-228)."""
    return int(scv) if int(hcv) == 0 else int(hcv) * 1_000_000 + int(scv)


def log_entry(stream: IO, proc_id: int, thread_id: int, best: int,
              time_s: float, job: Optional[str] = None) -> dict:
    rec = {
        "procID": proc_id,
        "threadID": thread_id,
        "best": int(best),
        "time": max(0.0, float(time_s)),
    }
    if job is not None:
        # the serve path: one shared stream, demultiplexed by job id
        rec["job"] = str(job)
    return _write(stream, {"logEntry": rec})


def solution_record(stream: IO, proc_id: int, thread_id: int,
                    total_time: float, total_best: int, feasible: bool,
                    timeslots: Optional[List[int]] = None,
                    rooms: Optional[List[int]] = None,
                    job: Optional[str] = None) -> dict:
    rec = {
        "procID": proc_id,
        "threadID": thread_id,
        "totalTime": float(total_time),
        "totalBest": int(total_best),
        "feasible": bool(feasible),
    }
    if feasible:
        rec["timeslots"] = [int(x) for x in timeslots]
        rec["rooms"] = [int(x) for x in rooms]
    if job is not None:
        rec["job"] = str(job)
    return _write(stream, {"solution": rec})


def job_entry(stream: IO, job: str, event: str, **extra) -> dict:
    """The serve path's lifecycle record (JAX jsonl.py:308): one line per
    job transition — admitted, rejected, started, done, failed,
    cancelled — with its context in `extra` (bucket, generation counts,
    a rejection's reason; an edit job's `mode`, `edit_of`, `demoted` and,
    when done, `edit_distance`). No wall-clock field: strip_timing keeps
    it."""
    rec = {"job": str(job), "event": str(event)}
    for k, v in extra.items():
        rec[k] = v
    return _write(stream, {"jobEntry": rec})


def span_entry(stream: IO, name: str, cat: str, ts: float, dur: float,
               depth: int = 0, tid: int = 0, **extra) -> None:
    """One host-side timing span (obs/spans.py): `ts` seconds since the
    tracer epoch, `dur` its length, `depth` its nesting on thread `tid`.
    A timing record: strip_timing drops it."""
    rec = {"name": str(name), "cat": str(cat),
           "ts": round(max(0.0, float(ts)), 6),
           "dur": round(max(0.0, float(dur)), 6),
           "depth": int(depth), "tid": int(tid)}
    for k, v in extra.items():
        rec[k] = v
    _write(stream, {"spanEntry": rec})


def quality_entry(stream: IO, payload: dict, ts=None,
                  job: Optional[str] = None, **extra) -> None:
    """One decoded quality block under --obs --quality: the engine's
    cross-island aggregate (obs/quality.entry_payload) or one serve
    lane's payload tagged with its job (obs/quality.lane_payload). A
    timing record: strip_timing drops it."""
    rec = dict(payload)
    if job is not None:
        rec["job"] = str(job)
    if ts is not None:
        rec["ts"] = round(max(0.0, float(ts)), 6)
    for k, v in extra.items():
        rec[k] = v
    _write(stream, {"qualityEntry": rec})


def usage_entry(stream: IO, payload: dict, ts=None) -> None:
    """The serve path's meter (obs/usage.py), under --obs with metering
    on: a dispatch's capacity split over its lanes (the lanes' shares
    sum exactly to the totals) or a settled job's cumulative meter
    (`"event": "total"`). A timing record: strip_timing drops it."""
    rec = dict(payload)
    if ts is not None:
        rec["ts"] = round(max(0.0, float(ts)), 6)
    _write(stream, {"usageEntry": rec})


def metrics_entry(stream: IO, snapshot: dict, ts=None) -> None:
    """One metrics-registry snapshot (obs/metrics.py
    MetricsRegistry.snapshot; JAX jsonl.py:386), `ts` optional. A
    TIMING_RECORDS member."""
    rec = dict(snapshot)
    if ts is not None:
        rec["ts"] = round(max(0.0, float(ts)), 6)
    _write(stream, {"metricsEntry": rec})


def cost_entry(stream: IO, program: str, **extra) -> None:
    """One program's first call of a signature under the cost
    observatory (obs/cost.py; emitted only under --obs), JAX's record:

      {"costEntry":{"program":"lane_runner","sig":"9f31c2ab44",
                    "lowerSeconds":0.0,"compileSeconds":2.31,
                    "flops":1.1e9,"bytes_accessed":3.4e7,
                    "arg_bytes":2.1e6,"out_bytes":2.1e6,
                    "intensity":32.4,"ts":5.2}}

    A TIMING_RECORDS member, so strip_timing drops it."""
    rec = {"program": str(program)}
    for k, v in extra.items():
        rec[k] = v
    _write(stream, {"costEntry": rec})


def prof_entry(stream: IO, payload: dict, ts=None, **extra) -> None:
    """One attributed profiler capture (obs/prof.py publish; emitted only
    under --obs), JAX's record:

      {"profEntry":{"dir":"tt-profile","totalSeconds":2.31,
                    "phases":{"sweep":{"s":1.1,"frac":0.47,
                                       "top_ops":[["sweep_pass_kernel",
                                                   0.8]]},
                              ...},
                    "unattributedSeconds":0.12,
                    "unattributedFrac":0.05,"ts":41.2}}

    A TIMING_RECORDS member, so strip_timing drops it."""
    rec = dict(payload)
    if ts is not None:
        rec["ts"] = round(max(0.0, float(ts)), 6)
    for k, v in extra.items():
        rec[k] = v
    _write(stream, {"profEntry": rec})


def route_entry(stream: IO, job: str, bucket, replica: str,
                outcome: str, **extra) -> None:
    """One placement decision of the fleet gateway's dispatcher (emitted
    only under the gateway's `-o LOG`), JAX's record:

      {"routeEntry":{"job":"j42","bucket":[64,8,8,64,5,9],
                     "replica":"r0","outcome":"hit","backlog":1.0,
                     "pins":2,"compile_hit_rate":0.93,"attempt":1}}

    `outcome` is the router's affinity class (hit / warm / miss,
    fleet/router.py); the extra fields are the score inputs the decision
    read. A TIMING_RECORDS member, so strip_timing drops it."""
    rec = {"job": str(job),
           "bucket": list(bucket) if bucket is not None else None,
           "replica": str(replica), "outcome": str(outcome)}
    for k, v in extra.items():
        rec[k] = v
    _write(stream, {"routeEntry": rec})


def scale_entry(stream: IO, action: str, reason: str, ts=None,
                **extra) -> dict:
    """One autoscaler decision (fleet/autoscaler.py; emitted only under
    the gateway's `-o LOG`), JAX's record:

      {"scaleEntry":{"action":"up","reason":"queue_depth",
                     "replica":"s1","live":1,"target":2,
                     "dry_run":false,"evidence":{
                       "serve.queue_depth":{"op":">=","threshold":8.0,
                                            "for_s":30.0,"mean":12.4}},
                     "ts":41.2}}

    `action` is up / down / blocked_warmth / blocked_cooldown / hold;
    `evidence` holds the window queries behind the decision (the
    numbers `scale` renders). A TIMING_RECORDS member, so strip_timing
    drops it."""
    rec = {"action": str(action), "reason": str(reason)}
    for k, v in extra.items():
        rec[k] = v
    if ts is not None:
        rec["ts"] = round(max(0.0, float(ts)), 6)
    return _write(stream, {"scaleEntry": rec})


def phase_record(stream: IO, name: str, trial: int, seconds: float,
                 **extra) -> None:
    """Per-phase host timing (extension record, --trace only)."""
    rec = {"name": name, "trial": int(trial), "seconds": float(seconds)}
    for k, v in extra.items():
        rec[k] = v
    _write(stream, {"phase": rec})


def fault_entry(stream: IO, site: str, action: str, error, trial: int,
                recovery: int, level: int, time_s: float,
                **extra) -> dict:
    """Robustness extension record (JAX jsonl.py:326), always emitted:
    one line per event, `site` the operation class, `action` what was
    done, `recovery` the recoveries so far, `level` the degradation
    level, `time` seconds into the trial. The engine's supervisor writes
    recover (with `lostGens`), degrade and restore (with `mode`) and
    abort records, the init retry a recover with `init`; the quality
    telemetry its stall and kick events (site "quality"); the serve path
    its seams, each tagged `job`: a warm start (site "fleet", action
    "resume", with the wire's `gens` and `chunks`), a refused wire (site
    "resume", action "replay"), a demoted edit (site "edit", action
    "demote"), a quantum fault (site "quantum", action "requeue" or
    "abort", with `gens`) and a failed flush (site "flush", action
    "rollback"). A TIMING_RECORDS member, so strip_timing drops it."""
    rec = {"site": str(site), "action": str(action),
           "error": str(error)[:200], "trial": int(trial),
           "recovery": int(recovery), "level": int(level),
           "time": max(0.0, float(time_s))}
    for k, v in extra.items():
        rec[k] = v
    return _write(stream, {"faultEntry": rec})


# wall-clock-dependent fields and records: two runs of one seeded
# config emit identical streams once these are stripped
TIMING_FIELDS = {"logEntry": ("time",), "solution": ("totalTime",),
                 "runEntry": ("totalTime",)}
TIMING_RECORDS = ("phase", "faultEntry", "spanEntry", "metricsEntry",
                  "costEntry", "qualityEntry", "routeEntry",
                  "usageEntry", "scaleEntry", "profEntry")


def strip_timing(records: List[dict]) -> List[dict]:
    """Protocol records minus timing-only records and timing fields."""
    out = []
    for rec in records:
        if any(k in rec for k in TIMING_RECORDS):
            continue
        rec = json.loads(json.dumps(rec))
        for kind, fields in TIMING_FIELDS.items():
            if kind in rec:
                for f in fields:
                    rec[kind].pop(f, None)
        out.append(rec)
    return out


def run_entry(stream: IO, total_best: int, feasible: bool,
              procs_num: Optional[int] = None,
              threads_num: Optional[int] = None,
              total_time: Optional[float] = None,
              job: Optional[str] = None) -> dict:
    rec = {"totalBest": int(total_best), "feasible": bool(feasible)}
    if procs_num is not None:
        rec["procsNum"] = int(procs_num)
        rec["threadsNum"] = int(threads_num)
        rec["totalTime"] = float(total_time)
    if job is not None:
        rec["job"] = str(job)
    return _write(stream, {"runEntry": rec})
