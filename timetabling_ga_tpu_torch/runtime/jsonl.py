"""JSONL reporting protocol (copy of timetabling_ga_tpu/runtime/jsonl.py
:42-52, 265-400, 552-621): one compact JSON object per line, the
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
                                            a serve `stats` request

On the serve path logEntry, solution and runEntry carry the job's id as
`job`. `best` is scv when feasible, else hcv*1e6+scv. threadID is 0: an
island's breeding is one batched launch with no thread identity.
Writes are synchronous.
"""

from __future__ import annotations

import json
from typing import IO, List, Optional


def _write(stream: IO, obj: dict) -> dict:
    stream.write(json.dumps(obj, separators=(",", ":")) + "\n")
    stream.flush()
    return obj


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


def metrics_entry(stream: IO, snapshot: dict, ts=None) -> None:
    """One metrics-registry snapshot (obs/metrics.py
    MetricsRegistry.snapshot; JAX jsonl.py:386), `ts` optional. A
    TIMING_RECORDS member."""
    rec = dict(snapshot)
    if ts is not None:
        rec["ts"] = round(max(0.0, float(ts)), 6)
    _write(stream, {"metricsEntry": rec})


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
    level, `time` seconds into the trial. The port writes it for the
    quality telemetry's stall and kick events (site "quality") and for
    the serve path's seams, each tagged `job`: a warm start (site
    "fleet", action "resume", with the wire's `gens` and `chunks`), a
    refused wire (site "resume", action "replay") and a demoted edit
    (site "edit", action "demote"); recovery and level are 0: it has no
    supervisor yet. A TIMING_RECORDS member, so strip_timing drops it."""
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
