"""Job admission and lifecycle for the solver service (copy of
timetabling_ga_tpu/serve/queue.py:33-257, with the fields the port
uses: warm starts, shipping, edits, quantum-fault recoveries and load
shedding are here; usage metering, flows and the fleet's ship_hot and
preemption wait).

The backlog is bounded (admission control): a submit past it is
rejected at once rather than queued into unbounded latency. Priorities
order admission into the scheduler's lanes (higher first, then the
least-served, then arrival); a job's seed, generation budget and
deadline travel with it, so one tenant's parameters never leak into
another's stream.

    PENDING --admit--> RUNNING --quantum--> PARKED --resume--> RUNNING
       |                  |                    |
       |                  +------- budget/deadline ------> DONE
       +--cancel--> CANCELLED      (failure) ------------> FAILED
       +--backpressure (scheduler shed) ---------------> SHED

PARKED is the between-quanta state: the job's population is a host
snapshot, or, while its group stays resident, on the card.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import re
from typing import Optional

from timetabling_ga_tpu_torch.problem import Problem
from timetabling_ga_tpu_torch.serve.snapshot import SHIP_RECORDS_CAP

DEFAULT_TENANT = "default"
# no dots: JAX splices the label into dotted metric names
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_-]")


def tenant_label(tenant) -> str:
    """Canonical tenant tag (JAX obs/usage.py:121): bounded and
    metric-name safe; empty or None is DEFAULT_TENANT."""
    t = str(tenant or "").strip()
    if not t:
        return DEFAULT_TENANT
    return _LABEL_RE.sub("_", t)[:64]


class JobState:
    """String states (JSON-friendly)."""
    PENDING = "pending"
    RUNNING = "running"
    PARKED = "parked"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"
    SHED = "shed"         # released by backpressure: the lowest-priority
    #                       runnable job while a registry depth is at or
    #                       over its high-water mark

    ACTIVE = (PENDING, RUNNING, PARKED)
    TERMINAL = (DONE, FAILED, CANCELLED, SHED)


class AdmissionError(RuntimeError):
    """Backlog full or id taken: the job was NOT admitted."""


@dataclasses.dataclass
class Job:
    """One solve request plus its runtime bookkeeping."""

    id: str
    problem: Problem                  # the parsed, UNPADDED instance
    priority: int = 0                 # higher = served first
    seed: int = 0
    generations: int = 200            # total generation budget
    deadline_s: Optional[float] = None  # wall-clock bound from submit
    tenant: str = DEFAULT_TENANT      # who submitted it
    # -- runtime (owned by the scheduler) --------------------------------
    state: str = JobState.PENDING
    seq: int = 0                      # admission order (FIFO tie-break)
    padded: Optional[Problem] = None  # bucket-padded instance
    bucket: Optional[tuple] = None    # serve.bucket.bucket_key result
    pa_dev: object = None             # padded ProblemArrays on the device
    gens_done: int = 0
    chunks: int = 0                   # dispatched quanta (its generators'
    #                                   chunk word)
    snapshot: object = None           # host PopState as of its last park
    # -- warm starts and shipping (serve/snapshot.py) --------------------
    resume_wire: Optional[dict] = None  # warm-start wire given at submit
    #                                   (consumed at admission)
    ship: object = None               # ShipUnit: the last park fence's
    #                                   state and record prefix; once set
    #                                   the job's group may stay resident
    ship_records: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=SHIP_RECORDS_CAP))
    #                                   the job's records so far, a ring
    #                                   of SHIP_RECORDS_CAP
    ship_truncated: bool = False      # ship_records dropped its oldest
    resumed_at: int = 0               # gens_done restored from a wire
    recoveries: int = 0               # quantum-fault requeues so far;
    #                                   past --max-job-recoveries the job
    #                                   fails alone
    # -- incremental re-solve (serve/editsolve.py) -----------------------
    mode: str = "solve"               # "solve" | "edit"
    edit_of: Optional[str] = None     # the base job's id, when known
    edit_map: object = None           # (E_edited,) int32 base event of
    #                                   each edited event, -1 for a new one
    edit_demoted: bool = False        # a valid edit that ran cold
    best: int = 2 ** 31 - 1           # reported-form best seen
    emitted: int = 2 ** 31 - 1        # logEntry floor (no duplicates)
    submitted_t: float = 0.0
    finished_t: Optional[float] = None
    result: Optional[dict] = None
    error: Optional[str] = None

    def runnable(self) -> bool:
        return self.state in JobState.ACTIVE

    def remaining(self) -> int:
        return max(0, self.generations - self.gens_done)


class JobQueue:
    """Bounded, priority-ordered job table. Terminal jobs stay queryable
    until `forget`; `backlog` bounds only the active set."""

    def __init__(self, backlog: int = 64, now=None):
        import time
        self._backlog = backlog
        self._jobs: dict = {}
        self._seq = itertools.count()
        self._now = now or time.monotonic

    def __len__(self) -> int:
        return len(self._jobs)

    def __contains__(self, job_id: str) -> bool:
        return job_id in self._jobs

    def active(self) -> list:
        return [j for j in self._jobs.values() if j.runnable()]

    def submit(self, job: Job) -> str:
        if job.id in self._jobs:
            raise AdmissionError(f"duplicate job id {job.id!r}")
        if len(self.active()) >= self._backlog:
            raise AdmissionError(
                f"backlog full ({self._backlog} active jobs) — "
                f"job {job.id!r} rejected")
        job.seq = next(self._seq)
        job.submitted_t = self._now()
        job.state = JobState.PENDING
        self._jobs[job.id] = job
        return job.id

    def get(self, job_id: str) -> Job:
        return self._jobs[job_id]

    def cancel(self, job_id: str) -> bool:
        """Cancel a job: at once when pending or parked; a running job's
        cancel takes effect at the next control fence (a quantum is
        never interrupted)."""
        job = self._jobs.get(job_id)
        if job is None or job.state in JobState.TERMINAL:
            return False
        job.state = JobState.CANCELLED
        job.finished_t = self._now()
        job.snapshot = None
        job.ship = None
        return True

    def ready(self, bucket: Optional[tuple] = None) -> list:
        """Runnable jobs (optionally of one bucket) in scheduling order:
        higher priority first, then least-served, then admission order."""
        jobs = [j for j in self.active()
                if bucket is None or j.bucket == bucket]
        return sorted(jobs, key=lambda j: (-j.priority, j.gens_done,
                                           j.seq))

    def forget(self, job_id: str) -> None:
        self._jobs.pop(job_id, None)
