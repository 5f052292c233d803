"""The fleet replica and its client (port of timetabling_ga_tpu/fleet/
replicas.py, under the same names).

  Replica       turns a SolveService into an HTTP replica: a DRIVE LOOP
                owns every call that touches the card (admission's pad
                and place, scheduler steps, cancellations, the preempt
                drain) and consumes a command inbox
                (runtime/dispatch_core.py CommandFence) that the `/v1`
                handlers feed; the handler threads only enqueue and read.
                In-process (tests, programs) through `.start()`, which
                runs the loop on a daemon thread, or as the foreground
                process of `serve --http` through `.run()`.
  ReplicaHandle a gateway's client-side view of a replica: submit, poll,
                cancel and drain calls, and the probe state a router
                reads (readiness reasons, the backlog gauge, the
                residency gauges, the incident and usage caches).
  http_json / http_text   the stdlib HTTP client both use.
  ReplicaSet    the gateway's probe thread over its handles: death
                after --dead-after failed probes (not while a worker
                boots, --boot-grace), respawn within --max-restarts.
  spawn_one / spawn_local   `serve --http` worker processes of the port
                on fresh local ports (`fleet --spawn N`, the
                autoscaler's scale-up).

A draining replica finishes its jobs first (the loop steps until the
queue has no active job), then closes its service, so the writer drains
and the record stream is whole before the process exits; /readyz says
`draining` throughout. A preempt drain instead parks every active job as
`preempted`, publishes its snapshot and exits once each was fetched or
--preempt-grace passed.

The card: the drive loop runs on the device the service resolved
(runtime/engine.py resolve_device; `--backend gpu`, the default, raises
when no CUDA device is visible) and makes it the loop thread's current
device before its first call, so a loop on a thread of its own never
relies on the main thread's. A handler never touches the card: a job's
ship unit holds host arrays (dispatch_core.fetch_state), `?snapshot=1`
only flags the scheduler (request_flush) and the job (ship_hot), and
the views read host fields. A settled job's problem tensors are dropped
at once (`_reap_terminal`), so the card's memory does not grow with the
jobs served.

Stdlib and the port's protocol modules only at import: the solver
stack (torch, the kernels) loads in `Replica.__init__`, so a client of
http_json or ReplicaHandle loads no torch.
"""

from __future__ import annotations

import collections
import io
import itertools
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

from timetabling_ga_tpu_torch.fleet.gateway import TERMINAL, ApiHandler
from timetabling_ga_tpu_torch.obs import http as obs_http
from timetabling_ga_tpu_torch.obs import scrape as obs_scrape
from timetabling_ga_tpu_torch.runtime import faults, jsonl
from timetabling_ga_tpu_torch.runtime.config import FleetConfig, ServeConfig

# the bound on a job's record tail on a replica: GET /v1/jobs/<id>
# serves at most this many records (a job's stream is a handful of
# logEntries and lifecycle records; the bound only guards the replica's
# memory from a pathological one)
TAIL_CAP = int(os.environ.get("TT_FLEET_TAIL_CAP", "4096"))
# how many jobs keep a tail (and rejected submissions an index entry):
# past it the oldest are forgotten, so a long-running replica does not
# hold every tail it served
TAIL_JOBS = int(os.environ.get("TT_FLEET_TAIL_JOBS", "4096"))


# ------------------------------------------------------------- HTTP client


class FleetHTTPError(RuntimeError):
    """A status outside the caller's `ok` from a replica or gateway."""

    def __init__(self, status: int, url: str, detail):
        self.status = status
        self.detail = detail
        super().__init__(f"HTTP {status} from {url}: "
                         f"{str(detail)[:200]}")


def http_json(method: str, url: str, obj=None, timeout: float = 5.0,
              ok: tuple = (200, 202), headers=None):
    """One JSON-in, JSON-out HTTP call. 4xx and 5xx bodies are parsed
    too; a status outside `ok` raises FleetHTTPError carrying the parsed
    detail. `headers` adds request headers (a gateway's `X-TT-Flow`)."""
    data = None
    hdrs = dict(headers or {})
    if obj is not None:
        data = json.dumps(obj).encode()
        hdrs["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status = resp.status
            body = resp.read()
    except urllib.error.HTTPError as e:
        status = e.code
        body = e.read()
    try:
        parsed = json.loads(body) if body else {}
    except ValueError:
        parsed = {"raw": body.decode("utf-8", "replace")[:200]}
    if status not in ok:
        raise FleetHTTPError(status, url, parsed)
    return parsed


def http_text(url: str, timeout: float = 5.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8", "replace")


# ------------------------------------------------------------ record tail


class JobTail:
    """A tee between the service's AsyncWriter and the real stream that
    keeps each job's tail of job-tagged records. Every line reaches the
    stream unchanged (the tee adds nothing and reorders nothing); each
    parsed record with a `job` tag also lands in that job's tail, which
    GET /v1/jobs/<id> serves. It runs on the writer's thread."""

    def __init__(self, stream, cap: int = TAIL_CAP,
                 max_jobs: int = TAIL_JOBS):
        self._stream = stream
        self._cap = cap
        self._max_jobs = max_jobs
        self._buf = ""
        self._tails: dict = {}       # insertion-ordered: oldest first out
        self._counts: dict = {}      # records ever taken a job: a ring
        #                              holding exactly `cap` is truncated
        #                              only when more than that arrived
        self._lock = threading.Lock()

    def write(self, s: str) -> None:
        self._stream.write(s)
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self._ingest(line)

    def flush(self) -> None:
        self._stream.flush()

    def _ingest(self, line: str) -> None:
        try:
            rec = json.loads(line)
        except ValueError:
            return
        if not isinstance(rec, dict) or not rec:
            return
        kind = next(iter(rec))
        body = rec.get(kind)
        job = body.get("job") if isinstance(body, dict) else None
        if job is None:
            return
        with self._lock:
            tail = self._tails.get(str(job))
            if tail is None:
                # a ring a job: past the cap the prefix drops, so the
                # settling jobEntry always survives
                tail = collections.deque(maxlen=self._cap)
                self._tails[str(job)] = tail
            tail.append(rec)
            self._counts[str(job)] = self._counts.get(str(job), 0) + 1
            while len(self._tails) > self._max_jobs:
                # the oldest job's tail goes; the stream is the durable
                # copy
                evicted = next(iter(self._tails))
                self._tails.pop(evicted)
                self._counts.pop(evicted, None)

    def tail(self, job_id: str) -> list:
        with self._lock:
            return list(self._tails.get(str(job_id), ()))

    def truncated(self, job_id: str) -> bool:
        """True when the ring dropped records (more arrived than it
        holds); a stream of exactly `cap` records is whole."""
        with self._lock:
            t = self._tails.get(str(job_id))
            return (t is not None
                    and self._counts.get(str(job_id), 0) > len(t))


# ----------------------------------------------------------- the replica


def payload_problem(payload: dict):
    """A submit payload's Problem: the whole parse, on the replica that
    solves it."""
    from timetabling_ga_tpu_torch.problem import load_tim
    kw = {}
    if "n_days" in payload:
        kw["n_days"] = int(payload["n_days"])
    if "slots_per_day" in payload:
        kw["slots_per_day"] = int(payload["slots_per_day"])
    if "problem" in payload:
        return problem_from_json(payload["problem"])
    return load_tim(str(payload["tim"]), **kw)


def problem_from_json(obj: dict):
    """The `{"problem": {...}}` form as a Problem: the counts and the
    four reference arrays, the derived matrices recomputed, never taken
    from the wire (problem.py problem_from_json)."""
    from timetabling_ga_tpu_torch import problem
    return problem.problem_from_json(obj)


def problem_to_json(problem_obj) -> dict:
    """A Problem as the form problem_from_json reads."""
    from timetabling_ga_tpu_torch import problem
    return problem.problem_to_json(problem_obj)


class ReplicaApi:
    """The replica front's handler surface, enqueue or read only: a
    submission or a cancellation becomes an inbox command that the drive
    loop runs at its next control fence; the views read the queue's job
    table and the record tails."""

    def __init__(self, replica: "Replica"):
        self._r = replica

    def accept_solve(self, payload: dict, flow: int = 0,
                     resubmit: bool = False):
        r = self._r
        if r.draining:
            return 503, {"error": "draining", "reasons": ["draining"]}
        if not r.driving():
            return 503, {"error": "drive loop down"}
        with r.index_lock:
            job_id = str(payload.get("id")
                         or f"{r.name}-{next(r.auto_id)}")
            if job_id in r.index or job_id in r.svc.queue:
                return 409, {"error": "duplicate job id", "id": job_id}
            r.index[job_id] = {"state": "accepted"}
        # `flow`: the gateway's X-TT-Flow (0 = none), so the job's spans
        # here continue its chain; `resubmit`: X-TT-Resubmit, a resend
        # not counted again in its tenant's `jobs`
        r.inbox.put(("submit", job_id, dict(payload, id=job_id), flow,
                     resubmit))
        return 202, {"id": job_id, "state": "accepted"}

    def job_view(self, job_id: str, with_records: bool = True,
                 with_snapshot: bool = False):
        r = self._r
        try:
            job = r.svc.queue.get(job_id)
        except KeyError:
            job = None
        if job is None:
            with r.index_lock:
                info = r.index.get(job_id)
            if info is None:
                return 404, {"error": f"unknown job {job_id!r}"}
            view = {"id": job_id, "state": info["state"],
                    "error": info.get("error"), "result": None}
        else:
            view = {"id": job_id, "state": job.state,
                    "gens": job.gens_done, "error": job.error,
                    "result": job.result}
        if with_records:
            # the tail is the costly part of the view: ?records=0 (a
            # gateway's steady poll) skips it
            view["records"] = r.tail.tail(job_id)
            view["records_truncated"] = r.tail.truncated(job_id)
        if with_snapshot and job is not None:
            # a resident job's unit is its last host fence's: ask the
            # drive loop to park every resident group at its next fence,
            # and mark this job ship_hot so its group parks at every
            # fence while it is polled. Flags only: this thread never
            # touches the card
            job.ship_hot = True
            r.svc.scheduler.request_flush()
            # the job's latest park-fence unit (one state and record
            # prefix, replaced whole by the drive loop); its npz is
            # packed here, on this handler thread, once a fence: the
            # `snapshot_ship` fault site parks (hang) or drops (die)
            # this handler alone
            ship = job.ship
            if ship is not None:
                try:
                    faults.maybe_fail("snapshot_ship")
                    view["snapshot"] = ship.pack()
                except SystemExit:
                    return None, None        # drop the connection
                view["snapshot_records"] = list(ship.records)
                if ship.records_bytes is None:
                    ship.records_bytes = sum(
                        len(json.dumps(rec)) for rec in ship.records)
                view["snapshot_records_bytes"] = ship.records_bytes
                view["snapshot_truncated"] = bool(ship.truncated)
                ship.served = True           # the preempt drain's signal
        return 200, view

    def jobs_view(self):
        """Every job's state in one answer (a gateway's poll). The index
        is read before the queue, which overrides it: a submission
        leaves the index only after it is in the queue, so it is never
        missing from both."""
        r = self._r
        out = {}
        with r.index_lock:
            for job_id, info in r.index.items():
                out[job_id] = {"state": info["state"]}
        for job in list(r.svc.queue._jobs.values()):
            out[job.id] = {"state": job.state, "gens": job.gens_done}
        return 200, {"jobs": out}

    def accept_cancel(self, job_id: str):
        r = self._r
        known = job_id in r.svc.queue
        if not known:
            with r.index_lock:
                known = job_id in r.index
        if not known:
            return 404, {"error": f"unknown job {job_id!r}"}
        r.inbox.put(("cancel", job_id))
        return 202, {"id": job_id, "cancelling": True}

    def accept_drain(self, mode: str = "graceful", replica=None):
        del replica                     # a gateway's selector
        if mode not in ("graceful", "preempt"):
            return 400, {"error": f"unknown drain mode {mode!r} "
                                  f"(graceful | preempt)"}
        r = self._r
        r.inbox.put(("drain", mode))
        return 200, {"draining": True, "mode": mode,
                     "active": len(r.svc.queue.active())}

    def fleet_view(self):
        return 404, {"error": "not a gateway (single replica)"}

    def incident_view(self):
        """The newest flight-recorder bundle, from memory (obs/flight.py
        incident_response); 404 without a recorder or a dump."""
        from timetabling_ga_tpu_torch.obs.flight import incident_response
        return incident_response(self._r.svc.flight)

    def usage_view(self):
        """The ledger's tenant totals and each job's meter (`Job.usage`,
        replaced whole at park fences, so the read is never torn); 404
        with metering off (--no-usage)."""
        ledger = self._r.svc.usage
        if ledger is None:
            return 404, {"error": "usage metering off (--no-usage)"}
        from timetabling_ga_tpu_torch.obs import usage as obs_usage
        jobs = {}
        for job in list(self._r.svc.queue._jobs.values()):
            if job.usage:
                jobs[job.id] = {"tenant": job.tenant,
                                "state": job.state,
                                "gens": job.gens_done,
                                "usage": obs_usage.rounded(job.usage)}
        return 200, {"tenants": ledger.totals(), "jobs": jobs}


class Replica:
    """One HTTP replica: a SolveService, its drive loop and the `/v1`
    front.

    The drive loop is the only thread that touches the card: it admits
    parsed submissions (pad and place), steps the scheduler one dispatch
    at a time, takes cancellations at control fences and, once draining,
    runs the queue dry before closing the service. `kill()` stands in
    for a crashed replica in tests: the loop stops, nothing is
    finalized, the front goes silent."""

    def __init__(self, cfg: ServeConfig, name: str = "replica",
                 out=None, registry=None, now=None):
        import dataclasses

        # the one fleet entry point that loads the solver stack
        from timetabling_ga_tpu_torch.runtime import dispatch_core
        from timetabling_ga_tpu_torch.serve.service import SolveService
        self.name = name
        self.cfg = cfg
        base = out
        self._close_base = False
        if base is None:
            if cfg.output:
                # append: a restarted worker with the same -o keeps the
                # records of the one before it
                base = open(cfg.output, "a")
                self._close_base = True
            else:
                base = sys.stdout
        self.tail = JobTail(base)
        self.svc = SolveService(
            dataclasses.replace(cfg, output=None), out=self.tail,
            now=now, registry=registry)
        self.inbox = dispatch_core.CommandFence()
        # the process's kernel launches (kernels.LAUNCHES) as
        # `kernels.launches.<name>` pull gauges: a gateway's client reads
        # on /metrics which kernels a worker process ran
        from timetabling_ga_tpu_torch import kernels
        for kname in kernels.LAUNCHES:
            self.svc.registry.gauge_fn(
                f"kernels.launches.{kname}",
                lambda k=kname: float(kernels.LAUNCHES[k]))
        self.index: dict = {}        # states before admission, rejections
        self.index_lock = threading.Lock()
        self.auto_id = itertools.count(1)
        self.draining = False
        self._preempting = False     # park and ship, do not run dry
        self._preempt_deadline = None
        self._reaped: list = []      # settled ids, oldest first: their
        #                              tensors dropped, forgotten past
        #                              TAIL_JOBS
        self._signal_drain = False   # set by signal handlers: a bare
        #                              store, no lock (a handler runs on
        #                              the loop's own thread)
        self.drained = threading.Event()
        self._killed = False
        self._thread = None
        self.front = None
        if cfg.http:
            self.front = obs_http.ObsServer(
                cfg.http, registry=self.svc.registry,
                probes={"process": lambda: True,
                        "writer": self.svc.writer.alive,
                        "drive": self.driving},
                profile=self.svc.profile_capture,
                history=self.svc.history,
                handler=ApiHandler, api=ReplicaApi(self)).start()

    @property
    def url(self) -> str:
        return self.front.url

    def driving(self) -> bool:
        """True while the drive loop can make progress: before start()
        (a foreground run() to come) or while its thread lives."""
        if self._killed or self.drained.is_set():
            return False
        return self._thread is None or self._thread.is_alive()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "Replica":
        """In-process mode: the drive loop on a daemon thread."""
        self._thread = threading.Thread(
            target=self.run, name=f"tt-replica-{self.name}",
            daemon=True)
        self._thread.start()
        return self

    def drain(self) -> None:
        self.inbox.put(("drain",))

    def stop(self, timeout: float = 120.0) -> None:
        """Graceful stop: drain, wait for the loop, close the front."""
        self.drain()
        self.drained.wait(timeout)
        if self.front is not None:
            self.front.close()

    def kill(self) -> None:
        """A crashed replica (tests): the loop exits without finalizing
        or closing the service, and the front stops answering."""
        self._killed = True
        if self.front is not None:
            self.front.close()
        self.inbox.put(("wake",))

    # -- the drive loop -------------------------------------------------

    def run(self) -> None:
        """Drive until drained or killed: `serve --http`'s foreground
        loop; start() runs it on a thread."""
        try:
            if self.svc.device.type == "cuda":
                # this thread's current device is the service's, whatever
                # the main thread's is
                import torch
                torch.cuda.set_device(self.svc.device)
            while not self._killed:
                try:
                    if self._signal_drain and not self.draining:
                        # "preempt": SIGTERM under --preempt-on-term
                        if self._signal_drain == "preempt":
                            self._preempt()
                        else:
                            self._set_draining()
                    cmd = self.inbox.poll()
                    if cmd is not None:
                        self._handle(cmd)
                        continue
                    if self.draining and not self.svc.queue.active():
                        if not self._preempting or self._shipped():
                            break
                    busy = False
                    if self.svc.queue.ready():
                        busy = bool(self.svc.step())
                    self._reap_terminal()
                    if not busy:
                        cmd = self.inbox.wait(timeout=0.05)
                        if cmd is not None:
                            self._handle(cmd)
                except KeyboardInterrupt:
                    # foreground mode: ^C asks for a drain
                    self._set_draining()
        finally:
            if not self._killed:
                try:
                    self.svc.close()
                except Exception:
                    pass
                if self._close_base:
                    try:
                        self.tail._stream.close()
                    except Exception:
                        pass
            self.drained.set()

    def _handle(self, cmd: tuple) -> None:
        kind = cmd[0]
        if kind == "submit":
            job_id, payload = cmd[1], cmd[2]
            flow = cmd[3] if len(cmd) > 3 else 0
            resubmit = bool(cmd[4]) if len(cmd) > 4 else False
            try:
                # an edit payload has no instance of its own: the service
                # derives it from the spec
                problem = (None if "edit" in payload
                           else payload_problem(payload))
                self.svc.submit(
                    problem, job_id=job_id,
                    priority=int(payload.get("priority", 0)),
                    seed=payload.get("seed"),
                    generations=payload.get("generations"),
                    deadline_s=payload.get("deadline"),
                    flow=flow,
                    snapshot=payload.get("snapshot"),
                    tenant=payload.get("tenant"),
                    count_job=not resubmit,
                    edit=payload.get("edit"))
                with self.index_lock:
                    self.index.pop(job_id, None)
            except Exception as e:
                # as the line-JSON protocol: a failed submit is a
                # rejection record and the replica goes on
                jsonl.job_entry(self.svc.writer, job_id, "rejected",
                                reason=str(e)[:200])
                with self.index_lock:
                    self.index[job_id] = {"state": "rejected",
                                          "error": str(e)[:200]}
                    while len(self.index) > TAIL_JOBS:
                        self.index.pop(next(iter(self.index)))
        elif kind == "cancel":
            self.svc.cancel(cmd[1])
        elif kind == "drain":
            mode = cmd[1] if len(cmd) > 1 else "graceful"
            if mode == "preempt":
                self._preempt()
            else:
                self._set_draining()
        # "wake": a loop tick only

    # -- the preempt drain ----------------------------------------------

    def _preempt(self) -> None:
        """The cooperative preemption (POST /v1/drain?mode=preempt, or
        SIGTERM under --preempt-on-term): every resident group parks,
        then every active job is marked `preempted` (a jobEntry with
        `shipped`, serve.jobs_preempted) where it stands, and the front
        stays up serving `?snapshot=1` until each preempted job's unit
        was fetched or --preempt-grace passes; then the loop exits and
        the service closes, the writer draining the `preempted` records
        to the log. It runs between quanta, where every job is at a park
        fence, so a preemption loses nothing."""
        self._set_draining()
        if self._preempting:
            return
        self._preempting = True
        self._preempt_deadline = (time.monotonic()
                                  + self.cfg.preempt_grace)
        # park first (this is the drive loop, between quanta): the units
        # published below then hold the jobs' real progress
        self.svc.scheduler.flush_resident("preempt")
        from timetabling_ga_tpu_torch.serve.queue import JobState
        for job in list(self.svc.queue.active()):
            job.state = JobState.PREEMPTED
            jsonl.job_entry(self.svc.writer, job.id, "preempted",
                            gens=job.gens_done,
                            shipped=job.ship is not None)
            self.svc.registry.counter("serve.jobs_preempted").inc()

    def _shipped(self) -> bool:
        """True when the preempt drain may exit: every preempted job's
        unit was fetched, or the grace deadline passed."""
        if (self._preempt_deadline is not None
                and time.monotonic() >= self._preempt_deadline):
            return True
        from timetabling_ga_tpu_torch.serve.queue import JobState
        return all(job.ship is None or job.ship.served
                   for job in list(self.svc.queue._jobs.values())
                   if job.state == JobState.PREEMPTED)

    def _reap_terminal(self) -> None:
        """Drop a settled job's heavy references the moment it settles:
        its padded problem's tensors on the card (`pa_dev`, `padded`,
        and any cached pack holding them), its problem, its snapshot and
        record mirror (the result and the record tail keep serving GET
        /v1/jobs). Its last ship unit stays (host bytes: a settled job
        may still be an edit's base) until the job is forgotten, past
        TAIL_JOBS settled jobs."""
        released = []
        for job in list(self.svc.queue._jobs.values()):
            if job.state in TERMINAL and job.pa_dev is not None:
                job.pa_dev = None
                job.padded = None
                job.problem = None
                job.snapshot = None
                job.ship_records.clear()
                released.append(job.id)
        if released:
            self.svc.scheduler.drop_packs(released)
            self._reaped.extend(released)
        while len(self._reaped) > TAIL_JOBS:
            self.svc.queue.forget(self._reaped.pop(0))

    def _set_draining(self) -> None:
        if not self.draining:
            self.draining = True
            # the registry is written from the drive loop, never from a
            # handler: /readyz says `draining` until the exit
            self.svc.registry.gauge("serve.draining").set(1.0)


def serve_http(cfg: ServeConfig) -> int:
    """`serve --http HOST:PORT` (service.main_serve hands off here): one
    replica, its drive loop on the main thread, SIGTERM and SIGINT a
    graceful drain (SIGTERM the preempt drain under
    --preempt-on-term)."""
    import signal

    replica = Replica(cfg)
    print(f"# tt serve --http: replica on {replica.url}",
          file=sys.stderr, flush=True)

    def _drain(signum, frame):
        # a bare store: the handler interrupts the drive loop's own
        # thread, so taking a lock (or the inbox's) could deadlock; the
        # loop reads the flag at its next turn
        if signum == signal.SIGTERM and cfg.preempt_on_term:
            replica._signal_drain = "preempt"
        else:
            replica._signal_drain = True

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    replica.run()
    # the loop has ended and the records are out: a later SIGTERM (a
    # gateway reaping a replica whose front went quiet) has nothing left
    # to stop, and must not turn the teardown into a signal death
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    if replica.front is not None:
        replica.front.close()
    return 0


# ----------------------------------------------------- gateway-side view


class ReplicaHandle:
    """A gateway's client-side view of one replica: the HTTP verbs and
    the probe state a router scores on. A prober thread writes the probe
    fields and a dispatcher reads them (plain stores: a stale gauge
    costs a worse placement, never a wrong result)."""

    def __init__(self, name: str, url: str, proc=None, respawn=None):
        self.name = name
        self.url = url.rstrip("/")
        self.proc = proc             # subprocess.Popen of a spawned one
        self.respawn = respawn       # zero-arg -> a fresh Popen
        self.restarts = 0
        self.fails = 0               # consecutive failed probes
        self.dead = False
        self.retired = False         # preempt-drained on purpose: its
        #                              exit is expected, not respawned
        self.ok_once = False         # answered a probe once
        self.born = time.monotonic()  # (re)spawn time: the boot grace
        # -- the router's inputs (refreshed by probe()) ------------------
        self.ready = False
        self.reasons: list = ["unprobed"]
        self.queue_depth = None
        self.backlog = None
        self.compile_count = 0.0
        self.compile_cache_hits = 0.0
        self.resident_groups = None  # serve.resident_* off the same
        self.resident_bytes = None   # scrape; None until scraped
        self.probe_seconds = None    # the last good probe's round trip
        # -- incident correlation (refreshed by probe()) -----------------
        self.flight_dumps = 0.0      # the replica's dump counter
        self.last_incident = None    # the newest bundle fetched when it
        #                              advanced: a dead replica's last one
        # -- the usage cache (refreshed by probe()) ----------------------
        self.last_usage = None       # the newest /v1/usage payload
        self.usage_base = None       # retired incarnations' combined
        #                              ledger; (base, last) is read and
        #                              written under _usage_lock
        self._usage_lock = threading.Lock()

    # -- probe ----------------------------------------------------------

    def probe(self, timeout: float) -> bool:
        """One readiness and metrics scrape. False only when the replica
        is unreachable (a 503 /readyz is a healthy not-ready answer)."""
        t0 = time.monotonic()
        try:
            detail = http_json("GET", self.url + "/readyz",
                               timeout=timeout, ok=(200, 503))
        except Exception:
            return False
        self.ok_once = True
        self.ready = bool(detail.get("ready"))
        self.reasons = list(detail.get("reasons", ()))
        try:
            self._scrape_metrics(timeout)
        except Exception:
            pass                     # gauges go stale, the probe is ok
        self.probe_seconds = time.monotonic() - t0
        return True

    def _scrape_metrics(self, timeout: float) -> None:
        # the `gw_scrape` fault site, on the prober's thread: a hang parks
        # the prober alone, a die is one failed scrape
        try:
            faults.maybe_fail("gw_scrape")
        except SystemExit:
            return
        families = obs_scrape.parse_exposition(
            http_text(self.url + "/metrics", timeout=timeout))
        self.queue_depth = obs_scrape.scalar(
            families, obs_scrape.QUEUE_DEPTH, self.queue_depth)
        self.backlog = obs_scrape.scalar(
            families, obs_scrape.BACKLOG, self.backlog)
        self.compile_count = obs_scrape.scalar(
            families, obs_scrape.COMPILE_COUNT, self.compile_count)
        self.compile_cache_hits = obs_scrape.scalar(
            families, obs_scrape.COMPILE_HITS,
            self.compile_cache_hits)
        self.resident_groups = obs_scrape.scalar(
            families, obs_scrape.RESIDENT_GROUPS, self.resident_groups)
        self.resident_bytes = obs_scrape.scalar(
            families, obs_scrape.RESIDENT_BYTES, self.resident_bytes)
        # a fresh bundle when the dump counter moved (a backward move
        # above 0 is a restarted replica's new bundle)
        dumps = obs_scrape.scalar(families, obs_scrape.FLIGHT_DUMPS,
                                  self.flight_dumps)
        if dumps > self.flight_dumps \
                or (dumps < self.flight_dumps and dumps > 0):
            try:
                self.last_incident = self.get_incident(timeout=timeout)
            except Exception:
                pass                 # keep the previous copy
        self.flight_dumps = dumps
        try:
            fresh = self.get_usage(timeout=timeout)
            if fresh is not None:
                self.note_usage(fresh)
        except Exception:
            pass                     # keep the previous copy

    def compile_hit_rate(self) -> float:
        total = self.compile_count + self.compile_cache_hits
        return self.compile_cache_hits / total if total > 0 else 0.0

    # -- verbs ----------------------------------------------------------

    def post_job(self, payload: dict, timeout: float = 5.0,
                 idempotent: bool = False, flow: int = 0,
                 resubmit: bool = False):
        # 409 (a duplicate id) is success only for a resend: on a job's
        # first send it is a real collision
        ok = (200, 202, 409) if idempotent else (200, 202)
        headers = {}
        if flow:
            headers["X-TT-Flow"] = str(int(flow))
        if resubmit:
            headers["X-TT-Resubmit"] = "1"
        return http_json("POST", self.url + "/v1/solve", payload,
                         timeout=timeout, ok=ok,
                         headers=headers or None)

    def list_jobs(self, timeout: float = 5.0):
        """{id: {"state", ...}} for every job the replica knows."""
        return http_json("GET", f"{self.url}/v1/jobs",
                         timeout=timeout, ok=(200,)).get("jobs", {})

    def get_job(self, job_id: str, timeout: float = 5.0,
                with_records: bool = True, snapshot: bool = False):
        params = []
        if not with_records:
            params.append("records=0")
        if snapshot:
            params.append("snapshot=1")
        suffix = "?" + "&".join(params) if params else ""
        return http_json(
            "GET",
            f"{self.url}/v1/jobs/{urllib.parse.quote(job_id)}"
            f"{suffix}",
            timeout=timeout, ok=(200,))

    def get_incident(self, timeout: float = 5.0):
        """The replica's newest bundle, or None before a dump or
        without a recorder."""
        try:
            return http_json("GET", self.url + "/v1/incident",
                             timeout=timeout, ok=(200,)
                             ).get("incident")
        except FleetHTTPError as e:
            if e.status == 404:
                return None
            raise

    def get_usage(self, timeout: float = 5.0):
        """The replica's /v1/usage payload, or None with metering off."""
        try:
            return http_json("GET", self.url + "/v1/usage",
                             timeout=timeout, ok=(200,))
        except FleetHTTPError as e:
            if e.status == 404:
                return None
            raise

    def note_usage(self, fresh) -> None:
        """Cache a scraped /v1/usage payload. Counters that moved
        backward mean a new incarnation: the cached payload (the old
        one's last ledger) folds into `usage_base` first."""
        from timetabling_ga_tpu_torch.obs import usage as obs_usage
        with self._usage_lock:
            if (self.last_usage is not None
                    and obs_usage.progress(fresh)
                    < obs_usage.progress(self.last_usage)):
                self.usage_base = (
                    self.last_usage if self.usage_base is None
                    else obs_usage.combine(
                        [self.usage_base, self.last_usage]))
            self.last_usage = fresh

    def usage_payload(self):
        """Every incarnation's metered work: `usage_base` plus the live
        one's latest scrape; None when nothing was scraped."""
        from timetabling_ga_tpu_torch.obs import usage as obs_usage
        with self._usage_lock:
            base, last = self.usage_base, self.last_usage
        if base is None:
            return last
        if last is None:
            return base
        return obs_usage.combine([base, last])

    def retire_usage(self) -> None:
        """Fold the dying incarnation's last ledger into the base, in
        one locked move (before a respawn)."""
        from timetabling_ga_tpu_torch.obs import usage as obs_usage
        with self._usage_lock:
            if self.last_usage is None:
                return
            self.usage_base = (
                self.last_usage if self.usage_base is None
                else obs_usage.combine([self.usage_base,
                                        self.last_usage]))
            self.last_usage = None

    def get_history(self, window: float | None = None,
                    timeout: float = 5.0):
        """The replica's history ring (GET /metrics/history[?window=S]);
        window 0.0 is an empty window, not everything."""
        suffix = (f"?window={float(window)}" if window is not None
                  else "")
        return http_json("GET",
                         self.url + "/metrics/history" + suffix,
                         timeout=timeout, ok=(200,))

    def cancel_job(self, job_id: str, timeout: float = 5.0):
        return http_json(
            "DELETE",
            f"{self.url}/v1/jobs/{urllib.parse.quote(job_id)}",
            timeout=timeout, ok=(200, 202, 404, 409))

    def drain(self, timeout: float = 5.0, mode: str = "graceful"):
        suffix = f"?mode={mode}" if mode != "graceful" else ""
        return http_json("POST", self.url + "/v1/drain" + suffix, {},
                         timeout=timeout, ok=(200,))

    # -- process management --------------------------------------------

    def process_exited(self) -> bool:
        return self.proc is not None and self.proc.poll() is not None

    def terminate(self) -> None:
        if self.proc is None or self.proc.poll() is not None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()

    def view(self) -> dict:
        return {"name": self.name, "url": self.url,
                "ready": self.ready, "reasons": self.reasons,
                "dead": self.dead, "restarts": self.restarts,
                "queue_depth": self.queue_depth,
                "compile_hit_rate": round(self.compile_hit_rate(), 4)}


class ReplicaSet:
    """The probe thread's owner over a set of handles. It detects death
    (`dead_after` failed probes in a row, or a reaped process), respawns
    spawned workers within `max_restarts`, and reports every death
    through `on_death(handle, respawned)`, the gateway's failover
    trigger. A restarted process comes back cold (no warm buckets, an
    empty queue), so its jobs fail over as a dead replica's do."""

    def __init__(self, handles, probe_every: float = 0.5,
                 probe_timeout: float = 2.0, dead_after: int = 3,
                 max_restarts: int = 0, on_death=None,
                 boot_grace: float = 120.0):
        self._handles = {h.name: h for h in handles}
        self.probe_every = probe_every
        self.probe_timeout = probe_timeout
        self.dead_after = dead_after
        self.max_restarts = max_restarts
        self.on_death = on_death
        self.boot_grace = boot_grace
        self._no_restart = False
        self._exits: set = set()     # pids whose exit was reported
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._probe_loop, name="tt-fleet-probe",
            daemon=True)

    # -- views ----------------------------------------------------------

    def all(self) -> list:
        return list(self._handles.values())

    def live(self) -> list:
        return [h for h in self._handles.values() if not h.dead]

    def get(self, name: str):
        return self._handles.get(name)

    def add(self, handle: ReplicaHandle) -> None:
        """Adopt a replica mid-run (the autoscaler's scale-up): the
        prober takes it up next round, and `--boot-grace` covers its
        start as at a startup spawn. One dict store: the probe loop
        iterates over copies."""
        self._handles[handle.name] = handle

    # -- probing --------------------------------------------------------

    def start(self) -> "ReplicaSet":
        self._thread.start()
        return self

    def probe_all(self) -> None:
        for handle in list(self._handles.values()):
            if not handle.dead:
                self._probe_one(handle)
            elif (handle.respawn is None and handle.proc is None
                  and not handle.retired):
                # a static (externally managed) replica is probed after
                # its death too: a network blip must not remove a
                # healthy process for good. It rejoins cold on its first
                # answered probe; a spawned worker's corpse stays dead
                if handle.probe(self.probe_timeout):
                    handle.dead = False
                    handle.fails = 0

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_every):
            self.probe_all()

    def _probe_one(self, handle: ReplicaHandle) -> None:
        exited = handle.process_exited()
        ok = False if exited else handle.probe(self.probe_timeout)
        if ok:
            handle.fails = 0
            return
        handle.ready = False
        if exited:
            self._note_exit(handle)
        if (not exited and not handle.ok_once
                and time.monotonic() - handle.born < self.boot_grace):
            # still booting (a spawned worker imports torch and binds
            # its port first): unreachable is expected, not a death
            return
        handle.fails += 1
        if exited or handle.fails >= self.dead_after:
            self._declare_dead(handle)

    def _declare_dead(self, handle: ReplicaHandle) -> None:
        respawned = False
        if (not self._no_restart and not handle.retired
                and handle.respawn is not None
                and handle.restarts < self.max_restarts):
            try:
                handle.terminate()   # reap a half-dead process first
                self._note_exit(handle)
                # the dying incarnation's metered work joins the retired
                # ledger before the fresh worker answers /v1/usage
                handle.retire_usage()
                handle.proc = handle.respawn()
                handle.restarts += 1
                handle.fails = 0
                handle.ok_once = False
                handle.born = time.monotonic()
                # a fresh incarnation counts its dumps from 0 again
                # (last_incident stays: the dead one's bundle is the
                # death's evidence until a newer one lands)
                handle.flight_dumps = 0.0
                respawned = True
            except Exception:
                pass
        if not respawned:
            handle.dead = True
        if self.on_death is not None:
            self.on_death(handle, respawned)

    def stop_restarts(self) -> None:
        """Drain mode: replicas exiting after their drain are done, not
        dead; stop respawning them."""
        self._no_restart = True

    def _note_exit(self, handle: ReplicaHandle) -> None:
        """One stderr line for each spawned worker process that ended,
        with its exit status (the gateway, its parent, is the only
        process that can read it)."""
        proc = handle.proc
        rc = getattr(proc, "returncode", None)
        if rc is None or proc.pid in self._exits:
            return
        self._exits.add(proc.pid)
        print(f"# tt fleet: replica {handle.name} (pid {proc.pid}) "
              f"exited {rc}", file=sys.stderr, flush=True)

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        for handle in self._handles.values():
            handle.terminate()
            self._note_exit(handle)


# ------------------------------------------------------------- spawning


def free_port() -> int:
    """An ephemeral local port (bind, then release; the worker binds it
    a moment later). A worker that loses the port to another process
    exits, and its prober declares it dead."""
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def spawn_one(cfg: FleetConfig, name: str) -> ReplicaHandle:
    """One `serve --http` worker process of the port on a fresh local
    port, on `cfg.backend` (the card unless `--backend cpu`): the unit
    behind `--spawn N` and the autoscaler's scale-up. Its record stream
    goes to ./tt-fleet-<name>.jsonl unless the passthrough serve flags
    set -o; the respawn closure reuses the port, so a restarted replica
    keeps its URL. Workers started together share the kernel build
    directory safely: each library is written under a name of its
    content's hash through a per-process temporary file and an atomic
    rename (kernels.build)."""
    port = free_port()
    argv = [sys.executable, "-m", "timetabling_ga_tpu_torch", "serve",
            "--http", f"127.0.0.1:{port}",
            "--backend", cfg.backend]
    if "-o" not in cfg.serve_args:
        argv += ["-o", f"tt-fleet-{name}.jsonl"]
    argv += list(cfg.serve_args)

    def respawn(argv=tuple(argv)):
        return subprocess.Popen(
            list(argv), stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)

    return ReplicaHandle(name, f"http://127.0.0.1:{port}",
                         proc=respawn(), respawn=respawn)


def spawn_local(cfg: FleetConfig) -> list:
    """`fleet --spawn N`: one `serve --http` worker a replica."""
    return [spawn_one(cfg, f"r{i}") for i in range(cfg.spawn)]


def in_process_replica(cfg: ServeConfig, name: str, now=None) -> tuple:
    """An in-process replica with a registry of its own (so several in
    one process keep separate /readyz truths), and its handle. cfg.http
    must be set ('127.0.0.1:0' binds a free port). Records go to an
    in-memory buffer (`replica.tail._stream`) unless cfg.output names a
    file."""
    from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
    out = io.StringIO() if not cfg.output else None
    replica = Replica(cfg, name=name, out=out,
                      registry=MetricsRegistry(), now=now).start()
    return replica, ReplicaHandle(name, replica.url)
