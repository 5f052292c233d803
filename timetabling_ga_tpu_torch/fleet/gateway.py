"""The fleet gateway (port of timetabling_ga_tpu/fleet/gateway.py, under
the same names): one HTTP solve front over N routed replicas, and the
`/v1` protocol it shares with every replica front, so that a router can
treat a replica as a one-member fleet.

  POST   /v1/solve      submit a job. Body: a raw `.tim` payload, or
                        JSON `{"tim": "...", "id", "priority", "seed",
                        "generations", "deadline", "tenant", "snapshot",
                        "edit", "n_days", "slots_per_day"}`, or
                        pre-parsed problem JSON (`{"problem": {...}}`,
                        fleet/replicas.py problem_from_json). 202
                        `{"id", "state": "accepted"}` at once: the job
                        is accepted, not solved. `X-TT-Flow` carries a
                        gateway's cross-process flow id, `X-TT-Resubmit:
                        1` marks a resend (not counted again in its
                        tenant's `jobs`).
  GET    /v1/jobs/<id>  state, result and the job-tagged record tail;
                        `?records=0` without the tail, `?snapshot=1`
                        with the job's latest park-fence wire
                        (serve/snapshot.py) and its record prefix.
  GET    /v1/jobs       every job's state (one bulk poll).
  DELETE /v1/jobs/<id>  cancel, through the queue's cancellation path.
  POST   /v1/drain      `?mode=graceful` (the default: admit nothing new,
                        finish the queue, exit) or `?mode=preempt` (park
                        and ship every job, exit once each is fetched
                        or at --preempt-grace); at a gateway,
                        `?mode=preempt&replica=NAME` preempts that one
                        replica and its jobs resume on the others.
  GET    /v1/fleet /v1/incident /v1/usage   the fleet view (a gateway's;
                        a replica answers 404), the newest incident
                        bundle, the usage ledger (a gateway's sums its
                        replicas', obs/usage.py aggregate).
  GET    /metrics /healthz /readyz ...   the pull front (obs/http.py),
                        on the same port.

Handlers enqueue and read only: a POST validates cheap text (the `.tim`
header), puts a command in the owner's inbox and returns; a GET reads
cached or queue state. Every body read is bounded by Content-Length and
MAX_BODY. No handler does outbound I/O or touches the card.

The Gateway's one dispatcher thread owns every outbound call (routing,
submission, status polls, snapshot fetches, failover, drain) and every
change of router state. Failover resumes, it does not replay: while a
job runs, the dispatcher caches its owner's newest fingerprint-valid
park-fence wire (`?snapshot=1`, checked with serve/snapshot.py
verify_wire, under --snapshot-hwm bytes); when the ReplicaSet's prober
declares the owner dead (--dead-after failed probes, or a reaped
worker), the job is resent with that wire and the survivor admits it
parked at the shipped progress, so at most one quantum re-runs, and the
shipped record prefix joins the job's stream. A job with no cached wire
replays from generation 0 with the same payload and seed, which gives
the same records. `fleet.resume.{hits,replays,fetches,fetch_errors,
rejected,evictions,demoted}` count it.

`-o LOG` gives the gateway its own record stream through an AsyncWriter
(fault site `gw_writer`: a dead writer turns emission off and routing
goes on): dispatcher spans (route / submit / poll / failover / settle /
routed) with cross-process flow ids sent to replicas as `X-TT-Flow`, a
routeEntry a placement, metricsEntry snapshots every --metrics-every
ticks. `/v1/fleet` reads a snapshot the dispatcher refreshes each tick;
the same numbers are /metrics families (`fleet.replica.<name>.{ready,
backlog,probe_seconds,compile_hit_rate,pins,restarts}`,
`fleet.route.{hit,warm,miss,repins}`, `fleet.jobs_*`,
`fleet.tick_seconds`, `fleet.job_seconds`). `/readyz` adds the reasons
`no_ready_replica`, `dispatcher_stalled` (--stall-after) and `slo_burn`
(--slo-p99 over the settled jobs' latencies).

Stdlib and the port's torch-free modules only (obs, runtime/config,
jsonl, faults, retry, serve/snapshot's wire checks, serve/bucket's key
math): the gateway routes on `.tim` headers and scraped gauges and
loads no torch; the solver enters a process only through a replica's
drive loop.
"""

from __future__ import annotations

import collections
import itertools
import json
import queue as queue_mod
import sys
import threading
import time
import urllib.parse

from timetabling_ga_tpu_torch.fleet.router import NoReplicaError, Router
from timetabling_ga_tpu_torch.obs import http as obs_http
from timetabling_ga_tpu_torch.obs import metrics as obs_metrics
from timetabling_ga_tpu_torch.obs.spans import (
    NULL_TRACER, XFLOW_BASE, SpanTracer)
from timetabling_ga_tpu_torch.runtime import faults, jsonl
from timetabling_ga_tpu_torch.runtime.config import (
    FleetConfig, ServeConfig, parse_fleet_args, parse_serve_args)
from timetabling_ga_tpu_torch.runtime.retry import retry_transient
from timetabling_ga_tpu_torch.serve import snapshot as snapshot_mod
from timetabling_ga_tpu_torch.serve.bucket import (
    BucketSpec, bucket_key_from_counts)

# the problem's default slot grid (problem.py DAYS_DEFAULT and
# SLOTS_PER_DAY_DEFAULT), kept here so that reading a payload's header
# imports no torch
DAYS_DEFAULT = 5
SLOTS_PER_DAY_DEFAULT = 9

# request-body bound: the largest ITC instance serializes to well under
# a megabyte; 32 MiB leaves room for dense problem JSON while a lying
# Content-Length cannot balloon a handler
MAX_BODY = 32 * 1024 * 1024

# settled job states at a front (serve/queue.py's terminal states and
# the front's own 'rejected')
TERMINAL = ("done", "failed", "cancelled", "shed", "rejected")

_PAYLOAD_KEYS = ("id", "tim", "problem", "priority", "seed",
                 "generations", "deadline", "n_days", "slots_per_day",
                 # a warm-start wire (serve/snapshot.py): a gateway
                 # attaches one when it resumes a job elsewhere, and a
                 # client may submit one itself
                 "snapshot",
                 # an edit spec (serve/editsolve.py), applied by the
                 # replica that solves it
                 "edit",
                 # the tenant tag (obs/usage.py), carried end to end
                 "tenant")


# ---------------------------------------------------------------- protocol


def parse_solve_body(body: bytes) -> dict:
    """The submit payload of a POST /v1/solve body: JSON when it parses
    as an object, else the whole body is `.tim` text. Raises ValueError
    on anything unusable."""
    try:
        text = body.decode("utf-8")
    except UnicodeDecodeError as e:
        raise ValueError(f"body is not UTF-8: {e}") from None
    stripped = text.lstrip()
    if stripped.startswith("{"):
        try:
            obj = json.loads(text)
        except ValueError as e:
            raise ValueError(f"bad JSON body: {e}") from None
        payload = {k: obj[k] for k in _PAYLOAD_KEYS if k in obj}
        if ("tim" not in payload and "problem" not in payload
                and "edit" not in payload):
            raise ValueError(
                "JSON body needs a 'tim' text, a 'problem' object, "
                "or an 'edit' spec")
        return payload
    if not stripped:
        raise ValueError("empty body")
    return {"tim": text}


def payload_counts(payload: dict) -> tuple:
    """(E, R, F, S, n_days, slots_per_day) of a submit payload, from the
    `.tim` header (its first four tokens) or the problem object's
    counts: never the whole instance."""
    days = int(payload.get("n_days", DAYS_DEFAULT))
    slots = int(payload.get("slots_per_day", SLOTS_PER_DAY_DEFAULT))
    if "edit" in payload and "tim" not in payload \
            and "problem" not in payload:
        return edit_payload_counts(payload)
    if "problem" in payload:
        p = payload["problem"]
        try:
            counts = tuple(int(p[k]) for k in (
                "n_events", "n_rooms", "n_features", "n_students"))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad problem object: {e}") from None
        days = int(p.get("n_days", days))
        slots = int(p.get("slots_per_day", slots))
    else:
        # maxsplit: only the first four tokens, so a dense instance near
        # the body cap is not tokenized on a handler thread
        toks = str(payload["tim"]).split(None, 4)[:4]
        if len(toks) < 4:
            raise ValueError(".tim header needs 4 counts "
                             "(events rooms features students)")
        try:
            counts = tuple(int(t) for t in toks)
        except ValueError:
            raise ValueError(
                f".tim header is not 4 ints: {toks}") from None
    if any(c < 0 for c in counts):
        raise ValueError(f"negative instance counts: {counts}")
    return counts + (days, slots)


def edit_payload_counts(payload: dict):
    """(E, R, F, S, n_days, slots_per_day) of an edit payload, or None
    when they wait for a job-id base to be resolved. Header arithmetic
    only: an inline `edited` instance counts as a submit payload; an
    inline base counts, plus one event for each add_event op and minus
    one for each remove_event op. A malformed spec raises ValueError."""
    edit = payload.get("edit")
    if not isinstance(edit, dict):
        raise ValueError("'edit' must be an object")
    if "base" not in edit:
        raise ValueError("edit spec needs a 'base'")
    if ("ops" in edit) == ("edited" in edit):
        raise ValueError(
            "edit spec needs exactly one of 'ops' or 'edited'")
    carry = {k: payload[k] for k in ("n_days", "slots_per_day")
             if k in payload}
    if "edited" in edit:
        edited = edit["edited"]
        if not isinstance(edited, dict) or (
                "tim" not in edited and "problem" not in edited):
            raise ValueError("edit 'edited' needs a 'tim' text or a "
                             "'problem' object")
        return payload_counts({**carry, **edited})
    ops = edit["ops"]
    if not isinstance(ops, (list, tuple)):
        raise ValueError("edit 'ops' must be a list")
    base = edit["base"]
    if isinstance(base, str):
        return None                     # a job id: resolved later
    if not isinstance(base, dict) or (
            "tim" not in base and "problem" not in base):
        raise ValueError("edit base needs a job id, a 'tim' text, or "
                         "a 'problem' object")
    e, r, f, s, days, slots = payload_counts({**carry, **base})
    for op in ops:
        kind = op.get("op") if isinstance(op, dict) else None
        if kind == "add_event":
            e += 1
        elif kind == "remove_event":
            e -= 1
    if e <= 0:
        raise ValueError("edit removes every event")
    return (e, r, f, s, days, slots)


# ---------------------------------------------------------------- handler


def _query(query: str) -> dict:
    return dict(p.split("=", 1) for p in query.split("&") if "=" in p)


class ApiHandler(obs_http._Handler):
    """The `/v1` request router of gateway and replica fronts. It
    extends the pull front's handler (GET /metrics, /healthz, /readyz
    and the rest answer on the same port) and calls only the server's
    `api` object, whose whole surface enqueues commands or reads state.
    Every socket read is bounded by Content-Length."""

    def do_GET(self):  # noqa: N802 (http.server's naming)
        path, _, query = self.path.partition("?")
        if path.startswith("/v1/jobs/"):
            params = _query(query)
            status, obj = self.server.api.job_view(
                self._job_id(path),
                with_records=params.get("records") != "0",
                with_snapshot=params.get("snapshot") == "1")
            if status is None:
                # an injected `snapshot_ship` die: a dropped connection,
                # as the `scrape` site's (a SystemExit escaping the
                # handler thread would reach the process's excepthook)
                self.close_connection = True
                return
            self._reply_json(status, obj)
        elif path == "/v1/jobs":
            status, obj = self.server.api.jobs_view()
            self._reply_json(status, obj)
        elif path == "/v1/fleet":
            status, obj = self.server.api.fleet_view()
            self._reply_json(status, obj)
        elif path == "/v1/incident":
            # the newest bundle from the recorder's memory: no file I/O
            # on this thread
            status, obj = self.server.api.incident_view()
            self._reply_json(status, obj)
        elif path == "/v1/usage":
            status, obj = self.server.api.usage_view()
            self._reply_json(status, obj)
        else:
            super().do_GET()

    @staticmethod
    def _job_id(path: str) -> str:
        # clients quote the id into the URL; without the unquote an id
        # with a space would 404 every poll
        return urllib.parse.unquote(path[len("/v1/jobs/"):])

    def do_POST(self):  # noqa: N802
        path, _, query = self.path.partition("?")
        if path == "/v1/solve":
            body = self._body()
            if body is None:
                return
            try:
                payload = parse_solve_body(body)
            except ValueError as e:
                self._reply_json(400, {"error": str(e)[:300]})
                return
            status, obj = self.server.api.accept_solve(
                payload, flow=self._flow_header(),
                resubmit=self._resubmit_header())
            self._reply_json(status, obj)
        elif path == "/v1/drain":
            # read any declared body before the 200: a keep-alive
            # client's next request must not be parsed out of it
            self._discard_body()
            params = _query(query)
            status, obj = self.server.api.accept_drain(
                mode=params.get("mode", "graceful"),
                replica=params.get("replica"))
            self._reply_json(status, obj)
        else:
            self._reply_json(404, {"error": f"no route {path!r}"})

    def do_DELETE(self):  # noqa: N802
        path, _, _ = self.path.partition("?")
        if path.startswith("/v1/jobs/"):
            status, obj = self.server.api.accept_cancel(
                self._job_id(path))
            self._reply_json(status, obj)
        else:
            self._reply_json(404, {"error": f"no route {path!r}"})

    def _flow_header(self) -> int:
        """The gateway's flow id from `X-TT-Flow`, 0 when absent or not
        an integer (telemetry: a bad value is ignored, never a 400)."""
        try:
            return int(self.headers.get("X-TT-Flow") or 0)
        except ValueError:
            return 0

    def _resubmit_header(self) -> bool:
        """`X-TT-Resubmit: 1`: a resend, not counted again in its
        tenant's `jobs`."""
        return self.headers.get("X-TT-Resubmit") == "1"

    def _discard_body(self) -> None:
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            n = 0
        if 0 < n <= MAX_BODY:
            self.rfile.read(n)
        elif n > MAX_BODY:
            self.close_connection = True

    def _reply(self, status: int, body: bytes, ctype: str) -> None:
        # an error reply may leave an unread body in the socket: close
        # the connection rather than let a keep-alive client's next
        # request be parsed out of it
        if status >= 400:
            self.close_connection = True
        super()._reply(status, body, ctype)

    def _body(self):
        """The body, read up to its Content-Length; replies and returns
        None without one, with a bad one, or past MAX_BODY (an unbounded
        read would park this thread until the client hangs up)."""
        n = self.headers.get("Content-Length")
        if n is None:
            self._reply_json(411, {"error": "Content-Length required"})
            return None
        try:
            n = int(n)
        except ValueError:
            self._reply_json(400, {"error": "bad Content-Length"})
            return None
        if n < 0 or n > MAX_BODY:
            self._reply_json(
                413, {"error": f"body over {MAX_BODY} bytes"})
            return None
        return self.rfile.read(n)


# ---------------------------------------------------------------- gateway


class GatewayJob:
    """One job's gateway-side life: payload kept for failover replay,
    state/result/records mirrored from the owning replica by the
    dispatcher's polls (handlers read ONLY this cache)."""

    def __init__(self, job_id: str, payload: dict, now: float):
        self.id = job_id
        self.payload = payload
        self.counts = None           # payload_counts result
        self.bucket = None
        self.replica = None          # owning replica name
        self.state = "accepted"
        self.result = None
        self.error = None
        self.records: list = []
        self.records_final = False
        self.records_truncated = False   # tail lost records (over-cap
        #                                  ring, or a settle fallback)
        #                                  — identity cannot hold
        self.extra_polls = 0         # terminal-tail settle budget
        self.place_attempts = 0
        self.place_started = None    # current placement round's epoch:
        #                              reset by failover, so a job that
        #                              ran for hours still gets the
        #                              full --place-timeout to wait
        #                              out a respawning replica
        self.cancel_requested = False
        self.sent_any = False        # some send of this payload may
        #                              have reached a replica: later
        #                              sends are idempotent resends
        #                              (409 = already placed)
        self.submitted_t = now
        self.finished_t = None
        self.counted = False         # terminal counters bumped once
        self.flow = 0                # cross-process causal flow id
        #                              (obs/spans.py XFLOW_BASE range),
        #                              minted by the dispatcher at first
        #                              placement and shipped to the
        #                              replica as X-TT-Flow — gateway
        #                              and replica spans share it
        self.routed_any = False      # a routed span was emitted: later
        #                              placements (failover) measure
        #                              from THEIR round's start, so the
        #                              job's routed spans never overlap
        #                              and their sum stays a real
        #                              placement-time total
        # -- resume, don't replay ----------------------------------------
        self.prefix: list = []       # records of PREVIOUS incarnations
        #                              (accumulated at each resume):
        #                              the settled stream is
        #                              prefix + the final replica's
        #                              tail — whole and duplicate-free
        self.snap = None             # newest fingerprint-valid wire
        #                              snapshot fetched from the owner
        self.snap_records: list = []  # the record prefix shipped WITH
        #                              that snapshot (one consistent
        #                              park-fence pair)
        self.snap_gens = 0           # progress of the cached snapshot
        #                              (fetch throttle + the
        #                              oldest-progress-first eviction
        #                              key)
        self.snap_bytes = 0          # cache accounting vs
        #                              --snapshot-hwm
        self.snap_truncated = False  # the shipped prefix was capped —
        #                              identity honestly disclaimed
        self.prefix_truncated = False  # some attached prefix was
        #                              capped: the settled stream must
        #                              carry records_truncated
        self.edit_basis = None       # inline instance kept past settle
        #                              (the payload is released there):
        #                              a finished job may still become
        #                              an edit BASE — bounded
        #                              by --retain-terminal eviction

    def terminal(self) -> bool:
        return self.state in TERMINAL

    def view(self, with_records: bool = True) -> dict:
        out = {"id": self.id, "state": self.state,
               "replica": self.replica,
               "bucket": list(self.bucket) if self.bucket else None,
               "result": self.result, "error": self.error}
        if with_records:
            out["records"] = list(self.records)
            out["records_truncated"] = self.records_truncated
        return out


class GatewayApi:
    """The handlers' surface: enqueue-or-read-only over the Gateway
    (no outbound I/O, no device, no registry mutation)."""

    def __init__(self, gw: "Gateway"):
        self._gw = gw

    def accept_solve(self, payload: dict, flow: int = 0,
                     resubmit: bool = False):
        # `flow` (an upstream X-TT-Flow) is accepted for signature
        # parity with ReplicaApi but ignored: the gateway is the ROOT
        # allocator of cross-process chains — its dispatcher mints
        # each job's flow at first placement; likewise `resubmit` —
        # the gateway originates resends, it never receives them
        del flow, resubmit
        gw = self._gw
        if gw.draining:
            return 503, {"error": "draining", "reasons": ["draining"]}
        try:
            counts = payload_counts(payload)
        except ValueError as e:
            return 400, {"error": str(e)[:300]}
        with gw.jobs_lock:
            job_id = payload.get("id")
            if job_id is None:
                # auto-ids skip anything a client already claimed —
                # an id-less submission must never be rejected for a
                # collision it did not cause
                job_id = f"gw-{next(gw.auto_id)}"
                while job_id in gw.jobs:
                    job_id = f"gw-{next(gw.auto_id)}"
            job_id = str(job_id)
            if job_id in gw.jobs:
                return 409, {"error": "duplicate job id", "id": job_id,
                             "state": gw.jobs[job_id].state}
            active = sum(1 for j in gw.jobs.values()
                         if not j.terminal())
            if active >= gw.cfg.backlog:
                return 429, {"error": f"gateway backlog full "
                                      f"({gw.cfg.backlog} active)"}
            job = GatewayJob(job_id, dict(payload, id=job_id),
                             gw.now())
            job.counts = counts
            gw.jobs[job_id] = job
        gw.inbox.put(("submit", job_id))
        return 202, {"id": job_id, "state": "accepted"}

    def job_view(self, job_id: str, with_records: bool = True,
                 with_snapshot: bool = False):
        with self._gw.jobs_lock:
            job = self._gw.jobs.get(job_id)
            if job is None:
                return 404, {"error": f"unknown job {job_id!r}"}
            view = job.view(with_records=with_records)
            if with_snapshot and job.snap is not None:
                # protocol parity with the replica front: the gateway
                # re-serves its cached snapshot, so a client (or a
                # meta-gateway) can pull a warm start for a job even
                # after its replica died
                view["snapshot"] = job.snap
                view["snapshot_records"] = list(job.snap_records)
                view["snapshot_truncated"] = job.snap_truncated
            return 200, view

    def jobs_view(self):
        """Bulk state-only view (protocol parity with the replica
        front — a meta-gateway could poll this gateway the same
        way)."""
        with self._gw.jobs_lock:
            return 200, {"jobs": {j.id: {"state": j.state,
                                         "replica": j.replica}
                                  for j in self._gw.jobs.values()}}

    def accept_cancel(self, job_id: str):
        gw = self._gw
        with gw.jobs_lock:
            job = gw.jobs.get(job_id)
            if job is None:
                return 404, {"error": f"unknown job {job_id!r}"}
            if job.terminal():
                return 409, {"id": job_id, "state": job.state,
                             "error": "already terminal"}
        gw.inbox.put(("cancel", job_id))
        return 202, {"id": job_id, "cancelling": True}

    def accept_drain(self, mode: str = "graceful", replica=None):
        gw = self._gw
        if mode not in ("graceful", "preempt"):
            return 400, {"error": f"unknown drain mode {mode!r} "
                                  f"(graceful | preempt)"}
        if mode == "preempt" and replica is None:
            # a gateway-wide preempt would strand every job (nothing
            # left to resume ON); the supported form names the one
            # replica being scaled down — refuse loudly rather than
            # silently running the graceful full drain instead
            return 400, {"error": "gateway preempt needs a target: "
                                  "?mode=preempt&replica=NAME"}
        if replica is not None:
            # targeted scale-down: POST /v1/drain?mode=preempt&
            # replica=NAME preempts ONE replica — it parks + ships
            # every job it owns, the dispatcher resumes them
            # elsewhere, and the fleet keeps serving. Only enqueue
            # here; the dispatcher owns
            # the outbound drain call.
            if mode != "preempt":
                return 400, {"error": "replica= drains require "
                                      "mode=preempt"}
            if gw.replicas.get(replica) is None:
                return 404, {"error": f"unknown replica {replica!r}"}
            gw.inbox.put(("preempt", replica))
            return 202, {"preempting": replica}
        gw.draining = True
        gw.inbox.put(("drain",))
        with gw.jobs_lock:
            active = sum(1 for j in gw.jobs.values()
                         if not j.terminal())
        return 200, {"draining": True, "active": active}

    def incident_view(self):
        """GET /v1/incident at the gateway: its newest bundle — after
        a failover or burn, the STITCHED cross-process one (own rings
        + the involved replicas' pulled bundles). Same shared wire
        shape and in-memory discipline as the replica's
        (obs/flight.incident_response)."""
        from timetabling_ga_tpu_torch.obs.flight import incident_response
        return incident_response(self._gw.flight)

    def usage_view(self):
        """GET /v1/usage at the gateway: fleet-wide totals aggregated
        over the prober's cached per-replica `/v1/usage` payloads
        (ReplicaHandle.last_usage — refreshed on the PROBER thread; a
        DEAD replica keeps contributing its last-scraped ledger, the
        incident-bundle stitching rule, so a killed replica's metered
        work never vanishes from the bill). Tenant meters SUM — each
        replica counted only its own metered quanta, and a resumed
        job's survivor ledger starts from zero — so a failover's
        fleet totals match an uninterrupted solve's modulo the re-run
        quantum. Read-only over handle attributes on this handler
        thread."""
        gw = self._gw
        payloads = [(h.name, h.dead, h.usage_payload())
                    for h in gw.replicas.all()]
        from timetabling_ga_tpu_torch.obs import usage as obs_usage
        return 200, obs_usage.aggregate(payloads)

    def fleet_view(self):
        # served from the dispatcher's lock-guarded SNAPSHOT, refreshed
        # once per tick — the handler thread never reads router/replica
        # state the dispatcher is mutating (the live view used to walk
        # `router._pins` mid-placement). The JSON is a convenience: the
        # same numbers are real /metrics families (fleet.replica.*,
        # fleet.route.*, fleet.jobs_* — module docstring maps them)
        return 200, self._gw.fleet_snapshot()


class Gateway:
    """The fleet front: HTTP API + single-threaded dispatcher that
    owns routing, submission, polling, failover, and drain."""

    def __init__(self, cfg: FleetConfig, handles, owned: bool = False,
                 now=None, out=None, spawn_fn=None):
        # deterministic fault injection, mirroring SolveService: the
        # gateway/route sites fire under `fleet` too
        spec = faults.active_spec(cfg.faults)
        if spec:
            faults.install(spec)
        self.cfg = cfg
        self.now = now or time.monotonic
        self.owned = owned           # gateway manages replica lifetime
        self.draining = False
        self.drained = threading.Event()
        self.jobs: dict = {}
        self.jobs_lock = threading.RLock()
        self.auto_id = itertools.count(1)
        self.inbox = queue_mod.Queue()
        self._requeue: list = []     # placement retries, drained ONCE
        #                              per poll tick (an inbox requeue
        #                              would be popped right back and
        #                              starve the poll/drain phases)
        self._terminal_order: list = []   # settled ids, eviction FIFO
        # the gateway's PRIVATE registry (replicas keep their own
        # /readyz truths; so does the front) — created before the
        # telemetry stream so the flight recorder can report into it
        self.registry = obs_metrics.MetricsRegistry()
        # the history ring samples this registry (whose per-replica
        # pull gauges the prober refreshes — so
        # `sustained("fleet.replica.r0.backlog", ...)` is exactly the
        # autoscaler's input); the recorder tees
        # the gateway log and stitches cross-process bundles on
        # failover/burn (`_pull_incidents` is its peer fetch, run on
        # the RECORDER thread — a hung replica export parks the
        # recorder, never the dispatcher)
        self.history = None
        self.flight = None
        self._stream = None
        self._close_stream = False
        self.writer = None
        self.front = None
        self.replicas = None
        self.scaler = None
        try:
            self._init_rest(cfg, handles, out, spawn_fn)
        except BaseException:
            # ANY constructor failure past the thread starts — a taken
            # listen port, an unwritable -o path, a bad worker-flag
            # parse — must not leak the started history/flight threads, the
            # gw_writer worker, the -o handle, the prober thread, or
            # owned worker processes into a process whose Gateway
            # never existed (the SolveService ctor-failure discipline;
            # close() is unreachable here)
            if self.front is not None:
                self.front.close()
            if self.scaler is not None:
                self.scaler.close()
            if self.flight is not None:
                self.flight.close()
            if self.history is not None:
                self.history.close()
            if self.writer is not None:
                try:
                    self.writer.close(raise_error=False)
                except Exception:
                    pass
            if self._close_stream:
                try:
                    self._stream.close()
                except Exception:
                    pass
            if self.replicas is not None:
                self.replicas.close()
            raise

    def _init_rest(self, cfg: FleetConfig, handles, out,
                   spawn_fn=None) -> None:
        # -- telemetry stream: `-o LOG` (or an explicit
        # `out` stream) gives the gateway its own AsyncWriter + tracer;
        # without one the tracer is the shared no-op and nothing emits
        self._stream = out
        if self._stream is None and cfg.output:
            self._stream = open(cfg.output, "w")
            self._close_stream = True
        from timetabling_ga_tpu_torch.obs import flight as obs_flight
        self.history, self.flight, sink = obs_flight.wire(
            cfg, self._stream, registry=self.registry,
            process="gateway", peers_fn=self._pull_incidents,
            now=self.now, history_always=True)
        self.writer = (jsonl.AsyncWriter(sink, site="gw_writer")
                       if sink is not None else None)
        self._obs_dead = False       # latched by _rec on a dead writer
        self.tracer = (SpanTracer(self.writer, clock=self.now,
                                  flow_base=XFLOW_BASE)
                       if self.writer is not None else NULL_TRACER)
        if self.flight is not None:
            if self.writer is not None:
                self.flight.bind_tracer(self.tracer)
            self.flight.start()
        # the serve flags spawned workers run with double as the
        # router's bucket spec — one parse, no drift
        serve_cfg = (parse_serve_args(cfg.serve_args)
                     if cfg.serve_args else ServeConfig())
        # kept whole: the snapshot cache validates shipped snapshots
        # against the fleet's (bucket, pop_size, seed) fingerprint —
        # the same parse the workers run with, so it cannot drift
        self.serve_cfg = serve_cfg
        self.spec = BucketSpec(
            event_floor=serve_cfg.bucket_events,
            room_floor=serve_cfg.bucket_rooms,
            feature_floor=serve_cfg.bucket_features,
            student_floor=serve_cfg.bucket_students,
            ratio=serve_cfg.bucket_ratio)
        from timetabling_ga_tpu_torch.fleet.replicas import ReplicaSet
        self.replicas = ReplicaSet(
            handles, probe_every=cfg.probe_every,
            probe_timeout=cfg.probe_timeout,
            dead_after=cfg.dead_after, max_restarts=cfg.max_restarts,
            on_death=self._on_death, boot_grace=cfg.boot_grace)
        self.router = Router(self.replicas, registry=self.registry)
        self.registry.gauge_fn(
            "fleet.replicas_ready",
            lambda: sum(1 for h in self.replicas.live() if h.ready))
        self.registry.gauge_fn(
            "serve.queue_depth",
            lambda: sum(1 for j in list(self.jobs.values())
                        if not j.terminal()))
        self.registry.gauge("serve.backlog").set(cfg.backlog)
        for h in handles:
            self._bind_replica_gauges(h)
        if self.writer is not None:
            self.registry.gauge_fn("writer.queue_depth",
                                   self.writer.qsize)
        # dispatcher watchdog: tick age as a pull gauge + the
        # configured threshold, so /readyz (obs/http.py readiness) can
        # flip `dispatcher_stalled` from registry state alone
        self._ticks = 0
        self._last_tick = self.now()
        self.registry.gauge_fn("fleet.tick_age_s",
                               lambda: self.now() - self._last_tick)
        self.registry.gauge("fleet.tick_stall_after").set(
            cfg.stall_after)
        # snapshot cache accounting: live
        # gauges so the resume story is on /metrics before any
        # failover ever needs it
        if cfg.snapshot_hwm > 0:
            self.registry.gauge("fleet.resume.bytes").set(0.0)
            self.registry.gauge("fleet.resume.cached").set(0.0)
        # SLO monitor (--slo-p99): rolling window of e2e latencies,
        # p99'd once per tick; transitions emit faultEntry records
        self._slo_lat = collections.deque(maxlen=cfg.slo_window)
        self._slo_burning = False
        if cfg.slo_p99 > 0:
            self.registry.gauge("fleet.slo_burn").set(0.0)
        # /v1/fleet snapshot: refreshed by the dispatcher each tick,
        # served by handlers under _view_lock (never the live state)
        self._view_lock = threading.Lock()
        self._view_cache: dict = {}
        # the autoscaler's inputs published alongside it: per-replica in-flight
        # counts and the warmth-guard protections, computed ON the
        # dispatcher (the only thread that may read router warmth) and
        # read by the SCALER thread under the same lock
        self._scale_cache: dict = {}
        self._bucket_routed_t: dict = {}   # bucket -> last placement
        #                                    time (the warmth guard's
        #                                    'recently routed' input)
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="tt-fleet-dispatch",
            daemon=True)
        # the autoscaler (fleet/autoscaler.py): the
        # policy actuator, constructed before the front so /healthz
        # can probe it, started by start(). Scale-up needs the --spawn
        # worker pool; an injected spawn_fn is the test seam (and how
        # a dry-run over a static fleet stays actuation-free).
        probes = {"dispatcher": self._thread.is_alive}
        if cfg.scale_max > 0:
            from timetabling_ga_tpu_torch.fleet.autoscaler import AutoScaler
            if spawn_fn is None and self.owned \
                    and not cfg.scale_dry_run:
                from timetabling_ga_tpu_torch.fleet import (
                    replicas as replicas_mod)

                def spawn_fn(name, cfg=cfg):
                    return replicas_mod.spawn_one(cfg, name)

            self.scaler = AutoScaler(self, cfg, spawn_fn=spawn_fn,
                                     now=self.now)
            probes["scaler"] = self.scaler.alive
        # a taken listen port raises here — __init__'s outer guard
        # closes every thread/handle started above
        self.front = obs_http.ObsServer(
            cfg.listen, registry=self.registry,
            probes=probes,
            handler=ApiHandler, api=GatewayApi(self),
            site="gateway", history=self.history)
        self._refresh_view()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "Gateway":
        # one synchronous probe round before anything routes: the
        # router's first decision should see real readiness, not the
        # all-unprobed default
        self.replicas.probe_all()
        self.replicas.start()
        self.front.start()
        self._thread.start()
        if self.scaler is not None:
            self.scaler.start()
        return self

    @property
    def url(self) -> str:
        return self.front.url

    def request_drain(self) -> None:
        self.draining = True
        self.inbox.put(("drain",))

    def adopt_replica(self, handle) -> None:
        """The autoscaler's scale-up (runs on the SCALER thread, the
        only actuation site): register a just-spawned worker.
        The prober picks it up next round (`--boot-grace` covers its
        start, exactly like a startup spawn), the router sees it
        once ready, and its gauges join the fleet.replica.* families
        the history ring samples. Handle-set and registry mutations
        only — router state stays the dispatcher's."""
        self.replicas.add(handle)
        self._bind_replica_gauges(handle)

    def preempt_replica(self, name: str) -> None:
        """Targeted lossless scale-down:
        preempt ONE replica — it parks + ships every job it owns, the
        dispatcher resumes them on the surviving fleet. Same path as
        POST /v1/drain?mode=preempt&replica=NAME."""
        self.inbox.put(("preempt", name))

    def close(self) -> None:
        # the scaler goes first: it emits records through the writer
        # being drained below and actuates through the dispatcher
        # being stopped below
        if self.scaler is not None:
            self.scaler.close()
        self._stop = True
        self.inbox.put(("wake",))
        if self._thread.ident is not None:   # never-started (close
            self._thread.join(timeout=5.0)   # before start): no join
        if self.writer is not None:
            # final registry snapshot, then drain the telemetry log —
            # raise_error=False: a latched writer error must not mask
            # the caller's own teardown
            self._rec(jsonl.metrics_entry, self.writer,
                      self.registry.snapshot(), ts=self.tracer.now())
            try:
                self.writer.close(raise_error=False)
            except Exception:
                pass
        # flight teardown AFTER the writer drains (the engine/serve
        # ordering): a last-tick failover's faultEntry and spans must
        # reach the tee's rings before the recorder's final poll dumps
        # the pending trigger's bundle
        if self.flight is not None:
            self.flight.close()
        if self.history is not None:
            self.history.close()
        if self.writer is not None and self._close_stream:
            try:
                self._stream.close()
            except Exception:
                pass
        self.front.close()
        self.replicas.close()

    # -- telemetry plumbing ---------------------------------------------

    def _rec(self, fn, *args, **kw) -> None:
        """Guarded record emission (routeEntry / metricsEntry /
        faultEntry / tracer.record): the `gw_writer` isolation
        contract — a dead gateway log writer latches obs OFF and the
        dispatcher routes on; it never stalls placement or
        settlement."""
        if self.writer is None or self._obs_dead:
            return
        try:
            fn(*args, **kw)
        except Exception:
            self._obs_dead = True
            self.tracer.enabled = False

    def _bind_replica_gauges(self, h) -> None:
        """Per-replica /metrics families (the gateway's
        parity): the same numbers `/v1/fleet` shows, as pull gauges
        over the handle's probe state. A None field (never probed)
        reads as NaN — Gauge.value degrades, never raises."""
        base = f"fleet.replica.{h.name}"
        reg = self.registry
        reg.gauge_fn(f"{base}.ready",
                     lambda h=h: 0.0 if h.dead else float(h.ready))
        reg.gauge_fn(f"{base}.backlog",
                     lambda h=h: float(h.queue_depth))
        reg.gauge_fn(f"{base}.probe_seconds",
                     lambda h=h: float(h.probe_seconds))
        reg.gauge_fn(f"{base}.compile_hit_rate",
                     lambda h=h: float(h.compile_hit_rate()))
        reg.gauge_fn(f"{base}.pins",
                     lambda h=h: float(
                         self.router.pin_counts.get(h.name, 0)))
        reg.gauge_fn(f"{base}.restarts",
                     lambda h=h: float(h.restarts))

    def _pull_incidents(self, names) -> list:
        """The flight recorder's peer fetch (RECORDER thread, never the
        dispatcher — a hung replica export parks the recorder, routing
        and settlement run on): each involved replica's newest
        GET /v1/incident bundle, falling back to the prober's last
        cached copy (ReplicaHandle.last_incident) when the replica is
        already dead — the usual case at failover, and exactly the
        "30 seconds before" evidence the cache exists for."""
        out = []
        for name in names:
            handle = self.replicas.get(name)
            if handle is None:
                out.append((name, None, "unknown replica"))
                continue
            bundle, err = None, None
            if not handle.dead:
                try:
                    bundle = handle.get_incident(
                        timeout=self.cfg.snapshot_timeout)
                except Exception as e:
                    err = str(e)[:120]
            if bundle is None and handle.last_incident is not None:
                bundle = handle.last_incident
                err = None if err is None else err + " (cached copy)"
            if bundle is None and err is None:
                err = ("dead, no cached bundle" if handle.dead
                       else "no incident recorded")
            out.append((name, bundle, err))
        return out

    def _refresh_view(self) -> None:
        """Rebuild the /v1/fleet snapshot ON the dispatcher (the only
        thread mutating router/job state) and publish it under the
        view lock — fleet_view handlers read the copy, racing
        nothing. The autoscaler's snapshot is computed here too: the
        warmth guard reads router warmth and the job table, both
        owned by this thread, so the SCALER thread only ever sees a
        published copy."""
        with self.jobs_lock:
            states: dict = {}
            inflight_by_rep: dict = {}
            hot: set = set()
            for j in self.jobs.values():
                states[j.state] = states.get(j.state, 0) + 1
                if not j.terminal():
                    if j.replica is not None:
                        inflight_by_rep[j.replica] = (
                            inflight_by_rep.get(j.replica, 0) + 1)
                    if j.bucket is not None:
                        hot.add(j.bucket)
        # the autoscaler's snapshot is only ever read by the scaler
        # thread — with the autoscaler off this dispatcher tick does
        # none of the warmth/load bookkeeping
        scale = None
        if self.scaler is not None:
            # hot buckets: in-flight jobs' buckets plus anything
            # routed within --scale-warm-recent (entries beyond the
            # window are pruned — the dict stays bounded by live
            # bucket churn)
            now = self.now()
            for bucket, t in list(self._bucket_routed_t.items()):
                if now - t <= self.cfg.scale_warm_recent:
                    hot.add(bucket)
                else:
                    del self._bucket_routed_t[bucket]
            # warmth protection considers SURVIVING capacity only: a
            # retiring replica is still draining (and warm), but it
            # is leaving — counting it as a warm owner would leave a
            # hot bucket's last remaining home unprotected
            live = [h for h in self.replicas.live()
                    if not getattr(h, "retired", False)]
            protected: dict = {}
            for bucket in hot:
                owner = self.router.sole_warm_owner(
                    bucket, [h.name for h in live])
                if owner is not None:
                    protected.setdefault(owner, []).append(
                        list(bucket))
            scale = {
                "replicas": {
                    h.name: {"dead": h.dead,
                             "retired": getattr(h, "retired", False),
                             "inflight": inflight_by_rep.get(h.name,
                                                             0),
                             "pins": self.router.pin_counts.get(
                                 h.name, 0),
                             # serve.resident_* gauges off the last
                             # probe: the residency-aware victim
                             # preference (autoscaler choose_victim)
                             "resident_groups": getattr(
                                 h, "resident_groups", None),
                             "resident_bytes": getattr(
                                 h, "resident_bytes", None)}
                    for h in self.replicas.all()},
                "protected": protected}
        view = {"replicas": [h.view() for h in self.replicas.all()],
                "router": self.router.stats(),
                "jobs": states, "draining": self.draining}
        with self._view_lock:
            self._view_cache = view
            if scale is not None:
                self._scale_cache = scale

    def fleet_snapshot(self) -> dict:
        with self._view_lock:
            return self._view_cache

    def scale_snapshot(self) -> dict:
        """The autoscaler's warmth/load inputs, as last published by
        the dispatcher tick (read on the SCALER thread)."""
        with self._view_lock:
            return self._scale_cache

    def _slo_tick(self) -> None:
        """--slo-p99 rolling-window monitor: p99 over the last
        `--slo-window` settled jobs' e2e latencies, once per tick. A
        burn start/clear flips the `fleet.slo_burn` gauge (the /readyz
        `slo_burn` reason) and emits a faultEntry on the gateway log —
        the moment the fleet stops meeting its latency objective is an
        EVENT, not just a dashboard drift."""
        if self.cfg.slo_p99 <= 0 or not self._slo_lat:
            return
        lats = sorted(self._slo_lat)
        p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
        self.registry.gauge("fleet.slo_p99_s").set(p99)
        burning = p99 > self.cfg.slo_p99
        if burning == self._slo_burning:
            return
        self._slo_burning = burning
        self.registry.gauge("fleet.slo_burn").set(
            1.0 if burning else 0.0)
        if burning:
            self.registry.counter("fleet.slo_burns").inc()
            if self.flight is not None:
                # a burn START is an incident: stitch the whole live
                # fleet's bundles — every replica is "involved" in a
                # latency objective (the pull runs on the recorder
                # thread; this call only enqueues)
                self.flight.trigger(
                    "slo_burn",
                    peers=[h.name for h in self.replicas.live()])
        self._rec(jsonl.fault_entry, self.writer, "slo_burn",
                  "burn" if burning else "clear",
                  f"rolling p99 {p99:.3f}s vs SLO "
                  f"{self.cfg.slo_p99:.3f}s", 0, 0, 0,
                  self.tracer.now(), window=len(lats),
                  p99_s=round(p99, 6))

    def _tick_done(self, t0: float) -> None:
        """End-of-tick bookkeeping: loop timing, the watchdog's tick
        stamp, the SLO check, the /v1/fleet snapshot refresh, and the
        periodic metricsEntry."""
        now = self.now()
        self.registry.histogram("fleet.tick_seconds").observe(
            now - t0)
        self._last_tick = now
        self._ticks += 1
        self._slo_tick()
        self._refresh_view()
        if (self.writer is not None and self.cfg.metrics_every > 0
                and self._ticks % self.cfg.metrics_every == 0):
            self._rec(jsonl.metrics_entry, self.writer,
                      self.registry.snapshot(), ts=self.tracer.now())

    # -- the dispatcher thread: ALL outbound I/O lives here -------------

    _stop = False

    def _dispatch_loop(self) -> None:
        try:
            while not self._stop:
                try:
                    cmd = self.inbox.get(timeout=self.cfg.poll_every)
                except queue_mod.Empty:
                    cmd = None
                t0 = self.now()   # tick timing excludes the idle wait
                while cmd is not None:
                    self._handle(cmd)
                    try:
                        cmd = self.inbox.get_nowait()
                    except queue_mod.Empty:
                        cmd = None
                self._poll_jobs()
                # deferred placement retries AFTER the poll phase, one
                # round per tick: a replica paying its boot-time torch
                # import must not starve status polls or drain progress
                retries, self._requeue = self._requeue, []
                for job_id in retries:
                    self._handle(("submit", job_id))
                self._drain_tick()
                self._tick_done(t0)
        except SystemExit:
            # injected `route`/`gateway` die: ends THIS thread only —
            # /healthz's dispatcher probe goes false, replicas run on
            return

    def _handle(self, cmd: tuple) -> None:
        kind = cmd[0]
        if kind == "submit":
            with self.jobs_lock:
                job = self.jobs.get(cmd[1])
            if job is not None and not job.terminal():
                if job.cancel_requested:
                    # cancelled while waiting for placement: settle
                    # locally, nothing to route
                    job.state = "cancelled"
                    self._settle(job)
                    return
                if job.place_attempts == 0:   # not a requeue retry
                    self.registry.counter("fleet.jobs_accepted").inc()
                if not job.flow:
                    # the job's CROSS-PROCESS flow id, minted once on
                    # the dispatcher (handlers only enqueue): every
                    # gateway span of this job and — via the
                    # X-TT-Flow header — every replica-side span
                    # shares it
                    job.flow = self.tracer.new_flow()
                if job.place_started is None:
                    job.place_started = self.now()
                edit = (job.payload or {}).get("edit")
                if (isinstance(edit, dict)
                        and isinstance(edit.get("base"), str)
                        and not self._resolve_edit(job)):
                    return        # _resolve_edit already failed it
                self._place(job)
        elif kind == "cancel":
            self._cancel(cmd[1])
        elif kind == "drain":
            self.registry.gauge("serve.draining").set(1.0)
        elif kind == "failover":
            self._failover(cmd[1])
        elif kind == "preempt":
            # targeted scale-down: tell ONE replica to park + ship.
            # The poll loop then sees its jobs turn `preempted`,
            # refreshes their snapshots, and resumes them elsewhere —
            # lossless scale-down
            handle = self.replicas.get(cmd[1])
            if handle is not None and not handle.dead:
                try:
                    handle.drain(timeout=self.cfg.probe_timeout,
                                 mode="preempt")
                except Exception:
                    pass       # prober/failover own an unreachable one
        # "wake" and anything else: just a loop tick

    def _resolve_edit(self, job: GatewayJob) -> bool:
        """Resolve an edit payload's job-id base on the dispatcher
        (edit jobs, serve/editsolve.py): rewrite
        `edit["base"]` from the base job's own payload (the inline
        instance every replica can parse), remember the id in
        `edit["base_id"]`, and attach the freshest base snapshot —
        the client's own, the `--snapshot-hwm` cache's, or a live
        `?snapshot=1` fetch from the base's owner. The rewritten
        payload is CONCRETE: a failover replays it byte-stable with
        no second resolution (the base job may be long gone by then).
        False = the job was failed here (unknown/unusable base)."""
        edit = dict((job.payload or {}).get("edit") or {})
        base_id = edit.get("base")
        if not isinstance(base_id, str):
            return True
        with self.jobs_lock:
            base_job = self.jobs.get(base_id)
        if base_job is None:
            self._fail(job, f"edit base job {base_id!r} unknown to "
                            f"this gateway")
            return False
        bp = base_job.payload or {}
        inline = {k: bp[k] for k in ("tim", "problem", "n_days",
                                     "slots_per_day") if k in bp}
        if "tim" not in inline and "problem" not in inline:
            # the base is itself an edit job: its payload holds an
            # edit spec, not an instance — usable only when that spec
            # shipped the full edited instance (an ops-built base
            # would need the gateway to apply ops, which is the
            # replica's job by layering). A SETTLED base's payload is
            # released wholesale — its instance lives on in
            # edit_basis until --retain-terminal evicts the job
            base_edit = bp.get("edit") or {}
            edited = base_edit.get("edited")
            if isinstance(edited, dict):
                inline = dict(edited)
            elif base_job.edit_basis:
                inline = dict(base_job.edit_basis)
            else:
                self._fail(
                    job, f"edit base job {base_id!r} carries no "
                         f"inline instance (an edit of an ops-built "
                         f"edit job is not resolvable at the "
                         f"gateway; submit the base with 'edited')")
                return False
        wire = edit.get("snapshot")
        if wire is None:
            wire = base_job.snap
            if wire is None and base_job.replica:
                # live grab from the base's owner (dispatcher thread,
                # snapshot-timeout budget — same as any cache refresh);
                # no snapshot anywhere just means the replica demotes
                # the edit to a cold solve, counted there
                handle = self.replicas.get(base_job.replica)
                if handle is not None and not handle.dead:
                    self._fetch_snapshot(base_job, handle)
                    wire = base_job.snap
        edit["base"] = inline
        edit["base_id"] = base_id
        if wire is not None:
            edit["snapshot"] = wire
        with self.jobs_lock:
            job.payload = dict(job.payload, edit=edit)
        try:
            job.counts = payload_counts(job.payload)
        except ValueError as e:
            self._fail(job, str(e)[:300])
            return False
        if job.counts is None:
            self._fail(job, f"edit base job {base_id!r} resolution "
                            f"yielded no routing counts")
            return False
        return True

    def _place(self, job: GatewayJob, exclude: tuple = ()) -> None:
        """Route + submit one job, failing over across replicas until
        placed or nothing remains."""
        try:
            job.bucket = bucket_key_from_counts(*job.counts,
                                                spec=self.spec)
            with self.tracer.span("route", cat="fleet", job=job.id,
                                  flow=job.flow):
                handle = self.router.route(job.bucket,
                                           exclude=exclude)
        except NoReplicaError as e:
            self._fail(job, str(e))
            return
        except faults.FaultInjected as e:
            self._fail(job, f"routing fault: {e}")
            return
        job.place_attempts += 1
        # one routeEntry per placement decision: the affinity outcome
        # and the exact score inputs the router read (last_decision is
        # same-thread fresh — no other thread routes)
        decision = self.router.last_decision
        self._rec(jsonl.route_entry, self.writer, job.id, job.bucket,
                  handle.name, decision.get("outcome", "?"),
                  backlog=decision.get("backlog"),
                  pins=decision.get("pins"),
                  compile_hit_rate=decision.get("compile_hit_rate"),
                  attempt=job.place_attempts, flow=job.flow)

        def send():
            # DATA-plane timeout: the payload can be a multi-MB
            # problem JSON; the 2 s probe budget is for gauges.
            # Any attempt after the first is an idempotent RESEND
            # (the earlier one may have landed and lost its reply) —
            # only then is a replica's 409 'already have it' success.
            if job.sent_any:
                self.registry.counter("fleet.submit_retries").inc()
            idem = job.sent_any
            job.sent_any = True
            # resubmit (the usage meter's no-rebill header) is keyed on a
            # previously SUCCESSFUL placement (routed_any), not on
            # sent_any: a boot-window retry whose first POST never
            # landed is still the job's first admission and must be
            # billed; a genuine failover resend was already counted
            # by its first replica. (The lost-response resend inside
            # one placement needs no header: the replica answers 409
            # duplicate — no second admission, no second count.)
            return handle.post_job(job.payload,
                                   timeout=self.cfg.io_timeout,
                                   idempotent=idem, flow=job.flow,
                                   resubmit=job.routed_any)

        try:
            with self.tracer.span("submit", cat="fleet", job=job.id,
                                  flow=job.flow, replica=handle.name):
                retry_transient(send,
                                attempts=self.cfg.route_retries,
                                wait_s=self.cfg.retry_wait_s,
                                backoff=2.0, max_wait_s=2.0)
        except Exception as e:
            from timetabling_ga_tpu_torch.runtime.retry import is_transient
            started = (job.place_started if job.place_started
                       is not None else self.now())
            if (is_transient(e) and self.now() - started
                    < self.cfg.place_timeout):
                # a replica still booting or mid-restart: requeue —
                # retried once per poll tick (the deferred list, not
                # the inbox) rather than burning the exclusion list on
                # a process that is paying its torch import (a spawned
                # worker takes many seconds before it binds its port).
                # The window is anchored at THIS placement round, so
                # failover after a long run gets the full budget.
                self._requeue.append(job.id)
                return
            remaining = [h for h in self.replicas.live()
                         if h.name not in exclude
                         and h.name != handle.name]
            if remaining:
                self._place(job, exclude + (handle.name,))
            else:
                self._fail(job, f"no replica accepted job: "
                                f"{str(e)[:200]}")
            return
        job.replica = handle.name
        job.state = "routed"
        # the warmth guard's 'recently routed' input (autoscaler): a
        # bucket placed within --scale-warm-recent is HOT — its sole
        # warm replica must survive scale-down (scaler-off gateways
        # skip the bookkeeping; _refresh_view never prunes it there)
        if self.scaler is not None:
            self._bucket_routed_t[job.bucket] = self.now()
        self.registry.counter("fleet.jobs_routed").inc()
        # the `routed` span: admit-at-gateway → accepted-by-replica
        # for the FIRST placement, failover-instant → re-accepted for
        # every later one (place_started, reset by _reassign) — so a
        # failed-over job's routed spans never overlap and
        # tally("routed") in the `stats` breakdown stays a true
        # placement-time total. Measured on the gateway's own clock
        # (submitted_t/place_started are the tracer's clock domain).
        start = (job.place_started if job.routed_any
                 and job.place_started is not None
                 else job.submitted_t)
        job.routed_any = True
        self._rec(self.tracer.record, "routed", start,
                  max(0.0, self.now() - start), cat="fleet",
                  job=job.id, flow=job.flow, replica=handle.name,
                  attempt=job.place_attempts)

    def _cancel(self, job_id: str) -> None:
        with self.jobs_lock:
            job = self.jobs.get(job_id)
        if job is None or job.terminal():
            return
        # remembered across failover: a job cancelled while its
        # replica is dying must NOT be resubmitted and solved to
        # completion — _failover and the requeue path check this flag
        job.cancel_requested = True
        if job.replica is None:
            job.state = "cancelled"
            self._settle(job)
            return
        handle = self.replicas.get(job.replica)
        if handle is not None:
            try:
                handle.cancel_job(job.id,
                                  timeout=self.cfg.probe_timeout)
            except Exception:
                pass           # polls (or failover) settle the state

    def _poll_jobs(self) -> None:
        """Refresh the cached job table from the owning replicas —
        the ONLY place replica job state enters the gateway. The
        steady-state poll is STATE-ONLY (`?records=0` — a long job's
        tail would otherwise be re-serialized on every tick); the
        record tail is fetched once the job turns terminal, and the
        job settles when that tail carries the terminal jobEntry (the
        replica's AsyncWriter drains asynchronously, so state can
        lead the records by a beat). An over-cap ring tail or an
        exhausted settle budget settles with `records_truncated`
        marked — visible, never a silently frozen partial stream."""
        with self.jobs_lock:
            jobs = [j for j in self.jobs.values()
                    if j.replica is not None
                    and not (j.terminal() and j.records_final)]
        by_replica: dict = {}
        for job in jobs:
            by_replica.setdefault(job.replica, []).append(job)
        if not by_replica:
            return
        # the poll span uses the record() form and is emitted ONLY
        # when the round observed a state change or settlement — a
        # steady-state gateway polling an idle fleet must not fill its
        # log with empty poll brackets at 5 Hz
        t0 = self.now()
        changed = self._poll_replicas(by_replica)
        if changed:
            self._rec(self.tracer.record, "poll", t0,
                      self.now() - t0, cat="fleet",
                      replicas=len(by_replica), jobs=len(jobs),
                      updates=changed)

    def _poll_replicas(self, by_replica: dict) -> int:
        changed = 0
        for name, group in by_replica.items():
            handle = self.replicas.get(name)
            if handle is None or handle.dead:
                continue           # prober + failover own this case
            try:
                states = handle.list_jobs(
                    timeout=self.cfg.probe_timeout)
            except Exception:
                continue           # prober decides life and death
            for job in group:
                info = states.get(job.id)
                if info is None:
                    # a LIVE replica that does not know the job: it
                    # restarted inside the dead_after window and lost
                    # its state — per-job failover, because the
                    # prober sees a healthy process and will never
                    # declare it dead
                    self._reassign(job)
                    changed += 1
                    continue
                state = info.get("state")
                if state == "preempted":
                    # the replica parked + published this job and is
                    # counting down its --preempt-grace: grab the
                    # final snapshot NOW (best effort — a stale cached
                    # one still resumes, just further back) and
                    # re-place the job on the surviving fleet
                    self._fetch_snapshot(job, handle, final=True)
                    self._reassign(job)
                    changed += 1
                    continue
                if not state or state not in TERMINAL:
                    if state and state != job.state:
                        job.state = state
                        changed += 1
                    gens = info.get("gens")
                    if (self.cfg.snapshot_hwm > 0 and gens is not None
                            and int(gens) > job.snap_gens):
                        # progress since the cached snapshot: refresh
                        # the cache from the owner's latest park fence
                        if self._fetch_snapshot(job, handle):
                            changed += 1
                    continue
                # the replica reports terminal — but the gateway view
                # must not SAY so until the record tail is cached, or
                # a fast client reads `done` with an empty stream;
                # state and records publish together at settle
                try:
                    full = handle.get_job(
                        job.id, timeout=self.cfg.io_timeout)
                except Exception:
                    continue
                job.result = full.get("result", job.result)
                job.error = full.get("error", job.error)
                records = full.get("records") or []
                complete = any(
                    rec.get("jobEntry", {}).get("event") in TERMINAL
                    for rec in records)
                truncated = bool(full.get("records_truncated"))
                job.extra_polls += 1
                if complete or truncated or job.extra_polls >= 50:
                    # a resumed job's stream = the accumulated prefix
                    # (records of every previous incarnation through
                    # its shipped fence) + this final incarnation's
                    # tail — whole, duplicate-free (the restored
                    # `emitted` floor), and identical to an
                    # uninterrupted solve modulo timing/fault records.
                    # EXCEPT when the replica REJECTED the attached
                    # snapshot and demoted to a fresh replay (version
                    # skew, foreign fingerprint on a static fleet, an
                    # injected `resume` fault): its tail is then a
                    # complete from-gen-0 stream — detectable by the
                    # `admitted` jobEntry a resumed continuation never
                    # re-emits — and prepending the prefix would
                    # duplicate it wholesale
                    prefix = list(job.prefix)
                    prefix_trunc = job.prefix_truncated
                    if prefix and any(
                            rec.get("jobEntry", {}).get("event")
                            == "admitted" for rec in records):
                        prefix = []
                        prefix_trunc = False
                        self.registry.counter(
                            "fleet.resume.demoted").inc()
                    job.records = prefix + records
                    job.state = state
                    job.records_truncated = (truncated or not complete
                                             or prefix_trunc)
                    self._settle(job)
                    changed += 1
        return changed

    # -- the snapshot cache: resume, don't replay -----------------------

    def _fetch_snapshot(self, job: GatewayJob, handle,
                        final: bool = False) -> bool:
        """Refresh one in-flight job's cached ship unit from its
        owner (`?snapshot=1` — dispatcher thread, data-plane timeout).
        Only a FINGERPRINT-VALID snapshot (bucket + pop size + seed,
        verified stdlib-only via serve/snapshot.verify_wire) enters
        the cache; anything else counts `fleet.resume.rejected` and
        the job keeps its previous snapshot (or falls back to replay
        at failover). `final` marks the preempt-drain grab — fetch
        errors there are expected when the grace deadline races us."""
        if self.cfg.snapshot_hwm <= 0:
            return False
        try:
            # --snapshot-timeout, NOT --io-timeout: this runs on the
            # one dispatcher thread and is an optimization — a hung
            # replica export must cost seconds, not a 30 s io budget
            # times its in-flight jobs (which would starve routing/
            # polling/failover and trip the dispatcher_stalled
            # watchdog); a failed fetch keeps the previous cache
            view = handle.get_job(
                job.id, timeout=self.cfg.snapshot_timeout,
                with_records=False, snapshot=True)
        except Exception:
            self.registry.counter("fleet.resume.fetch_errors").inc()
            return False
        wire = view.get("snapshot")
        if not wire:
            return False
        self.registry.counter("fleet.resume.fetches").inc()
        try:
            # full fingerprint pre-validation only when the gateway
            # OWNS the worker flags (`--spawn N -- ...` — then its
            # parsed serve config IS the workers', no drift possible);
            # a static `--replica URL` fleet's serve config is not the
            # gateway's to know, so the check there is structural
            # (version/CRC/byte-count) + bucket consistency, and the
            # REPLICA's resume admission stays the authoritative
            # fingerprint gate either way (a bad snapshot demotes to
            # replay on arrival, never corrupts a stream)
            expect = None
            if self.cfg.serve_args and job.payload is not None:
                # a SETTLED job's payload (and with it the submit
                # seed) is released — its edit-base grab drops to the
                # structural + bucket check below, and the replica's
                # transplant classification stays the real gate
                seed = int(job.payload.get(
                    "seed", self.serve_cfg.seed))
                expect = snapshot_mod.wire_fingerprint(
                    job.bucket, self.serve_cfg.pop_size, seed)
            snapshot_mod.verify_wire(wire, expect_fingerprint=expect)
            if (job.bucket is not None
                    and list(wire.get("bucket", ()))
                    != list(job.bucket)):
                raise snapshot_mod.SnapshotMismatch(
                    f"snapshot bucket {wire.get('bucket')} != routed "
                    f"bucket {list(job.bucket)}")
        except Exception as e:
            self.registry.counter("fleet.resume.rejected").inc()
            self._rec(jsonl.fault_entry, self.writer, "snapshot_ship",
                      "reject", e, 0, 0, 0, self.tracer.now(),
                      job=job.id)
            return False
        gens = int(wire.get("gens_done", 0))
        if not final and gens < job.snap_gens:
            return False               # never replace newer with older
        records = list(view.get("snapshot_records") or ())
        # the replica declares the prefix's byte size (it computed it
        # once, on its handler); the fallback re-measure covers a
        # mixed-version fleet
        rec_bytes = view.get("snapshot_records_bytes")
        if rec_bytes is None:
            rec_bytes = sum(len(json.dumps(r)) for r in records)
        # the (snap, snap_records, ...) tuple is read by job_view
        # handlers under jobs_lock: mutate it under the same lock so a
        # client can never see fence N's snapshot with fence N+1's
        # records (the replica-side ShipUnit consistency, kept here)
        with self.jobs_lock:
            job.snap = wire
            job.snap_records = records
            job.snap_gens = gens
            job.snap_truncated = bool(view.get("snapshot_truncated"))
            job.snap_bytes = int(wire.get("bytes", 0)) + int(rec_bytes)
        self._evict_snapshots()
        return True

    def _evict_snapshots(self) -> None:
        """Hold the cache under `--snapshot-hwm`: evict SETTLED jobs'
        snapshots first (a done base's final wire only warms future
        edits — losing it demotes those to a counted cold solve,
        never a lost resume), then OLDEST-PROGRESS (the snapshot
        whose loss wastes the least re-run). An evicted job fails
        over by replay — counted, never silent
        (`fleet.resume.evictions`; the jobs fall into
        `fleet.resume.replays` if their failover comes)."""
        with self.jobs_lock:
            cached = [j for j in self.jobs.values()
                      if j.snap is not None]
            total = sum(j.snap_bytes for j in cached)
            while total > self.cfg.snapshot_hwm and cached:
                victim = min(cached, key=lambda j: (
                    not (j.terminal() and j.records_final),
                    j.snap_gens, j.submitted_t))
                cached.remove(victim)
                total -= victim.snap_bytes
                victim.snap = None
                victim.snap_records = []
                victim.snap_bytes = 0
                victim.snap_gens = 0
                self.registry.counter("fleet.resume.evictions").inc()
        self.registry.gauge("fleet.resume.bytes").set(float(total))
        self.registry.gauge("fleet.resume.cached").set(
            float(len(cached)))

    def _on_death(self, handle, respawned: bool) -> None:
        """ReplicaSet prober callback (PROBER thread): only enqueue —
        router/job state is touched exclusively on the dispatcher.
        A respawned worker comes back cold, so its jobs fail over
        exactly like a dead one's (the handle stays live and may win
        them back)."""
        self.inbox.put(("failover", handle.name))

    def _failover(self, name: str) -> None:
        """A replica died (prober callback, via the inbox — so router
        state is only ever touched on this thread): forget its pins
        and warmth, then resubmit every unfinished job it owned.
        Idempotent by job id: the payload (id, seed, generation
        budget) replays verbatim, partial record tails are discarded,
        and the fresh solve's stream replaces them wholesale — the
        client observes exactly one completion with exactly one record
        stream. A job that COMPLETED on the dead replica but whose
        records the polls had not finished caching is replayed too:
        the stream is a pure function of the job, so the replay emits
        the identical records the lost copy held."""
        self.router.on_replica_dead(name)
        with self.jobs_lock:
            victims = [j for j in self.jobs.values()
                       if j.replica == name
                       and not (j.terminal() and j.records_final)]
        if self.flight is not None:
            # one stitched incident per failover: the gateway's own
            # rings + the dead replica's last bundle (live pull when
            # it still answers, the prober's cached copy otherwise) —
            # enqueued here, pulled and written on the RECORDER thread
            self.flight.trigger(f"failover:{name}", peers=[name])
        with self.tracer.span("failover", cat="fleet", replica=name,
                              jobs=len(victims),
                              flow=[j.flow for j in victims if j.flow]):
            for job in victims:
                self._reassign(job)

    def _reassign(self, job: GatewayJob) -> None:
        """One job's failover or preemption re-placement: RESUME when
        a fingerprint-valid snapshot is cached — the payload resends
        with the wire snapshot attached, the new replica admits it
        parked at the shipped progress, and the shipped record prefix
        joins this job's accumulated `prefix` so the settled stream is
        whole and duplicate-free. Without a
        cached snapshot the job REPLAYS exactly as before — unless a
        previously attached payload snapshot survives, which resumes
        from that older fence (deterministic lanes re-emit the lost
        middle identically, so the accumulated prefix stays valid).
        A pending cancel is honored either way (the replica that
        would have solved the rest is gone anyway)."""
        if job.cancel_requested:
            job.state = "cancelled"
            self._settle(job)
            return
        if job.snap is not None:
            # resume: consume the cached unit into payload + prefix
            # (under jobs_lock — job_view handlers read these fields).
            # A ship unit whose records carry an `admitted` jobEntry
            # came from an incarnation that REPLAYED from gen 0 (its
            # own resume was demoted) — those records are a complete
            # stream and REPLACE the accumulated prefix; appending
            # would duplicate every record the replay re-emitted.
            with self.jobs_lock:
                job.payload = dict(job.payload, snapshot=job.snap)
                fresh = any(
                    rec.get("jobEntry", {}).get("event") == "admitted"
                    for rec in job.snap_records)
                job.prefix = (list(job.snap_records) if fresh
                              else list(job.prefix)
                              + list(job.snap_records))
                job.prefix_truncated = (job.snap_truncated
                                        if fresh
                                        else job.prefix_truncated
                                        or job.snap_truncated)
                job.snap = None
                job.snap_records = []
                job.snap_bytes = 0
                # snap_gens is kept: it is the new incarnation's
                # starting progress — the fetch throttle's baseline
            self._evict_snapshots()    # republish the byte gauges
            self.registry.counter("fleet.resume.hits").inc()
            self._rec(self.tracer.record, "resume", self.now(), 0.0,
                      cat="fleet", job=job.id, flow=job.flow,
                      gens=job.snap_gens)
        elif (job.payload or {}).get("snapshot") is None:
            job.snap_gens = 0
            job.prefix = []
            job.prefix_truncated = False
            self.registry.counter("fleet.resume.replays").inc()
        job.records = []
        job.records_final = False
        job.records_truncated = False
        job.replica = None
        job.state = "accepted"
        job.extra_polls = 0
        job.place_started = self.now()       # fresh placement budget
        self.registry.counter("fleet.jobs_failed_over").inc()
        self._place(job)

    def _settle(self, job: GatewayJob) -> None:
        """A job is terminal AND its records are cached: final
        accounting, then retention — the payload (the whole `.tim`
        text, kept only for failover replay) is released, and settled
        jobs beyond `--retain-terminal` are evicted oldest-first (a
        long-running gateway must not hold every instance it ever
        served; an evicted id answers 404)."""
        job.records_final = True
        if job.finished_t is None:
            job.finished_t = self.now()
        # a settled job may still be named as an edit BASE:
        # keep just the inline instance (its edited form for an edit
        # job) — the bulk of the payload (attached snapshots, op
        # lists) is still released, and the basis leaves with the job
        # at --retain-terminal eviction
        bp = job.payload or {}
        basis = {k: bp[k] for k in ("tim", "problem", "n_days",
                                    "slots_per_day") if k in bp}
        if "tim" not in basis and "problem" not in basis:
            edited = (bp.get("edit") or {}).get("edited")
            basis = dict(edited) if isinstance(edited, dict) else None
        job.edit_basis = basis or None
        job.payload = None
        job.counts = None
        job.prefix = []
        if job.snap is not None:
            # a settled job needs no warm start; drop its cache share
            with self.jobs_lock:
                job.snap = None
                job.snap_records = []
                job.snap_bytes = 0
            self._evict_snapshots()    # republish the byte gauges
        if not job.counted:
            job.counted = True
            name = ("fleet.jobs_done" if job.state == "done"
                    else "fleet.jobs_failed")
            self.registry.counter(name).inc()
            latency = job.finished_t - job.submitted_t
            self.registry.histogram("fleet.job_seconds").observe(
                latency, exemplar={"job": job.id})
            self._slo_lat.append(latency)
            # the settle point on the job's chain: the instant state
            # and records publish together (zero-duration marker span)
            self._rec(self.tracer.record, "settle", self.now(), 0.0,
                      cat="fleet", job=job.id, flow=job.flow,
                      state=job.state, replica=job.replica,
                      latency_s=round(latency, 6))
        self._terminal_order.append(job.id)
        while len(self._terminal_order) > self.cfg.retain_terminal:
            evicted = self._terminal_order.pop(0)
            with self.jobs_lock:
                self.jobs.pop(evicted, None)

    def _fail(self, job: GatewayJob, reason: str) -> None:
        job.state = "failed"
        job.error = reason
        if job.prefix and not job.records:
            # what progress the dead incarnations did emit stays
            # visible on the failed view (honest partial stream)
            job.records = list(job.prefix)
            job.records_truncated = True
        self._settle(job)

    def _drain_tick(self) -> None:
        if not self.draining or self.drained.is_set():
            return
        with self.jobs_lock:
            active = [j for j in self.jobs.values()
                      if not (j.terminal() and j.records_final)]
        if active or not self.inbox.empty():
            return
        # every job settled AND its records are cached — only now may
        # owned replicas drain (they exit after draining; a replica
        # that exits before the gateway cached its tails would lose
        # them)
        if self.owned:
            self.replicas.stop_restarts()
            for handle in self.replicas.live():
                try:
                    handle.drain(timeout=self.cfg.probe_timeout)
                except Exception:
                    pass
        self.drained.set()


# ---------------------------------------------------------------- CLI


def main_fleet(argv) -> int:
    """The `fleet` entry point (cli.py dispatches here). Runs until a
    POST /v1/drain (or SIGTERM/SIGINT, mapped to the same drain)
    completes."""
    import signal

    cfg = parse_fleet_args(argv)
    from timetabling_ga_tpu_torch.fleet import replicas as replicas_mod
    if cfg.spawn:
        handles = replicas_mod.spawn_local(cfg)
    else:
        handles = [replicas_mod.ReplicaHandle(f"r{i}", url)
                   for i, url in enumerate(cfg.replicas)]
    gw = Gateway(cfg, handles, owned=bool(cfg.spawn))
    gw.start()
    print(f"# tt fleet: gateway on {gw.url} fronting "
          f"{len(handles)} replica(s): "
          f"{', '.join(h.url for h in handles)}",
          file=sys.stderr, flush=True)

    def _drain(signum, frame):
        print("# tt fleet: drain requested", file=sys.stderr,
              flush=True)
        gw.request_drain()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    try:
        while not gw.drained.wait(0.5):
            pass
    finally:
        gw.close()
    return 0
