"""The service frontend: Python API + line-JSON protocol (port of
timetabling_ga_tpu/serve/service.py:64-459).

Python API:

    from timetabling_ga_tpu_torch.runtime.config import ServeConfig
    from timetabling_ga_tpu_torch.serve.service import SolveService

    svc = SolveService(ServeConfig(backend="cpu"), out=stream)
    jid = svc.submit(problem, generations=100, priority=5)
    svc.drive()                       # run until every job settles
    svc.result(jid)                   # {"best": ..., "feasible": ...}
    svc.close()

Line-JSON protocol (`python -m timetabling_ga_tpu_torch serve`): one
request object per input line, one record per output line — the
engine's JSONL protocol with each record tagged `"job"`, plus the
`jobEntry` lifecycle records:

    {"submit": {"id": "j1", "instance": "comp01.tim", "priority": 5,
                "seed": 42, "generations": 200, "deadline": 30.0,
                "tenant": "acme"}}
    {"submit": {"id": "j2", "tim": "4 2 2 5\\n..."}}   inline instance
    {"submit": {"id": "j3", "tim": ..., "snapshot": {wire}}}  warm start
    {"submit": {"id": "j4", "edit": {"base": {"tim": ...}, "ops": [...],
                "w_anchor": 1, "snapshot": {base wire}}}}  edit job
    {"cancel": "j1"}
    {"stats": true}                    metricsEntry snapshot
    {"stats": "prometheus"}            ... carrying the text exposition
    {"drain": true}                    run everything admitted so far

`serve --http HOST:PORT` serves the same service as a fleet replica
(fleet/replicas.py): JAX's `/v1` solve API instead of this protocol.
The replica reads the attributes `registry`, `writer`, `scheduler`,
`queue`, `profile_capture`, `history`, `flight`, `usage` and `device`.

Requests are processed in order; `drain` (and the end of the input)
hands the queue to the scheduler. A malformed request or a rejected
submission (a malformed edit spec among them) emits a jobEntry (event
"rejected") and the stream goes on. A `snapshot` wire (serve/
snapshot.py) warm-starts the job at the wire's progress, or falls back
to a fresh solve; an `edit` (serve/editsolve.py) solves the edited
instance under the anchored objective, warm from its base wire when it
stays in the base's bucket.

Under --obs the scheduler's spans (serve/scheduler.py) ride the record
writer through this service's SpanTracer. With metering on (the
default) a UsageLedger (obs/usage.py) settles each quantum on its own
thread; under --obs it writes usageEntry records through the same
writer. `close` closes the ledger before the writer drains, so its last
records are written (a hung ledger is abandoned, never waited out).

Records ride a jsonl.AsyncWriter (its queue is the `writer.queue_depth`
gauge that `--shed-writer-hwm` reads); `drive` returns with them written
and `close` drains it. The fault plan (`--faults`, else `$TT_FAULTS`) is
installed when the service starts, as JAX's service does: the serve
path's sites are `writer`, `fetch`, `quantum`, `resume` and `edit`, and
those of the observability threads below.

`--obs-listen`, `--history-every`, `--incident-dir` and
`--mem-poll-every` wire the pull front, the history ring, the flight
recorder and the memory poller as engine.run does, over this service's
registry (JAX service.py:102-205): a quantum fault's faultEntry dumps a
bundle, and /readyz reads `backlog_full` while the queue is at its
bound. A listener that cannot bind raises from the constructor with
every thread it started closed. The cost observatory binds its
costEntry records to this service's writer under --obs, and
`--profile-dir` / `--profile-for` (or `--obs-listen`'s /profile) wire
an on-demand capture ticked once a quantum retires, as engine.run does
(JAX service.py:128-150).
"""

from __future__ import annotations

import json
import sys

from timetabling_ga_tpu_torch.obs import cost as obs_cost
from timetabling_ga_tpu_torch.obs import prof as obs_prof
from timetabling_ga_tpu_torch.obs import flight as obs_flight
from timetabling_ga_tpu_torch.obs import metrics as obs_metrics
from timetabling_ga_tpu_torch.obs import usage as obs_usage
from timetabling_ga_tpu_torch.obs.spans import SpanTracer
from timetabling_ga_tpu_torch.problem import load_tim, load_tim_file
from timetabling_ga_tpu_torch.runtime import faults, jsonl
from timetabling_ga_tpu_torch.runtime.config import (
    ServeConfig, parse_serve_args)
from timetabling_ga_tpu_torch.serve.queue import Job, JobQueue, tenant_label
from timetabling_ga_tpu_torch.serve.scheduler import Scheduler


class SolveService:
    """Owns the queue, the scheduler and the job-tagged record stream.
    Runs on the card unless cfg.backend is "cpu"."""

    def __init__(self, cfg: ServeConfig, out=None, now=None,
                 registry=None):
        import torch
        from timetabling_ga_tpu_torch import kernels
        from timetabling_ga_tpu_torch.runtime.engine import resolve_device
        self.cfg = cfg
        self.device = resolve_device(cfg.backend)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            kernels.build()
        self._registry = (obs_metrics.REGISTRY if registry is None
                          else registry)
        # installed only when a spec is given: a plan a caller installed
        # before constructing the service stays (JAX service.py:90-101)
        spec = faults.active_spec(cfg.faults)
        if spec:
            faults.install(spec)
        self._close_out = False
        if out is None:
            if cfg.output:
                out = open(cfg.output, "w")
                self._close_out = True
            else:
                out = sys.stdout
        self._raw_out = out
        # the history ring and the flight recorder, as engine.run wires
        # them (JAX service.py:102-117), reporting into this service's
        # registry
        self.history, self.flight, sink = obs_flight.wire(
            cfg, out, registry=self._registry, process="serve")
        self.writer = self.out = jsonl.AsyncWriter(sink)
        # spans ride the writer; the writer's pull gauges re-bind to
        # this service's writer
        self.tracer = SpanTracer(self.writer, enabled=cfg.obs)
        if self.flight is not None:
            self.flight.bind_tracer(self.tracer)
            self.flight.start()
        self._registry.gauge_fn("writer.queue_depth", self.writer.qsize)
        self._registry.gauge_fn(
            "writer.records", lambda: self.writer.records_written)
        # the cost observatory's costEntry records bind to this
        # service's writer under --obs (a timing record either way)
        obs_cost.OBSERVATORY.bind(self.writer if cfg.obs else None,
                                  now=self.tracer.now)
        # the memory poller on its own thread, off the serve path
        self.mem_poller = None
        if (cfg.obs or cfg.obs_listen) and cfg.mem_poll_every > 0:
            self.mem_poller = obs_cost.MemPoller(
                obs_cost.torch_memory_stats_fn(self.device),
                cfg.mem_poll_every, registry=self._registry).start()
        # the on-demand capture on its own worker thread; finished
        # captures attribute themselves there into this service's
        # registry (and its writer under --obs)
        self.profile_capture = None
        if cfg.profile_for > 0 or cfg.obs_listen:
            tp = obs_prof.TorchProfiler(self.device, all_threads=True)
            self.profile_capture = obs_cost.ProfileCapture(
                tp.start, tp.stop, default_dir=cfg.profile_dir)
            self.profile_capture.on_complete = obs_prof.capture_hook(
                self.writer if cfg.obs else None,
                registry=self._registry, now=self.tracer.now)
            if cfg.profile_for > 0:
                self.profile_capture.trigger(cfg.profile_for)
        # the usage ledger's own thread folds the per-tenant settlement
        # off the drive loop; --no-usage drops the meter
        self.usage = None
        if cfg.usage:
            self.usage = obs_usage.UsageLedger(
                registry=self._registry,
                out=(self.writer if cfg.obs else None),
                now=self.tracer.now)
        self.queue = JobQueue(cfg.backlog, now=now)
        self.scheduler = Scheduler(cfg, self.queue, self.writer,
                                   self.device, now=now,
                                   registry=self._registry,
                                   tracer=self.tracer, usage=self.usage,
                                   profiler=self.profile_capture)
        self._auto_id = 0
        self.obs_server = None
        if cfg.obs_listen:
            # the pull front (obs/http.py) over this service's registry;
            # it writes no records
            try:
                from timetabling_ga_tpu_torch.obs import http as obs_http
                self.obs_server = obs_http.ObsServer(
                    cfg.obs_listen, registry=self._registry,
                    probes={"process": lambda: True,
                            "writer": self.writer.alive},
                    profile=self.profile_capture,
                    history=self.history).start()
            except BaseException:
                # a failed construction (the port is taken, say) never
                # reaches close(): the threads started above must not
                # outlive the service, nor the registry's pull gauges
                # keep its writer and queue alive (JAX
                # service.py:184-205)
                if self.profile_capture is not None:
                    self.profile_capture.close()
                if self.mem_poller is not None:
                    self.mem_poller.close()
                if self.usage is not None:
                    self.usage.close()
                if self.flight is not None:
                    self.flight.close()
                if self.history is not None:
                    self.history.close()
                obs_cost.OBSERVATORY.unbind()
                self.writer.close(raise_error=False)
                self._freeze_gauges()
                raise

    @property
    def registry(self):
        return self._registry

    def submit(self, problem, job_id=None, priority: int = 0, seed=None,
               generations=None, deadline_s=None, tenant=None,
               snapshot=None, edit=None, flow: int = 0,
               count_job: bool = True) -> str:
        """Admit one job; returns its id (JAX service.py:222). Raises
        AdmissionError when the backlog is full or the id is taken; an
        instance that cannot be padded or placed raises before the queue
        takes the job. `snapshot` is a warm-start wire: the job is
        admitted PARKED at its progress, `generations` staying the whole
        budget; a wire that fails validation falls back to a fresh solve.
        `edit` is an edit spec (serve/editsolve.py): the edited instance
        is derived from it (`problem` may be None), the base wire's best
        timetable anchors it at weight w_anchor, and its population is
        transplanted from the base wire when the edit stays in the base's
        bucket, else the job runs cold (demoted, counted); a malformed
        spec raises EditError. An edit job with a `snapshot` of its own
        resumes from that instead. `flow` is a flow id the job inherits
        (a gateway's X-TT-Flow: its spans here continue the gateway's
        chain; 0 lets the scheduler make one), and `count_job=False`
        marks a fleet resend (X-TT-Resubmit): metered, but not counted
        again in its tenant's `jobs`."""
        if job_id is None:
            self._auto_id += 1
            job_id = f"job-{self._auto_id}"
        mode, edit_map, edit_of, base_wire = "solve", None, None, None
        if edit is not None:
            from timetabling_ga_tpu_torch.serve import editsolve
            _base, edited, edit_map, _ops = editsolve.resolve_edit(edit)
            base_wire = edit.get("snapshot")
            w_anchor = int(edit.get("w_anchor",
                                    editsolve.DEFAULT_ANCHOR_W))
            problem = editsolve.attach_anchor(
                edited, edit_map, editsolve.anchor_from_wire(base_wire),
                w_anchor)
            mode = "edit"
            edit_of = edit.get("base_id") or (
                edit["base"] if isinstance(edit["base"], str) else None)
        job = Job(id=str(job_id), problem=problem, priority=int(priority),
                  seed=int(self.cfg.seed if seed is None else seed),
                  generations=int(self.cfg.generations
                                  if generations is None else generations),
                  deadline_s=deadline_s, tenant=tenant_label(tenant),
                  count_usage=bool(count_job), flow=int(flow or 0),
                  resume_wire=snapshot, mode=mode, edit_of=edit_of,
                  edit_map=edit_map)
        self.scheduler.prepare(job)
        self.queue.submit(job)
        if mode == "edit" and job.resume_wire is None:
            # after the queue takes the job (its faultEntry joins its
            # stream), before admit (the wire warm-starts it)
            self.scheduler.prepare_edit(job, base_wire)
        self.scheduler.admit(job)
        return job.id

    def cancel(self, job_id: str) -> bool:
        ok = self.queue.cancel(job_id)
        if ok:
            jsonl.job_entry(self.out, job_id, "cancelled")
        return ok

    def drive(self) -> None:
        """Run dispatches until every admitted job settles; returns with
        their records written."""
        self.scheduler.drive()
        self.writer.drain()

    def step(self) -> bool:
        """One dispatch cycle (for callers interleaving submissions)."""
        return self.scheduler.step()

    def result(self, job_id: str):
        return self.queue.get(job_id).result

    def state(self, job_id: str) -> str:
        return self.queue.get(job_id).state

    def stats(self) -> dict:
        """Live metrics-registry snapshot (the metricsEntry payload)."""
        return self._registry.snapshot()

    def prometheus(self) -> str:
        """Prometheus text exposition of the registry (format 0.0.4)."""
        return self._registry.to_prometheus()

    def emit_stats(self, prometheus: bool = False) -> None:
        """Answer a `stats` request: one metricsEntry, carrying the text
        exposition under `prometheus` when asked."""
        snap = self.stats()
        if prometheus:
            snap["prometheus"] = self.prometheus()
        jsonl.metrics_entry(self.out, snap, ts=self.tracer.now())

    def _freeze_gauges(self) -> None:
        """Release the registry's pull gauges: they must not keep this
        service's writer, queue and scheduler alive."""
        self._registry.freeze("writer.records", self.writer.records_written)
        for name in ("writer.queue_depth", "serve.queue_depth",
                     "serve.resident_groups", "serve.resident_bytes"):
            self._registry.freeze(name, 0.0)

    def close(self) -> None:
        """Stop the listener and the memory poller, close the usage
        ledger (its pending settlements enqueue their records), drain and
        stop the writer, then close the flight recorder (the tee's last
        records are in its rings; a pending trigger dumps in its close)
        and the history ring, release the registry's pull gauges and
        close -o (JAX service.py:360-390)."""
        if self.obs_server is not None:
            self.obs_server.close()
        if self.profile_capture is not None:
            self.profile_capture.close()
        if self.mem_poller is not None:
            self.mem_poller.close()
        if self.usage is not None:
            self.usage.close()
        try:
            self.writer.close()
        finally:
            if self.flight is not None:
                self.flight.close()
            if self.history is not None:
                self.history.close()
            # the global must not hold this service's writer
            obs_cost.OBSERVATORY.unbind()
            self._freeze_gauges()
            if self._close_out:
                self._raw_out.close()


def _load_submit_problem(req: dict):
    if "edit" in req:
        return None          # the edit spec derives the instance
    if "tim" in req:
        return load_tim(req["tim"])
    return load_tim_file(req["instance"])


def serve_stream(cfg: ServeConfig, in_stream, out_stream=None, now=None,
                 registry=None) -> SolveService:
    """Run the line-JSON protocol over `in_stream` to completion. Returns
    the (closed) service so callers can inspect results. A bad request
    is reported on the record stream and skipped."""
    svc = SolveService(cfg, out=out_stream, now=now, registry=registry)
    try:
        for line in in_stream:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except ValueError as e:
                jsonl.job_entry(svc.out, "?", "rejected",
                                reason=f"bad request: {e}")
                continue
            if "submit" in req:
                sub = req["submit"]
                try:
                    svc.submit(_load_submit_problem(sub),
                               job_id=sub.get("id"),
                               priority=sub.get("priority", 0),
                               seed=sub.get("seed"),
                               generations=sub.get("generations"),
                               deadline_s=sub.get("deadline"),
                               tenant=sub.get("tenant"),
                               snapshot=sub.get("snapshot"),
                               edit=sub.get("edit"))
                except Exception as e:
                    # one bad tenant must not take down the service: any
                    # submit-side failure is a rejection record, and
                    # submit() leaves no partial state behind
                    jsonl.job_entry(svc.out, str(sub.get("id", "?")),
                                    "rejected", reason=str(e)[:200])
            elif "cancel" in req:
                svc.cancel(str(req["cancel"]))
            elif "stats" in req:
                svc.emit_stats(prometheus=req["stats"] == "prometheus")
            elif "drain" in req:
                svc.drive()
            else:
                jsonl.job_entry(svc.out, "?", "rejected",
                                reason=f"unknown request "
                                       f"{sorted(req)[:3]}")
        svc.drive()
    finally:
        svc.close()
    return svc


def main_serve(argv) -> int:
    """The `serve` subcommand (cli.py dispatches here). With --http the
    same service is a fleet replica: a drive loop fed by a command inbox
    behind the `/v1` front (fleet/replicas.py serve_http) instead of
    line-JSON on stdio."""
    cfg = parse_serve_args(argv)
    if cfg.http:
        from timetabling_ga_tpu_torch.fleet.replicas import serve_http
        return serve_http(cfg)
    if cfg.input:
        with open(cfg.input, "r") as fh:
            serve_stream(cfg, fh)
    else:
        serve_stream(cfg, sys.stdin)
    return 0
