"""The serve scheduler: pack, time-slice, park, resume (port of
timetabling_ga_tpu/serve/scheduler.py:104-1130 on one card).

  PACKING   runnable jobs are grouped by bucket key (serve/bucket.py):
            same-bucket jobs share every shape, so up to `lanes` of them
            ride one dispatch, a lane each (problem.LaneProblems: each
            job's padded problem stays its own tensors, placed once at
            `prepare`; a pack builds the lane table K6 and K8's chain
            read, and rebuilds it only when the pack changes).

  SLICING   a dispatch runs min(quantum, remaining) generations a lane
            (islands.lane_run; a lane whose count is reached drops out
            of the launches). Between dispatches is the control fence:
            cancellations, deadlines and new jobs take effect there.

  PARKING   a job's population between quanta is a host snapshot
            (dispatch_core.fetch_state), placed back with
            dispatch_core.place_state at its next slice. Every host park
            fence is also a ship fence: the job's ShipUnit (serve/
            snapshot.py) is replaced by that fence's state and the
            record prefix emitted through it (`_ship_rec`, bounded), the
            unit a warm start elsewhere resumes from.

  RESIDENCY while a group's lanes are unchanged between consecutive
            quanta (same bucket, same jobs in the same order) its state
            stays on the card and only the trace is fetched. A group
            may stay only when every member has a ship unit (JAX's
            `job.ship is not None`): a fresh job parks once first, a
            warm-started job has one from admission. Residency ends on
            a repack, a finishing job, a deadline, an idle fence or
            `flush_resident` (a ship request, or the fleet replica's
            preempt drain), each of which parks the group (a flush).
            While resident a job's snapshot and ship unit are its last
            host fence's: a deadline flushes the group before it
            finalizes the job. --no-resident parks every quantum; the
            record stream is the same either way.

  FRESHNESS (JAX :36-50) a handler serving `?snapshot=1` on a resident
            job (fleet/replicas.py) touches nothing on the card: it
            calls `request_flush`, which only sets a flag, and marks the
            job `ship_hot`. The next control fence (the top of `step`)
            consumes the flag with flush_resident("request"); while the
            flag is pending no group re-enters residency, at resume or
            at park; and a group holding a ship_hot job parks at every
            fence, so a polling gateway's wire stays within one quantum
            of the job's cursor. The stay rule is JAX's; so are the
            flush reasons on the `flush` spans ("repack", "deadline",
            "idle", "request", "preempt"), except that a caller of
            flush_resident that names none gets "ship".

  WARM STARTS a submit's `snapshot` wire admits the job PARKED at the
            wire's progress (`_admit_resumed`): no init, the stream
            continuing from the wire's `emitted` floor, one faultEntry
            (site fleet, action resume) as the seam. A wire that fails
            validation falls back to a fresh solve (faultEntry resume /
            replay, serve.jobs_resume_rejected). An edit job (serve/
            editsolve.py) is warm-started from a population transplanted
            out of its base wire (`prepare_edit`), or demoted to a cold
            solve of its edited instance.

  TELEMETRY each quantum's leaf is packed under --trace-mode and
            --quality (islands.lane_run) and decoded by
            dispatch_core.decode_telemetry; the quality rows of the real
            lanes fold into the quality.* counters and gauges, and under
            --obs each lane's is a job-tagged qualityEntry.

  SPANS     under --obs (JAX :251-317, :391-399, :447, :520-563,
            :614-679, :942, :1032, :1056): `admit`, `pack` (with `init`
            inside it for fresh jobs), `resume`, `quantum`, `park`
            (`finalize` inside it for a finishing job), `flush`, `shed`
            and a warm start's `recover`, each carrying its jobs' ids
            and flows (a job's flow is set at admission, so every span
            of its life is one chain), and a metricsEntry every
            --metrics-every dispatches.

  METERING  with metering on (the default; --no-usage turns it off),
            each quantum is metered at its park fence (`_meter_quantum`,
            JAX :775-848): its wall, minus any kernel build inside it,
            split over the lanes by the generations each ran
            (obs/usage.split: the shares sum exactly to the totals),
            plus each job's queue and park waits, folded into Job.usage
            and handed to the UsageLedger's thread. Two of JAX's inputs
            have counterparts of their own: compile_seconds is the wall
            `kernels.build()` spent inside that quantum (JAX: the
            lower+compile wall a cold dispatch paid), 0 once the kernels
            are built and never left inside device_seconds; flops is the
            lane runner's counted work over the quantum (obs/cost.py
            CostProgram.last_cost, the kernels' launches' work.py
            counts; JAX: XLA's cost_analysis of the lane program), split
            on the integer grid. Only occupied lanes run, so no wall is
            idle-lane overhead: `overhead_device_seconds` is 0. A
            finished job's result carries `tenant` and `usage`, the
            ledger writes its `event: "total"` usageEntry, and every
            ship unit carries the meter as the wire's cursor, which a
            warm start continues.

  FAIRNESS  buckets are served round-robin; within one, jobs go in
            (priority desc, generations served asc, arrival) order.

  SHEDDING  at the top of every step (the control fence), while
            `serve.queue_depth` or `writer.queue_depth` is at or over
            --shed-queue-hwm / --shed-writer-hwm, the lowest-priority
            runnable job is released: state SHED, a jobEntry `shed`,
            `serve.jobs_shed` (JAX scheduler.py:407-460).

  RECOVERY  a failed quantum (the `quantum` fault site fires before each
            lane dispatch) touches only its dispatch's jobs
            (`_recover_quantum`, JAX :845-912): a transient error
            requeues each from its park snapshot, a resident group's
            cursors rolled back to the host fence its snapshots hold, so
            the replay repeats the same chunks and the emitted floor
            keeps the stream equal to an uninjected run's; a
            non-transient error, or a job past --max-job-recoveries,
            fails that job alone. A warm start whose admission fails
            (site `resume`) replays from scratch, and an edit whose
            transplant fails (site `edit`) runs cold, each with a
            faultEntry.

Randomness: lane l of a dispatch runs its job's chunk c from
islands.lane_generator(seed, c), and its init from the job's init
generator: a job's records are the same alone or packed with any
co-tenants, resident or not, across repacks.

One card: the dispatch is as wide as pad_lanes(cfg.lanes) (the
`serve.lanes` gauge), a stacked state of that many lanes is placed and
parked as JAX's is (so `serve.resume_bytes` and `serve.park_bytes` count
what JAX's do on the same schedule), but only occupied lanes run: the
port has no compile cache keyed on the width, so JAX's zero-generation
filler lanes would be idle work.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.obs import cost as obs_cost
from timetabling_ga_tpu_torch.obs import metrics as obs_metrics
from timetabling_ga_tpu_torch.obs import quality as obs_quality
from timetabling_ga_tpu_torch.obs import usage as usage_mod
from timetabling_ga_tpu_torch.obs.spans import NULL_TRACER
from timetabling_ga_tpu_torch.ops import ga
from timetabling_ga_tpu_torch.parallel import islands
from timetabling_ga_tpu_torch.problem import LaneProblems
from timetabling_ga_tpu_torch.runtime import dispatch_core as dcore
from timetabling_ga_tpu_torch.runtime import faults, jsonl, retry
from timetabling_ga_tpu_torch.runtime.config import ServeConfig
from timetabling_ga_tpu_torch.serve import bucket as bucket_mod
from timetabling_ga_tpu_torch.serve import snapshot as snapshot_mod
from timetabling_ga_tpu_torch.serve.queue import (
    DEFAULT_TENANT, Job, JobQueue, JobState)

INT_MAX = 2 ** 31 - 1


def _stack_states(snaps, pop: int, n_lanes: int, n_events: int
                  ) -> ga.PopState:
    """Per-job host snapshots, then filler lanes (zero rows, INT_MAX
    scores) up to `n_lanes`, as one (n_lanes * pop, E) host state."""
    parts = list(snaps)
    for _ in range(n_lanes - len(parts)):
        parts.append(ga.PopState(
            np.zeros((pop, n_events), np.int32),
            np.zeros((pop, n_events), np.int32),
            *(np.full((pop,), INT_MAX, np.int32) for _ in range(3))))
    return ga.PopState(*(np.concatenate([p[i] for p in parts])
                         for i in range(len(ga.PopState._fields))))


def _slice_state(host: ga.PopState, lane: int, pop: int) -> ga.PopState:
    """One lane's rows of a stacked host state, copied."""
    lo, hi = lane * pop, (lane + 1) * pop
    return ga.PopState(*(np.array(x[lo:hi]) for x in host))


def serve_ga_config(cfg: ServeConfig) -> ga.GAConfig:
    """The serve generation (JAX scheduler.py:201-204): the default
    GAConfig — the random-candidate delta search, no sweep, no
    migration — at the service's pop size, with maxSteps // candidates
    rounds of cfg.ls_candidates candidates."""
    return ga.GAConfig(pop_size=cfg.pop_size,
                       ls_steps=max(1, cfg.max_steps // cfg.ls_candidates),
                       ls_candidates=cfg.ls_candidates)


class Scheduler:
    """Drives a JobQueue through the lane runner on `device`."""

    def __init__(self, cfg: ServeConfig, queue: JobQueue, out, device,
                 now=None, registry=None, tracer=NULL_TRACER, usage=None,
                 profiler=None):
        self.cfg = cfg
        self.queue = queue
        self.out = out
        self.device = device
        self.tracer = tracer
        self._now = now or time.monotonic
        self._dispatches = 0
        # the UsageLedger (obs/usage.py) the service wires under
        # cfg.usage: job meters fold inline at each park fence, tenant
        # settlement rides the ledger's thread; None = metering off
        self._usage = usage
        # the on-demand capture (obs/cost.py ProfileCapture), ticked once
        # a quantum retires
        self._profiler = profiler
        self._metrics = (obs_metrics.REGISTRY if registry is None
                         else registry)
        self._metrics.gauge_fn("serve.queue_depth",
                               lambda: len(queue.active()))
        self._metrics.gauge("serve.backlog").set(cfg.backlog)
        self.spec = bucket_mod.BucketSpec(
            event_floor=cfg.bucket_events, room_floor=cfg.bucket_rooms,
            feature_floor=cfg.bucket_features,
            student_floor=cfg.bucket_students, ratio=cfg.bucket_ratio)
        self.lanes = islands.pad_lanes(cfg.lanes)
        self._metrics.gauge("serve.mesh_devices").set(1)
        self._metrics.gauge("serve.lanes").set(self.lanes)
        # bucket key -> {"jids": lane-ordered job ids, "state": the
        # group's PopState on the card}
        self._resident: dict = {}
        self._metrics.gauge_fn("serve.resident_groups",
                               lambda: len(self._resident))
        self._metrics.gauge_fn("serve.resident_bytes",
                               lambda: float(self._resident_bytes()))
        # a ship request from a handler thread (request_flush), consumed
        # at the next control fence
        self._flush_req = False
        # bucket key -> (lane-ordered job ids, their LaneProblems)
        self._packs: dict = {}
        self.gacfg = serve_ga_config(cfg)
        self._rr = 0               # round-robin cursor over buckets
        self._overflow_warned = False

    # -- admission ------------------------------------------------------

    def prepare(self, job: Job) -> None:
        """Pad the instance to its bucket and place the padded problem
        on the card, once for the job's life. Called before the queue
        takes the job: an instance that fails here leaves no trace."""
        job.padded = bucket_mod.pad_problem(job.problem, self.spec)
        job.bucket = bucket_mod.bucket_key(job.problem, self.spec)
        job.pa_dev = job.padded.device_arrays(self.device)

    def prepare_edit(self, job: Job, base_wire) -> None:
        """Warm-start an edit job from its base wire (JAX scheduler.py:
        220), after `prepare` and only when the job brings no wire of its
        own: the transplanted population becomes job.resume_wire, which
        `admit` restores as any warm start. Any failure (a cross-bucket
        edit, no or a bad base wire, a population mismatch) demotes the
        job to a cold solve of its edited instance: one faultEntry (site
        edit, action demote) and serve.jobs_edit_demoted, never an
        error; so does a fault at the site `edit`."""
        from timetabling_ga_tpu_torch.serve import editsolve
        self._metrics.counter("serve.jobs_edit").inc()
        try:
            faults.maybe_fail("edit")
            job.resume_wire = editsolve.transplant(
                job.padded, job.edit_map, base_wire, bucket=job.bucket,
                pop_size=self.cfg.pop_size, seed=job.seed, pa=job.pa_dev)
        except KeyboardInterrupt:
            raise
        except BaseException as e:
            job.edit_demoted = True
            job.resume_wire = None
            jsonl.fault_entry(self.out, "edit", "demote", e, 0, 0, 0,
                              self._now() - job.submitted_t, job=job.id)
            self._metrics.counter("serve.jobs_edit_demoted").inc()

    def admit(self, job: Job) -> None:
        """Record the admission (after queue.submit succeeds). A job with
        a warm-start wire is admitted PARKED at the wire's progress when
        the wire holds (`_admit_resumed`): only an edit job then writes
        its admitted jobEntry (its transplant is its birth, not a
        recovery seam); a wire that fails falls back to a fresh job. The
        job's flow is set here (a job that brought one keeps it), and a
        fresh job joins its tenant's `jobs` count."""
        if not job.flow:
            job.flow = self.tracer.new_flow()
        resumed = (job.resume_wire is not None
                   and self._admit_resumed(job))
        if resumed and not (job.mode == "edit" and job.count_usage):
            self._metrics.counter("serve.jobs_admitted").inc()
            return
        with self.tracer.span("admit", cat="serve", job=job.id,
                              flow=job.flow):
            extra = {}
            if job.tenant != DEFAULT_TENANT:
                extra["tenant"] = job.tenant
            if job.mode != "solve":
                extra["mode"] = job.mode
                if job.edit_of:
                    extra["edit_of"] = job.edit_of
                if job.edit_demoted:
                    extra["demoted"] = True
            self._ship_rec(job, jsonl.job_entry(
                self.out, job.id, "admitted", bucket=list(job.bucket),
                generations=job.generations, priority=job.priority,
                **extra))
        self._metrics.counter("serve.jobs_admitted").inc()
        if self._usage is not None and job.count_usage:
            self._usage.job(job.id, job.tenant)

    def _ship_rec(self, job: Job, rec: dict) -> None:
        """Mirror one just-written record into the job's ship prefix, a
        ring of SHIP_RECORDS_CAP: past it the oldest drop and the unit is
        marked truncated."""
        if len(job.ship_records) == job.ship_records.maxlen:
            job.ship_truncated = True
        job.ship_records.append(rec)

    def _ship_unit(self, job: Job,
                   wire: Optional[dict] = None) -> snapshot_mod.ShipUnit:
        """The job's unit at this host fence: its snapshot and the record
        prefix through the fence (`wire`: the unit's packed form, where
        it was admitted from one)."""
        return snapshot_mod.ShipUnit(
            state=job.snapshot, bucket=job.bucket,
            pop_size=self.cfg.pop_size, seed=job.seed,
            gens_done=job.gens_done, chunks=job.chunks,
            emitted=job.emitted, best=job.best,
            records=list(job.ship_records), truncated=job.ship_truncated,
            usage=dict(job.usage), wire=wire)

    def _admit_resumed(self, job: Job) -> bool:
        """Warm-start admission from job.resume_wire (JAX scheduler.py:
        335). True: the job is PARKED with the wire's progress, ships
        that state at once, and one faultEntry (site fleet, action
        resume) marks the seam. False: the wire was refused (faultEntry
        resume / replay, serve.jobs_resume_rejected) and the job starts
        fresh; so does any failure at the fault site `resume`, an
        injected thread death included. The wire's usage cursor (of
        either package) seeds the job's meter, which then continues; the
        seam is a `recover` span."""
        pop = self.cfg.pop_size
        t0 = self._now()
        wire, job.resume_wire = job.resume_wire, None
        try:
            faults.maybe_fail("resume")
            expect = snapshot_mod.wire_fingerprint(job.bucket, pop,
                                                   job.seed)
            state, meta = snapshot_mod.unpack_state(
                wire, expect_fingerprint=expect)
            if tuple(state.slots.shape) != (pop, job.padded.n_events):
                raise snapshot_mod.SnapshotMismatch(
                    f"snapshot population shape "
                    f"{tuple(state.slots.shape)} != "
                    f"({pop}, {job.padded.n_events}) for bucket "
                    f"{job.bucket}")
        except KeyboardInterrupt:
            raise
        except BaseException as e:
            jsonl.fault_entry(self.out, "resume", "replay", e, 0, 0, 0,
                              self._now() - job.submitted_t, job=job.id)
            self._metrics.counter("serve.jobs_resume_rejected").inc()
            return False
        job.snapshot = state
        job.gens_done = meta["gens_done"]
        job.chunks = meta["chunks"]
        job.emitted = meta["emitted"]
        job.best = meta["best"]
        job.resumed_at = meta["gens_done"]
        job.state = JobState.PARKED
        cursor = wire.get("usage")
        if isinstance(cursor, dict):
            job.usage = usage_mod.add(None, cursor)
        # the resumed job ships from admission (an empty continuation
        # prefix), so its group may stay resident from its first quantum
        job.ship = self._ship_unit(job, wire=dict(wire))
        jsonl.fault_entry(
            self.out, "fleet", "resume",
            f"resumed from shipped snapshot at gen {meta['gens_done']}",
            0, 0, 0, self._now() - job.submitted_t, job=job.id,
            gens=meta["gens_done"],
            chunks=meta["chunks"])
        self.tracer.record("recover", t0, self._now() - t0, cat="serve",
                           job=job.id, flow=job.flow,
                           gens=meta["gens_done"])
        self._metrics.counter("serve.jobs_resumed").inc()
        return True

    # -- backpressure ---------------------------------------------------

    def _shed(self) -> None:
        """Load shedding at the control fence (JAX scheduler.py:407):
        while `serve.queue_depth` or `writer.queue_depth` in this
        scheduler's registry is at or over its mark (0 disables), the
        lowest-priority runnable job (ready()'s last) is released with a
        jobEntry `shed`. A writer shed is one a fence: shedding queued
        jobs does not drain the writer's queue."""
        q_hwm = self.cfg.shed_queue_hwm
        w_hwm = self.cfg.shed_writer_hwm
        if q_hwm <= 0 and w_hwm <= 0:
            return

        def depth(name):
            v = self._metrics.gauge(name).value
            return 0.0 if v != v else v        # nan (unbound): no load

        while True:
            over = None
            if q_hwm > 0 and depth("serve.queue_depth") >= q_hwm:
                over = "queue_hwm"
            elif w_hwm > 0 and depth("writer.queue_depth") >= w_hwm:
                over = "writer_hwm"
            if over is None:
                return
            victims = self.queue.ready()
            if not victims:
                return
            job = victims[-1]
            job.state = JobState.SHED
            job.finished_t = self._now()
            job.error = f"shed ({over})"
            job.snapshot = None
            job.ship = None
            job.ship_records.clear()
            with self.tracer.span("shed", cat="serve", job=job.id,
                                  flow=job.flow, reason=over):
                jsonl.job_entry(self.out, job.id, "shed", reason=over,
                                priority=job.priority, gens=job.gens_done)
            self._metrics.counter("serve.jobs_shed").inc()
            if over == "writer_hwm":
                return

    # -- one dispatch cycle ---------------------------------------------

    def _reap(self) -> None:
        """Deadline pass at the control fence: a job past its deadline
        finalizes with its best so far (failed, if it never got a
        slice)."""
        now = self._now()
        for job in self.queue.active():
            if (job.deadline_s is not None
                    and now - job.submitted_t > job.deadline_s):
                if job.snapshot is not None:
                    # a resident job's snapshot is its last host fence's:
                    # park its group first
                    self._flush_job(job, "deadline")
                    self._finalize(job, deadline_hit=True)
                else:
                    job.state = JobState.FAILED
                    job.finished_t = now
                    job.error = "deadline before first slice"
                    jsonl.job_entry(self.out, job.id, "failed",
                                    reason="deadline", gens=0)
                    self._metrics.counter("serve.jobs_failed").inc()

    def _buckets_ready(self) -> list:
        seen: list = []
        for job in self.queue.ready():
            if job.bucket not in seen:
                seen.append(job.bucket)
        return seen

    def step(self) -> bool:
        """One dispatch for the next bucket group (round-robin), after
        the control fence's ship request, shedding and deadline pass.
        Returns True while any runnable job remains."""
        if self._flush_req:
            # a handler asked for fresh ship units: park every resident
            # group here, on the thread that owns the card
            self._flush_req = False
            self.flush_resident("request")
        self._shed()
        self._reap()
        buckets = self._buckets_ready()
        if not buckets:
            if self._resident:
                # nothing runnable, but a group's state is still on the
                # card (its jobs went terminal between fences)
                self.flush_resident("idle")
            return False
        bkey = buckets[self._rr % len(buckets)]
        self._rr += 1
        jobs = self.queue.ready(bkey)[:self.cfg.lanes]
        # every span of the cycle carries the packed jobs' ids and flows
        jids = [j.id for j in jobs]
        flows = [j.flow for j in jobs]
        with self.tracer.span("pack", cat="serve", bucket=list(bkey),
                              job=jids, flow=flows):
            fresh = [j for j in jobs if j.snapshot is None]
            if fresh:
                self._init_jobs(fresh)
            for job in jobs:
                job.state = JobState.RUNNING
            gens = [min(self.cfg.quantum, job.remaining()) for job in jobs]
        self._dispatches += 1
        self._metrics.counter("serve.dispatches").inc()
        try:
            self._cycle(jobs, gens, jids, flows)
            self._metrics.counter("serve.gens").inc(sum(gens))
        except Exception as e:
            self._recover_quantum(jobs, e)
        if self._profiler is not None:
            self._profiler.on_dispatch()
        if (self.cfg.obs and self.cfg.metrics_every > 0
                and self._dispatches % self.cfg.metrics_every == 0):
            jsonl.metrics_entry(self.out, self._metrics.snapshot(),
                                ts=self.tracer.now())
        return bool(self.queue.ready())

    def _recover_quantum(self, jobs, exc) -> None:
        """A failed quantum, at job granularity (JAX scheduler.py:845):
        what the failed dispatch left on the card is dropped, a resident
        group's cursors go back to the host fence its snapshots hold,
        and each of the dispatch's jobs is requeued from its snapshot
        (a transient error within the job's --max-job-recoveries) or
        fails alone. Co-tenants of other dispatches, the writer and the
        service run on."""
        entry = self._resident.pop(jobs[0].bucket, None)
        if entry is not None:
            for job in jobs:
                if (job.state not in JobState.TERMINAL
                        and job.id in entry["fence"]):
                    job.chunks, job.gens_done = entry["fence"][job.id]
        transient = retry.is_transient(exc)
        for job in jobs:
            if job.state in JobState.TERMINAL:
                continue         # settled before the fault: stays so
            job.recoveries += 1
            t = self._now() - job.submitted_t
            if transient and job.recoveries <= self.cfg.max_job_recoveries:
                job.state = JobState.PARKED
                jsonl.fault_entry(self.out, "quantum", "requeue", exc, 0,
                                  job.recoveries, 0, t, job=job.id,
                                  gens=job.gens_done)
                self._metrics.counter("serve.job_recoveries").inc()
                continue
            jsonl.fault_entry(self.out, "quantum", "abort", exc, 0,
                              job.recoveries, 0, t, job=job.id,
                              gens=job.gens_done)
            jsonl.job_entry(self.out, job.id, "failed",
                            reason="quantum fault: " + str(exc)[:120],
                            gens=job.gens_done)
            job.state = JobState.FAILED
            job.error = f"quantum fault: {str(exc)[:200]}"
            job.finished_t = self._now()
            job.snapshot = None
            job.ship = None
            job.ship_records.clear()
            self._metrics.counter("serve.jobs_failed").inc()

    def _lane_problems(self, bkey, jobs) -> LaneProblems:
        """The pack's LaneProblems: its jobs' problems, then the first
        job's as filler up to the dispatch width (filler lanes never
        run); built again only when the pack changes."""
        jids = tuple(j.id for j in jobs)
        cached = self._packs.get(bkey)
        if cached is None or cached[0] != jids:
            pas = [j.pa_dev for j in jobs]
            cached = (jids, LaneProblems(
                pas + [pas[0]] * (self.lanes - len(pas))))
            self._packs[bkey] = cached
        return cached[1]

    def _cycle(self, jobs, gens, jids, flows) -> None:
        """Resume (or keep resident), one quantum, park (or stay)."""
        pop = self.cfg.pop_size
        bkey = jobs[0].bucket
        jid_t = tuple(jids)
        # the fence the meter's waits are measured to: queue_seconds
        # (admission to first dispatch) and park_seconds (last fence to
        # this dispatch), applied only at a successful park
        t_fence0 = self._now()
        entry = self._resident.get(bkey)
        if entry is not None and (entry["jids"] != jid_t
                                  or not self.cfg.resident
                                  or self._flush_req):
            # the lanes changed (or a ship request is pending): park the
            # old group first, so this pack resumes every member from a
            # fresh snapshot
            self._flush_bucket(bkey, "repack")
            entry = None
        resident = entry is not None
        with self.tracer.span("resume", cat="serve", job=jids, flow=flows,
                              resident=resident):
            if resident:
                state = entry["state"]
                self._metrics.counter("serve.resident_hits").inc()
            else:
                host0 = _stack_states([j.snapshot for j in jobs], pop,
                                      self.lanes, jobs[0].padded.n_events)
                state = dcore.place_state(host0, self.device)
                self._metrics.counter("serve.resume_bytes").inc(
                    dcore.state_nbytes(host0))
                # the host fence this state matches: a failed quantum of
                # the group rolls the cursors back here
                entry = {"jids": jid_t, "state": None,
                         "fence": {j.id: (j.chunks, j.gens_done)
                                   for j in jobs}}
        with self.tracer.span("quantum", cat="device", job=jids,
                              flow=flows, gens=int(sum(gens))):
            faults.maybe_fail("quantum")
            lp = self._lane_problems(bkey, jobs)
            idle = self.lanes - len(jobs)
            rngs = [islands.lane_generator(self.device, j.seed, j.chunks)
                    for j in jobs] + [None] * idle
            b0 = kernels.BUILD_INFO["total_seconds"]
            runner = dcore.program("lane_runner", islands.lane_run)
            tq0 = self._now()
            state, trace = runner(
                lp, rngs, state, gens + [0] * idle, self.gacfg,
                self.cfg.quantum, trace_mode=self.cfg.trace_mode,
                quality=self.cfg.quality)
            trace = dcore.fetch_leaf(trace)
            tq_wall = self._now() - tq0
            cost = getattr(runner, "last_cost", None)
            # the live roofline, the engine's gauges and formula: the
            # quantum's counted work over its wall, skipped on a call
            # that counted as a compile (JAX scheduler.py:652-662)
            if not getattr(runner, "last_compiled", False):
                obs_cost.set_live_roofline(cost, tq_wall)
            # a kernel build inside the quantum (the first launch of a
            # library not loaded yet): the meter's compile_seconds
            build_s = kernels.BUILD_INFO["total_seconds"] - b0
            self._metrics.counter("serve.quantum_seconds").inc(tq_wall)
        # stay on the card only when no ship request is pending, every
        # member has a ship unit (a fresh job parks once first) and none
        # is ship_hot (polled: it parks every fence), and none finishes
        # in this quantum
        stay = (self.cfg.resident and not self._flush_req
                and all(j.ship is not None and not j.ship_hot
                        for j in jobs)
                and not any(g >= j.remaining() for g, j in zip(gens, jobs)))
        with self.tracer.span("park", cat="serve", job=jids, flow=flows,
                              resident=stay):
            self._park(jobs, gens, entry, state, trace, stay, tq_wall,
                       build_s, t_fence0, (cost or {}).get("flops", 0.0))

    def _park(self, jobs, gens, entry, state, trace, stay, tq_wall,
              build_s, t_fence0, flops=0.0) -> None:
        """The park fence of a quantum: the group stays on the card or
        its state comes to the host; the telemetry is decoded, the
        quantum metered, each job's cursors, records and ship unit
        advanced, and a finishing job finalized."""
        pop = self.cfg.pop_size
        bkey = jobs[0].bucket
        if stay:
            entry["state"] = state
            self._resident[bkey] = entry
            host = None
        else:
            host = dcore.fetch_state(state)
            self._resident.pop(bkey, None)
            self._metrics.counter("serve.park_bytes").inc(
                dcore.state_nbytes(host))
        events, _, qrows, self._overflow_warned = dcore.decode_telemetry(
            trace, self.cfg.quality, self.cfg.trace_mode,
            metrics=self._metrics,
            overflow_counter="serve.trace_delta_overflow",
            overflow_warned=self._overflow_warned, warn_label="serve ")
        q_dec = None
        if qrows is not None:
            # the real lanes only: a filler lane's rows mean nothing
            q_dec = obs_quality.decode_rows(qrows[:len(jobs)])
            agg = obs_quality.aggregate(q_dec)
            for name, v in agg["counters"].items():
                self._metrics.counter(name).inc(v)
            for name, v in agg["gauges"].items():
                self._metrics.gauge(name).set(v)
        now = self._now()
        deltas, meter_payload = self._meter_quantum(
            jobs, gens, tq_wall, build_s, t_fence0, flops)
        for lane, job in enumerate(jobs):
            if host is not None:
                job.snapshot = _slice_state(host, lane, pop)
            job.chunks += 1
            job.gens_done += gens[lane]
            if deltas is not None:
                # a new dict: a reader sees one fence's meter or the next
                job.usage = usage_mod.add(job.usage, deltas[lane])
                if job.first_work_t is None:
                    job.first_work_t = t_fence0
                job.last_fence_t = now
            for _g, h, s in events[lane]:
                rep = jsonl.reported_best(h, s)
                job.best = min(job.best, rep)
                if rep < job.emitted:
                    job.emitted = rep
                    self._ship_rec(job, jsonl.log_entry(
                        self.out, 0, 0, rep, now - job.submitted_t,
                        job=job.id))
            if q_dec is not None and self.cfg.obs:
                jsonl.quality_entry(
                    self.out, obs_quality.lane_payload(q_dec, lane),
                    ts=self.tracer.now(), job=job.id, gens=int(gens[lane]))
            job.state = JobState.PARKED
            if job.remaining() == 0:
                self._finalize(job)
            elif host is not None:
                # the park fence is the ship fence
                job.ship = self._ship_unit(job)
        if meter_payload is not None:
            # the tenant settlement rides the ledger's own thread
            self._usage.dispatch(meter_payload)

    def _meter_quantum(self, jobs, gens, tq_wall, build_s, t_fence0,
                       flops=0.0):
        """One quantum's usage attribution (JAX scheduler.py:775): its
        wall minus the kernel build inside it, the build's wall, the
        counted `flops` and the generations, split over the lanes by the
        generations each ran (usage_mod.split: the shares sum exactly to
        the quantized totals; flops on the integer grid), plus each
        job's queue and park waits. Returns (per-lane deltas, the
        ledger's payload), or (None, None) with metering off. The
        idle-lane overhead is 0: only occupied lanes run."""
        if self._usage is None:
            return None, None
        gens_l = [int(g) for g in gens]
        compile_s = max(0.0, float(build_s))
        exec_s = max(0.0, float(tq_wall) - compile_s)
        exec_s, dev_shares = usage_mod.split(exec_s, gens_l)
        compile_s, comp_shares = usage_mod.split(compile_s, gens_l)
        flops, flop_shares = usage_mod.split(float(flops), gens_l,
                                             quantum=1.0)
        deltas = []
        lanes_out = []
        for lane, job in enumerate(jobs):
            queued = (max(0.0, t_fence0 - job.submitted_t)
                      if job.first_work_t is None else 0.0)
            parked = (max(0.0, t_fence0 - job.last_fence_t)
                      if job.last_fence_t is not None else 0.0)
            delta = {"gens": gens_l[lane], "dispatches": 1,
                     "device_seconds": dev_shares[lane],
                     "compile_seconds": comp_shares[lane],
                     "flops": flop_shares[lane],
                     "queue_seconds": queued,
                     "park_seconds": parked}
            deltas.append(delta)
            # unrounded shares: the record's lanes sum exactly to its
            # totals
            lanes_out.append({"job": job.id, "tenant": job.tenant,
                              **delta})
        payload = {"dispatch": self._dispatches,
                   "bucket": list(jobs[0].bucket),
                   "gens": sum(gens_l),
                   "device_seconds": exec_s,
                   "overhead_device_seconds": 0.0,
                   "compile_seconds": compile_s,
                   "flops": flops,
                   "lanes": lanes_out}
        return deltas, payload

    # -- residency flushes ----------------------------------------------

    def _flush_bucket(self, bkey, reason: str) -> None:
        """Park one resident group to the host (a `flush` span with its
        `reason`): its live members' snapshots and ship units are
        refreshed and the card's copy dropped."""
        entry = self._resident.pop(bkey, None)
        if entry is None:
            return
        live = [(lane, self.queue.get(jid))
                for lane, jid in enumerate(entry["jids"])
                if jid in self.queue]
        live = [(lane, job) for lane, job in live
                if job.state not in JobState.TERMINAL]
        if not live:
            return
        try:
            with self.tracer.span("flush", cat="serve", bucket=list(bkey),
                                  reason=reason,
                                  job=[job.id for _, job in live]):
                host = dcore.fetch_state(entry["state"])
        except BaseException:
            # the snapshots stay the last host fence's: their cursors
            # with them
            for _, job in live:
                if job.id in entry["fence"]:
                    job.chunks, job.gens_done = entry["fence"][job.id]
            raise
        self._metrics.counter("serve.park_bytes").inc(
            dcore.state_nbytes(host))
        for lane, job in live:
            job.snapshot = _slice_state(host, lane, self.cfg.pop_size)
            job.ship = self._ship_unit(job)
        self._metrics.counter("serve.resident_flushes").inc()

    def _flush_job(self, job: Job, reason: str) -> None:
        """Park the resident group holding `job`, if any. A failed park
        is absorbed (faultEntry flush/rollback): the job goes on from
        its last host fence."""
        entry = self._resident.get(job.bucket)
        if entry is None or job.id not in entry["jids"]:
            return
        try:
            self._flush_bucket(job.bucket, reason)
        except Exception as e:
            jsonl.fault_entry(self.out, "flush", "rollback", e, 0, 0, 0,
                              self._now() - job.submitted_t, job=job.id)

    def flush_resident(self, reason: str = "ship") -> int:
        """Park every resident group now: at an idle fence, or to ship
        (every job's unit then holds its current progress; JAX's
        flush_resident("ship")). A group whose park fails is rolled back
        to its last host fence and skipped. Returns the number of groups
        parked."""
        n = 0
        for bkey in list(self._resident):
            try:
                self._flush_bucket(bkey, reason)
                n += 1
            except Exception as e:
                jsonl.fault_entry(self.out, "flush", "rollback", e, 0, 0,
                                  0, 0.0)
        return n

    def request_flush(self) -> None:
        """Ask the drive loop to park every resident group at its next
        control fence (JAX scheduler.py:1006). It sets a flag and nothing
        else, so any thread may call it: a handler serving ?snapshot=1
        must not touch the card. Until that fence a shipped unit is the
        last host fence's."""
        self._flush_req = True

    def drop_packs(self, job_ids) -> None:
        """Forget every cached pack holding one of `job_ids`: its
        LaneProblems references those jobs' problem tensors on the card
        (the fleet replica releases a settled job's tensors)."""
        gone = set(job_ids)
        for bkey, (jids, _) in list(self._packs.items()):
            if gone.intersection(jids):
                del self._packs[bkey]

    def _resident_bytes(self) -> int:
        return sum(dcore.state_nbytes(g.get("state"))
                   for g in list(self._resident.values()))

    def drive(self) -> None:
        """Run dispatches until no runnable job remains."""
        while self.step():
            pass

    # -- job endpoints --------------------------------------------------

    def _init_jobs(self, jobs) -> None:
        """First slices. JAX initialises a pack's fresh jobs in one lane
        program; here each initialises on its own problem, from its own
        init generator, through the single-problem K1 assign_rooms and K2
        batch_penalty entries (islands.lane_init): one launch pair a job,
        once in its life, and no lane form of K1 or K2 is needed."""
        with self.tracer.span("init", cat="device",
                              job=[j.id for j in jobs],
                              flow=[j.flow for j in jobs]):
            for job in jobs:
                job.snapshot = dcore.fetch_state(dcore.program(
                    "lane_init", islands.lane_init)(
                        job.pa_dev, job.seed, self.cfg.pop_size))
        for job in jobs:
            self._ship_rec(job, jsonl.job_entry(
                self.out, job.id, "started", bucket=list(job.bucket)))

    def _finalize(self, job: Job, deadline_hit: bool = False) -> None:
        """The job's endTry records from its snapshot (row 0 is the
        lane's lex-best individual), the padded events dropped; DONE. A
        `finalize` span on the job's flow closes its chain."""
        with self.tracer.span("finalize", cat="serve", job=job.id,
                              flow=job.flow):
            self._finalize_records(job, deadline_hit)

    def _finalize_records(self, job: Job, deadline_hit: bool) -> None:
        snap = job.snapshot
        hcv, scv = int(snap.hcv[0]), int(snap.scv[0])
        job.best = min(job.best, jsonl.reported_best(hcv, scv))
        feasible = hcv == 0
        total_time = self._now() - job.submitted_t
        slots, rooms = bucket_mod.extract_solution(
            snap.slots[0], snap.rooms[0], job.padded)
        jsonl.solution_record(
            self.out, 0, 0, total_time, job.best, feasible,
            timeslots=slots.tolist() if feasible else None,
            rooms=rooms.tolist() if feasible else None, job=job.id)
        jsonl.run_entry(self.out, job.best, feasible, job=job.id)
        jsonl.run_entry(self.out, job.best, feasible, procs_num=1,
                        threads_num=1, total_time=total_time, job=job.id)
        done_extra = {}
        edit_dist = None
        if job.mode == "edit":
            # the distance to the base's published timetable, from the
            # event map (a w_anchor 0 edit still reports it)
            from timetabling_ga_tpu_torch.serve import editsolve
            edit_dist = editsolve.edit_distance(
                snap.slots[0], job.padded.anchor_slots, job.edit_map)
            done_extra["mode"] = job.mode
            if edit_dist is not None:
                done_extra["edit_distance"] = edit_dist
            if job.edit_demoted:
                done_extra["demoted"] = True
        jsonl.job_entry(self.out, job.id, "done", gens=job.gens_done,
                        best=job.best, feasible=feasible,
                        deadline_hit=deadline_hit, **done_extra)
        job.state = JobState.DONE
        job.finished_t = self._now()
        self._metrics.counter("serve.jobs_done").inc()
        self._metrics.histogram("serve.job_seconds").observe(
            total_time, exemplar={"job": job.id})
        job.result = {"best": job.best, "feasible": feasible,
                      "hcv": hcv, "scv": scv, "gens": job.gens_done,
                      "deadline_hit": deadline_hit,
                      "resumed_at": job.resumed_at,
                      "timeslots": slots.tolist(),
                      "rooms": rooms.tolist()}
        if job.mode != "solve":
            job.result["mode"] = job.mode
            job.result["edit_distance"] = edit_dist
            job.result["edit_demoted"] = job.edit_demoted
            if job.edit_of:
                job.result["edit_of"] = job.edit_of
        if self._usage is not None:
            # the settled meter rides the result, and the ledger writes
            # it as the job's `event: "total"` usageEntry (cumulative
            # across incarnations for a warm-started job)
            job.result["tenant"] = job.tenant
            job.result["usage"] = usage_mod.rounded(job.usage)
            self._usage.final(job.id, job.tenant, job.usage,
                              mode=job.mode)
        job.snapshot = None        # the last non-final park's ship
        #                            unit stays: a done job's wire is
        #                            what an edit of it transplants from
        job.ship_records.clear()
