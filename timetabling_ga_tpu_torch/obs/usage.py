"""Per-job and per-tenant usage metering (copy of timetabling_ga_tpu/
obs/usage.py, under the same names).

The serve scheduler meters each packed dispatch at its park fence and
attributes the dispatch's totals to the jobs that rode it, and through
each job's `tenant` tag to the tenant that submitted it:

  device_seconds   the quantum's measured wall, fence to fence on the
                   host clock (minus any kernel build the same quantum
                   paid: that goes to compile_seconds)
  flops            the lane program's counted work: the operations of
                   the quantum's kernel launches (obs/cost.py
                   CostProgram.last_cost, work.py; JAX reads XLA's
                   compile-time count), split on the integer grid
  compile_seconds  the wall that `kernels.build()` spent inside the
                   quantum (JAX's lower+compile wall of a cold
                   dispatch); 0 once the kernels are built
  queue_seconds    admission to first dispatch (per job, once)
  park_seconds     time parked as a host snapshot between quanta
  gens/dispatches  generations run / dispatches ridden

`split(total, weights)` apportions a dispatch total over its lanes by
the generations each ran, on a dyadic grid, so the shares sum to the
recorded total exactly, in float and through JSON.

The ledger runs off the dispatch path: the scheduler appends one event a
dispatch to a bounded deque and moves on; the `tt-usage` daemon thread
drains it, folds per-tenant totals, bumps the
`usage.tenant.<t>.{gens,device_seconds,...}` counters and, when an
emitter is bound (`--obs`), writes `usageEntry` records. The fault site
`usage` fires once a drained batch on that thread: `hang` parks the
ledger (events beyond EVENTS_CAP count into `usage.dropped`), `die` ends
it; dispatch, settlement and the writer's drain never wait on it.

The per-job meter lives on the Job (serve/queue.py `Job.usage`), folded
inline at each park fence, and rides the snapshot wire as its `usage`
cursor, so a resumed job continues its meter. The record stream is the
same with metering on or off: usageEntry is a timing record.

`main_usage` is the `usage` subcommand: a report from logs, or from a
live front's `/v1/usage` over a standard-library URL read. Stdlib only.
"""

from __future__ import annotations

import collections
import json
import os
import re
import sys
import threading

from timetabling_ga_tpu_torch.obs import metrics as obs_metrics

# the per-lane delta components a meter accumulates (wire + ledger +
# usageEntry all share this closed set, so the consumers cannot drift)
FIELDS = ("gens", "dispatches", "device_seconds", "compile_seconds",
          "flops", "queue_seconds", "park_seconds")

# integral components (rendered and serialized as ints)
_INT_FIELDS = ("gens", "dispatches")

# bound on the ledger's inbox: the drive loop appends and never waits,
# so a hung ledger thread must shed oldest events, not grow memory
# without bound (the dropped count is surfaced, never silent)
EVENTS_CAP = 4096

# bound on DISTINCT tenant labels per ledger: the tag is
# client-controlled (it rides unauthenticated POST /v1/solve
# payloads), and every distinct label allocates a ledger entry, ~8
# registry counters, and — because the history rings sample every
# registry series — ~8 bounded-but-real sample rings per process.
# Beyond the cap, NEW labels fold into the shared OVERFLOW_TENANT
# bucket (their work is still metered and conserved, just not singled
# out) and `usage.tenant_overflow` counts the folds — the same
# honest-truncation discipline as EVENTS_CAP/JobTail/ship rings.
TENANTS_CAP = int(os.environ.get("TT_USAGE_TENANTS_CAP", "256"))

DEFAULT_TENANT = "default"
OVERFLOW_TENANT = "other"

# no dots: the label is spliced into dotted metric names
# (`usage.tenant.<t>.gens`), and a dotted tenant would fork the
# namespace ambiguously
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_-]")


def _faults():
    """Lazy import (the MemPoller pattern, obs/cost.py): this module
    stays importable without the runtime package; the ledger thread
    only exists inside serve processes, where it is long imported."""
    from timetabling_ga_tpu_torch.runtime import faults
    return faults


def tenant_label(tenant) -> str:
    """Canonical tenant tag: a bounded, metric-name-safe string.
    Empty/None collapses to the shared DEFAULT_TENANT — an untagged
    submission is still metered, just not singled out."""
    t = str(tenant or "").strip()
    if not t:
        return DEFAULT_TENANT
    return _LABEL_RE.sub("_", t)[:64]


# ------------------------------------------------------- meter arithmetic


def new_usage() -> dict:
    return {f: 0 for f in _INT_FIELDS} | {
        f: 0.0 for f in FIELDS if f not in _INT_FIELDS}


def fold_into(dst: dict, src: dict) -> dict:
    """Accumulate `src`'s FIELDS into `dst` IN PLACE (ints stay ints)
    — THE one fold loop every accumulator shares (the live ledger,
    the fleet combine, the log-side fold), so 'log fold == live
    ledger' cannot drift on accumulation semantics."""
    for f in FIELDS:
        v = src.get(f)
        if v:
            dst[f] = (int(dst[f] + v) if f in _INT_FIELDS
                      else dst[f] + float(v))
    return dst


def add(usage: dict | None, delta: dict) -> dict:
    """Fold `delta` into `usage`, returning a NEW dict (the drive loop
    replaces `Job.usage` wholesale, so a handler thread reading it for
    `GET /v1/usage` sees one fence's meter or the next, never a torn
    mix)."""
    out = new_usage()
    for src in (usage or {}), delta:
        fold_into(out, src)
    return out


def rounded(usage: dict | None, ndigits: int = 6) -> dict:
    """JSON-presentation form: floats rounded, ints kept ints — the
    shape a result dict, wire cursor, or usageEntry carries."""
    out = {}
    for f in FIELDS:
        v = (usage or {}).get(f, 0)
        out[f] = int(v) if f in _INT_FIELDS else round(float(v), ndigits)
    return out


# the dyadic metering grid: shares and totals are integer multiples of
# this power-of-two quantum (~0.93 ns for the seconds components), so
# every partial sum a consumer computes is an exact float — see split()
QUANTUM = 2.0 ** -30


def split(total: float, weights, quantum: float = QUANTUM) -> tuple:
    """Proportional shares of `total` over `weights` whose float sum
    is EXACTLY the returned quantized total — THE conservation
    primitive (module docstring). Returns `(qtotal, shares)`.

    Exactness by construction, not by luck: assigning the last lane
    the float remainder `t - sum(rest)` provably CANNOT always close
    the sum (round-to-even can skip the target, so no representable
    remainder exists). Instead the total is quantized onto a dyadic
    grid (`round(total / quantum)` with a power-of-two quantum —
    ~0.93 ns for the seconds components, 1.0 for counts like FLOPs)
    and the integer quanta are apportioned largest-remainder-first.
    Every share and every left-to-right partial sum is then an
    integer multiple of the quantum below 2**53, i.e. an EXACT float,
    so `sum(shares) == qtotal` holds bit-exactly — through JSON round
    trips too (dyadics reprint exactly). The quantization error
    (≤ quantum/2, sub-nanosecond) lands on the TOTAL once, never on
    the split. All-zero weights split evenly (a dispatch of
    zero-gen lanes still had a measured wall); a total too large for
    the grid escalates to coarser power-of-two quanta until the
    integer fits."""
    ws = [max(0, int(w)) for w in weights]
    n = len(ws)
    if n == 0:
        return 0.0, []
    wsum = sum(ws)
    if wsum <= 0:
        ws = [1] * n
        wsum = n
    q = float(quantum)
    units = int(round(float(total) / q))
    while units >= 2 ** 53:
        q *= 2.0
        units = int(round(float(total) / q))
    base = [units * w // wsum for w in ws]
    # largest fractional remainder first; index as the deterministic
    # tie-break (stable attribution — the same dispatch always splits
    # the same way)
    order = sorted(range(n), key=lambda i: (-(units * ws[i] % wsum),
                                            i))
    short = units - sum(base)
    for i in order[:short]:
        base[i] += 1
    return units * q, [b * q for b in base]


# ------------------------------------------------------------- the ledger


class UsageLedger:
    """Per-tenant usage aggregation OFF the dispatch path.

    The drive loop calls `job()` / `dispatch()` / `final()` — each an
    O(1) bounded-deque append — and the `tt-usage` daemon thread folds
    the events into per-tenant totals, the live `usage.tenant.<t>.*`
    registry counters, and (when an emitter is bound) `usageEntry`
    JSONL records. `totals()` is the lock-guarded read `GET /v1/usage`
    serves (TT607: handlers READ the ledger, they never mutate it).

    Fault site `usage` fires once per drained batch on the ledger
    thread: `hang` parks it (events shed beyond EVENTS_CAP into
    `usage.dropped`), `die` ends it silently — dispatch, settlement,
    and writer drain never wait on the ledger (tests/test_usage.py).
    """

    def __init__(self, registry=None, out=None, now=None,
                 tenants_cap: int | None = None):
        self._reg = (obs_metrics.REGISTRY if registry is None
                     else registry)
        self._cap = int(TENANTS_CAP if tenants_cap is None
                        else tenants_cap)
        self._out = out          # usageEntry sink (an AsyncWriter —
        #                          a producer-side write; None = none)
        self._now = now
        self._lock = threading.Lock()
        self._tenants: dict[str, dict] = {}
        self._events: collections.deque = collections.deque(
            maxlen=EVENTS_CAP)
        self._wake = threading.Event()
        self._stop = False
        self._out_dead = False   # latched on a failed emission: the
        #                          gw_writer discipline — a dying
        #                          writer mutes records, never the
        #                          meter or the drive loop
        self._thread = threading.Thread(
            target=self._loop, name="tt-usage", daemon=True)
        self._thread.start()

    # -- producer side (drive loop; never blocks) -----------------------

    def _push(self, ev: tuple) -> None:
        if self._stop or not self._thread.is_alive():
            return
        if len(self._events) == self._events.maxlen:
            # deque drops the oldest on append — count it honestly
            self._reg.counter("usage.dropped").inc()
        self._events.append(ev)
        self._wake.set()

    def job(self, job_id: str, tenant: str) -> None:
        """One NEW job admitted for `tenant` (resumed re-admissions do
        NOT call this — the job was counted by its first replica, and
        fleet aggregation sums tenant ledgers)."""
        self._push(("job", str(job_id), tenant_label(tenant)))

    def dispatch(self, payload: dict) -> None:
        """One settled dispatch: `payload` carries the dispatch totals
        plus a `lanes` list of per-job shares (each with job/tenant +
        FIELDS deltas) whose components sum to the totals — the
        conservation invariant the scheduler's `split` guarantees."""
        self._push(("dispatch", payload))

    def final(self, job_id: str, tenant: str, usage: dict,
              mode: str = None) -> None:
        """A job settled: emit its cumulative meter as one usageEntry
        (event "total") — the authoritative per-job line `tt usage`
        prefers when summarizing a log. `mode` (tt-edit) tags
        non-default job modes ("edit") on the record so `tt usage`
        and `tt stats` can split edit traffic out; None/"solve" emits
        the pre-edit record byte-identically."""
        self._push(("final", str(job_id), tenant_label(tenant),
                    dict(usage or {}),
                    mode if mode and mode != "solve" else None))

    # -- the ledger thread ----------------------------------------------

    def _loop(self) -> None:
        while True:
            self._wake.wait()
            self._wake.clear()
            if not self.poll_once():
                return
            if self._stop and not self._events:
                return

    def poll_once(self) -> bool:
        """Drain the current batch; False when the thread should exit
        (injected death / teardown). The testable unit, like
        MemPoller.poll_once / HistoryRing.sample_once."""
        if sys.is_finalizing():
            return False
        batch = []
        while self._events:
            try:
                batch.append(self._events.popleft())
            except IndexError:
                break
        if not batch:
            return True
        try:
            _faults().maybe_fail("usage")
        except SystemExit:
            return False            # injected death: exit silently
        except Exception:
            pass
        for ev in batch:
            try:
                self._apply(ev)
            except Exception:
                # metering must never take down its own thread: one
                # torn event is one lost line, counted
                self._reg.counter("usage.errors").inc()
        return True

    def _resolve(self, label: str) -> str:
        """Tenant-cardinality bound (caller holds the lock): a label
        the ledger already tracks keeps its row; a NEW label past
        TENANTS_CAP folds into the shared overflow bucket — metered
        and conserved, just not singled out."""
        if label in self._tenants or len(self._tenants) < self._cap \
                or label == OVERFLOW_TENANT:
            return label
        self._reg.counter("usage.tenant_overflow").inc()
        return OVERFLOW_TENANT

    def _tenant(self, label: str) -> dict:
        t = self._tenants.get(label)
        if t is None:
            t = self._tenants[label] = new_usage() | {"jobs": 0}
        return t

    def _bump(self, label: str, delta: dict) -> None:
        with self._lock:
            label = self._resolve(label)
            fold_into(self._tenant(label), delta)
        base = f"usage.tenant.{label}"
        for f in FIELDS:
            v = delta.get(f)
            if v:
                self._reg.counter(f"{base}.{f}").inc(float(v))

    def _apply(self, ev: tuple) -> None:
        kind = ev[0]
        if kind == "job":
            _, job_id, label = ev
            with self._lock:
                label = self._resolve(label)
                self._tenant(label)["jobs"] += 1
            self._reg.counter(f"usage.tenant.{label}.jobs").inc()
        elif kind == "dispatch":
            payload = ev[1]
            for lane in payload.get("lanes", ()):
                self._bump(tenant_label(lane.get("tenant")), lane)
            self._reg.counter("usage.dispatches").inc()
            self._emit(dict(payload))
        elif kind == "final":
            _, job_id, label, usage = ev[:4]
            mode = ev[4] if len(ev) > 4 else None
            payload = {"event": "total", "job": job_id,
                       "tenant": label}
            if mode:
                payload["mode"] = mode
            self._emit({**payload, **rounded(usage)})

    def _emit(self, payload: dict) -> None:
        out = self._out
        if out is None or self._out_dead:
            return
        try:
            from timetabling_ga_tpu_torch.runtime import jsonl
            ts = self._now() if self._now is not None else None
            jsonl.usage_entry(out, payload, ts=ts)
        except Exception:
            # a closed/dead writer mutes usageEntry emission; the
            # counters and totals stay live (gw_writer discipline)
            self._out_dead = True

    # -- read side (handler threads; read-only) -------------------------

    def alive(self) -> bool:
        return self._thread.is_alive()

    def totals(self) -> dict:
        """{tenant: {jobs, gens, device_seconds, ...}} — this
        replica's OWN metered contribution (the gateway sums these
        across replicas; resumed history is never re-counted here)."""
        with self._lock:
            return {label: dict(t, **rounded(t))
                    for label, t in sorted(self._tenants.items())}

    def drain(self, timeout: float = 2.0) -> bool:
        """Best-effort wait for the inbox to empty (tests; close())."""
        import time as _time
        deadline = _time.monotonic() + timeout
        while self._events and self._thread.is_alive():
            self._wake.set()
            if _time.monotonic() > deadline:
                return False
            _time.sleep(0.005)
        return not self._events

    def close(self) -> None:
        """Drain what is already queued, then stop; a hung ledger
        thread is abandoned (daemon), never waited out — the close
        path must not inherit the stall the fault site injects."""
        self._stop = True
        self.drain()
        self._wake.set()
        self._thread.join(timeout=2.0)


# ------------------------------------------------- fleet-wide aggregation


def progress(payload) -> float:
    """A monotone scalar over one `/v1/usage` payload's tenant ledgers
    (gens + dispatches + jobs — counters that only ever grow within
    one process incarnation). Two consecutive scrapes of the SAME
    replica URL where this number moves BACKWARD mean the process
    restarted behind our back and the fresh incarnation's ledger
    started over — the flight-recorder dump-counter discipline,
    applied to billing: fleet/replicas.py folds the dead incarnation's
    cached payload into `usage_base` when it sees one, so a static
    (non-spawned) replica's bill survives external restarts too."""
    total = 0.0
    for t in ((payload or {}).get("tenants") or {}).values():
        for f in ("gens", "dispatches", "jobs"):
            v = t.get(f, 0)
            if isinstance(v, (int, float)) and v == v:
                total += float(v)
    return total


def combine(payloads) -> dict:
    """Merge {tenants, jobs} usage payloads into one: tenant meters
    SUM (each payload counted only its own metered work), per-job
    meters take the highest-progress view (a failed-over job's
    survivor meter already CONTINUES the shipped cursor, so summing
    would double count its history). Used by the fleet aggregation
    AND by ReplicaHandle to carry a dead incarnation's ledger across
    a respawn (the fresh worker's near-empty payload must ADD to the
    retired one, never replace it — metered work does not vanish from
    the bill with its process)."""
    tenants: dict = {}
    jobs: dict = {}
    for payload in payloads:
        if not payload:
            continue
        for label, t in (payload.get("tenants") or {}).items():
            agg = tenants.setdefault(label, new_usage() | {"jobs": 0})
            fold_into(agg, t)
            agg["jobs"] += int(t.get("jobs", 0))
        for jid, j in (payload.get("jobs") or {}).items():
            have = jobs.get(jid)
            if have is None or int(j.get("usage", {}).get("gens", 0)) \
                    >= int(have.get("usage", {}).get("gens", 0)):
                jobs[jid] = dict(j)
    return {"tenants": tenants, "jobs": jobs}


def aggregate(payloads) -> dict:
    """Fleet totals from per-replica `GET /v1/usage` payloads:
    `payloads` is [(name, dead, payload-or-None), ...] (the gateway's
    prober cache — a dead replica contributes its LAST-scraped ledger,
    the incident-bundle stitching rule). The merge rules are
    `combine`'s; each job is stamped with the replica whose payload
    won its highest-progress view."""
    merged = combine([
        (dict(payload, jobs={jid: dict(j, replica=str(name))
                             for jid, j in
                             (payload.get("jobs") or {}).items()})
         if payload else None)
        for name, dead, payload in payloads])
    replicas = {str(name): {
        "dead": bool(dead),
        "scraped": payload is not None,
        "tenants": sorted((payload or {}).get("tenants", {})),
    } for name, dead, payload in payloads}
    return {"tenants": {k: dict(t, **rounded(t))
                        for k, t in sorted(merged["tenants"].items())},
            "jobs": dict(sorted(merged["jobs"].items())),
            "replicas": replicas}


# -------------------------------------------------- log-side summarizing


def fold_entries(records) -> dict:
    """Collapse a record stream's usageEntry lines into the
    {tenants, jobs} shape `aggregate`/`tt usage` render. Per-dispatch
    lane deltas accumulate; a job's `event: "total"` line (emitted at
    settle, cumulative ACROSS incarnations for a resumed job)
    overrides its delta sum — the authoritative per-job meter."""
    tenants: dict = {}
    jobs: dict = {}
    finals: dict = {}
    for rec in records:
        body = rec.get("usageEntry") if isinstance(rec, dict) else None
        if not isinstance(body, dict):
            continue
        if body.get("event") == "total":
            label = tenant_label(body.get("tenant"))
            finals[str(body.get("job"))] = {
                "tenant": label,
                "usage": rounded({f: body.get(f, 0) for f in FIELDS})}
            continue
        for lane in body.get("lanes", ()):
            label = tenant_label(lane.get("tenant"))
            fold_into(tenants.setdefault(
                label, new_usage() | {"jobs": 0}), lane)
            jid = str(lane.get("job"))
            j = jobs.setdefault(jid, {"tenant": label,
                                      "usage": new_usage()})
            j["usage"] = add(j["usage"], lane)
    seen_jobs: dict = {}
    for jid, j in {**jobs, **finals}.items():
        seen_jobs[jid] = {"tenant": j["tenant"],
                          "usage": rounded(j["usage"])}
        label = j["tenant"]
        t = tenants.setdefault(label, new_usage() | {"jobs": 0})
        t["jobs"] += 1
        if jid not in jobs:
            # a job visible ONLY through its settle total (its deltas
            # were truncated away, or live in another replica's log):
            # its meter still belongs in the tenant's sum
            fold_into(t, j["usage"])
    return {"tenants": {k: dict(t, **rounded(t))
                        for k, t in sorted(tenants.items())},
            "jobs": dict(sorted(seen_jobs.items()))}


def _fmt_usage(u: dict) -> str:
    return (f"gens {int(u.get('gens', 0))} "
            f"dispatches {int(u.get('dispatches', 0))} "
            f"device {float(u.get('device_seconds', 0.0)):.3f}s "
            f"compile {float(u.get('compile_seconds', 0.0)):.3f}s "
            f"flops {float(u.get('flops', 0.0)):.3g} "
            f"queued {float(u.get('queue_seconds', 0.0)):.3f}s "
            f"parked {float(u.get('park_seconds', 0.0)):.3f}s")


def render(report: dict, tenant: str | None = None) -> str:
    """The human `tt usage` report (and tt stats' `== usage` body)
    from a {tenants, jobs[, replicas]} shape."""
    lines = []
    tenants = report.get("tenants") or {}
    jobs = report.get("jobs") or {}
    if tenant is not None:
        label = tenant_label(tenant)
        tenants = {k: v for k, v in tenants.items() if k == label}
        jobs = {k: v for k, v in jobs.items()
                if tenant_label(v.get("tenant")) == label}
    lines.append(f"== usage by tenant ({len(tenants)})")
    for label, t in tenants.items():
        lines.append(f"  {label}: jobs {int(t.get('jobs', 0))} "
                     + _fmt_usage(t))
    if jobs:
        lines.append(f"== usage by job ({len(jobs)})")
        for jid, j in jobs.items():
            rep = (f" @{j['replica']}" if j.get("replica") else "")
            lines.append(f"  {jid} ({j.get('tenant')}{rep}): "
                         + _fmt_usage(j.get("usage") or {}))
    reps = report.get("replicas")
    if reps:
        lines.append(f"== replicas ({len(reps)})")
        for name, r in sorted(reps.items()):
            state = "dead, last-scraped ledger" if r.get("dead") \
                else ("live" if r.get("scraped") else "unscraped")
            lines.append(f"  {name}: {state}; tenants "
                         f"{', '.join(r.get('tenants') or ()) or '-'}")
    return "\n".join(lines)


def summarize_entries(records) -> str:
    """`tt stats`' `== usage` section body (logstats.py appends it
    when a stream carries usageEntry records)."""
    return render(fold_entries(records))


# ------------------------------------------------------------ tt usage CLI


_USAGE = """\
usage: tt usage <log.jsonl [more.jsonl ...] | URL> [--tenant T] [--json]

per-tenant / per-job usage report (README "Usage metering"):
  from logs:     parse usageEntry records out of one or more record
                 streams (several inputs concatenate — a fleet's
                 gateway + replica logs read together)
  from a URL:    GET <url>/v1/usage off a live replica or gateway
                 front (the gateway aggregates fleet-wide totals,
                 including dead replicas' last-scraped ledgers)
  --tenant T     only this tenant's rows
  --json         machine-readable report on stdout
  -h, --help     this message"""


def main_usage(argv) -> int:
    """`tt usage` entry point (cli.py dispatches here). Stdlib-only
    and device-free, like tt trace / tt stats."""
    inputs: list = []
    tenant = None
    as_json = False
    i = 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(_USAGE)
            return 0
        if a == "--json":
            as_json = True
            i += 1
            continue
        if a == "--tenant":
            if i + 1 >= len(argv):
                raise SystemExit("flag --tenant needs a value")
            tenant = argv[i + 1]
            i += 2
            continue
        if a.startswith("-"):
            raise SystemExit(f"unknown argument: {a}")
        inputs.append(a)
        i += 1
    if not inputs:
        raise SystemExit(_USAGE)
    if len(inputs) == 1 and "://" in inputs[0]:
        import urllib.request
        url = inputs[0].rstrip("/") + "/v1/usage"
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                report = json.loads(resp.read().decode())
        except Exception as e:
            print(f"tt usage: {e}", file=sys.stderr)
            return 2
    else:
        from timetabling_ga_tpu_torch.obs.trace_export import read_jsonl
        records: list = []
        for path in inputs:
            records.extend(read_jsonl(path))
        report = fold_entries(records)
    if as_json:
        if tenant is not None:
            label = tenant_label(tenant)
            report = {
                "tenants": {k: v for k, v in
                            (report.get("tenants") or {}).items()
                            if k == label},
                "jobs": {k: v for k, v in
                         (report.get("jobs") or {}).items()
                         if tenant_label(v.get("tenant")) == label}}
        print(json.dumps(report))
    else:
        print(render(report, tenant=tenant))
    return 0
