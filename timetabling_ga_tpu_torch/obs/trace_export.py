"""`trace` — export JSONL logs' spans as Chrome trace-event JSON (copy
of timetabling_ga_tpu/obs/trace_export.py, under the same names; the
output is byte for byte the same on the same logs).

    tt trace run.jsonl -o trace.json
    tt trace --job j42 serve.jsonl -o j42.json
    tt trace --job j42 gateway.jsonl replica0.jsonl replica1.jsonl

The output is the Trace Event Format's "JSON object" flavor
({"traceEvents": [...]}) loadable in Perfetto / chrome://tracing, so a
run's host-side span timeline (dispatch / fetch / process / checkpoint
/ serve quanta) can be read next to a `--trace-profile` device
timeline.

MULTIPLE inputs (tt-obs v5, the fleet observatory) stitch into ONE
timeline: each log becomes its own Perfetto PROCESS (pid = input
order, labeled with the file's basename via process_name metadata), so
a fleet trace shows the gateway's routing lanes above each replica's
dispatch lanes. Flow chains stitch across the process boundary: ids
at/above obs/spans.py XFLOW_BASE are CROSS-PROCESS chains (minted only
by the gateway and shipped to replicas as X-TT-Flow, so they are
globally unique) and are kept verbatim — the gateway's route/submit/
routed spans and the replica's admit/quantum/finalize spans share one
id and render as arrows crossing pids. Each log's LOCAL flow ids are
remapped into a per-input namespace, so two replicas' unrelated chunk
chains can never merge by id collision. Mapping:

  spanEntry    -> complete event (ph "X"): ts/dur in microseconds,
                  tid = the tracer's per-thread lane, args = every
                  extra attribute the span carried
  flow= attrs  -> Perfetto flow events (ph "s"/"t"/"f"): spans sharing
                  a flow id (SpanTracer.new_flow — one causal chain:
                  a dispatch's dispatch→fetch-read→process life across
                  the watchdog thread, a checkpoint's enqueue→write
                  handoff onto the writer thread, a serve job's
                  admit→pack→quantum→park→resume→finalize) render as
                  connected arrows across thread lanes. A span whose
                  `flow` is a LIST (a packed serve dispatch advancing
                  many jobs) participates in every listed chain.
  phase        -> complete event on its own lane ("phases"): the legacy
                  `--trace` records have no start timestamp, so they
                  are laid end-to-end in record order — coarse, but it
                  puts pre-obs logs on the same screen
  metricsEntry -> counter events (ph "C") for every numeric counter/
                  gauge, at the snapshot's `ts` — Perfetto renders
                  them as tracks (gens/sec, queue depth over time)
  qualityEntry -> counter events (ph "C") for every numeric quality
                  field (diversity Hamming/variance, operator win
                  counts, migration gain) at the entry's `ts` — the
                  search-quality observatory's per-dispatch telemetry
                  as live tracks next to the dispatch spans
  costEntry    -> complete event on the "compiles" lane (tid 998): a
                  slab of lowerSeconds+compileSeconds ENDING at the
                  record's `ts` (the observatory stamps emission right
                  after the compile returns), named
                  compile:<program> — XLA compile cost sits on the
                  same screen as the dispatches it delayed

`--job ID` filters to ONE job's causal trace: the spans tagged
`job=ID` (scalar, or carrying ID in a packed dispatch's job list),
connected by the job's own flow chain — its end-to-end
admit→pack→quantum→park→resume→finalize timeline (plus, in a stitched
fleet trace, the gateway's route→submit→routed→settle leg) across
lanes, parks, and co-tenant dispatches, without the other tenants'
noise. Counter tracks and phase lanes are process-global, so job mode
drops them.

Clock caveat for stitched traces: each log's `ts` is seconds since ITS
tracer's epoch, so lanes from different processes are aligned only as
well as the processes started together (a gateway and the replicas it
spawned share a start to within boot time). The flow ARROWS are exact
— they bind by id, not by clock.

Stdlib-only and device-free: exporting a log must work on any machine
the log was copied to.
"""

from __future__ import annotations

import json
import os
import sys

from timetabling_ga_tpu_torch.obs.spans import XFLOW_BASE

# per-input namespace stride for LOCAL flow ids in stitched exports:
# far above both any realistic local id and the XFLOW_BASE range the
# gateway allocates in, so remapped ids collide with nothing
_LOCAL_FLOW_NS = 1 << 48


def _span_event(e: dict) -> dict:
    args = {k: v for k, v in e.items()
            if k not in ("name", "cat", "ts", "dur", "depth", "tid",
                         "_pid")}
    args["depth"] = e.get("depth", 0)
    return {"name": e.get("name", "?"), "cat": e.get("cat", "engine"),
            "ph": "X", "pid": int(e.get("_pid", 0)),
            "tid": int(e.get("tid", 0)),
            "ts": round(float(e.get("ts", 0.0)) * 1e6, 3),
            "dur": round(max(0.0, float(e.get("dur", 0.0))) * 1e6, 3),
            "args": args}


def _counter_events(rec: dict, pid: int = 0) -> list[dict]:
    ts = rec.get("ts")
    if ts is None:
        return []
    out = []
    for kind in ("counters", "gauges"):
        for name, v in (rec.get(kind) or {}).items():
            if isinstance(v, (int, float)) and v == v:
                out.append({"name": name, "ph": "C", "pid": pid,
                            "tid": 0,
                            "ts": round(float(ts) * 1e6, 3),
                            "args": {"value": v}})
    return out


def _quality_counter_events(rec: dict, pid: int = 0) -> list[dict]:
    """qualityEntry -> one Perfetto counter sample per numeric quality
    field. Serve entries are job-tagged (one entry per lane per
    dispatch); their track names get a `[job]` suffix so co-tenants'
    tracks stay apart."""
    ts = rec.get("ts")
    if ts is None:
        return []
    job = rec.get("job")
    out = []
    for name, v in rec.items():
        if name in ("ts", "job", "dispatch", "gens"):
            continue
        if isinstance(v, (int, float)) and v == v:
            track = f"{name}[{job}]" if job is not None else name
            out.append({"name": track, "ph": "C", "pid": pid, "tid": 0,
                        "ts": round(float(ts) * 1e6, 3),
                        "args": {"value": v}})
    return out


def _flow_ids(e: dict) -> list[int]:
    """A span's flow memberships: `flow` is an int, or a list when one
    span advances several causal chains (a packed serve dispatch).
    0/None entries mean 'no chain' (a disabled tracer's new_flow)."""
    f = e.get("flow")
    ids = f if isinstance(f, list) else [f]
    return [int(i) for i in ids
            if isinstance(i, (int, float)) and int(i) > 0]


def _span_matches_job(e: dict, job: str) -> bool:
    j = e.get("job")
    if isinstance(j, list):
        return job in [str(x) for x in j]
    return j is not None and str(j) == job


def _flow_events(spans: list[dict], only=None) -> list[dict]:
    """Perfetto flow events binding spans that share a flow id.

    The event timestamp sits at the MIDDLE of its span: flow events
    bind to the slice open at their ts on that thread lane, and the
    midpoint is inside the slice regardless of how sub-microsecond
    rounding moved its edges. Chain members are ORDERED by that same
    midpoint — not by span start — so the emitted `s` (first), `t`
    (steps), `f` (finish, bp="e") sequence is monotone in the
    timestamps it carries even when one member nests inside an
    earlier-starting sibling (a serve job's `finalize` runs inside the
    scheduler's `park` span). Chains with a single member draw no
    arrow — there is nothing to connect. `only` restricts to a set of
    chain ids (the --job view draws the job's own chain, not every
    co-tenant chain its packed dispatches also advanced)."""
    chains: dict[int, list[dict]] = {}
    for e in spans:
        for fid in _flow_ids(e):
            chains.setdefault(fid, []).append(e)
    out = []
    for fid, members in sorted(chains.items()):
        if len(members) < 2 or (only is not None and fid not in only):
            continue
        mids = sorted(((float(e.get("ts", 0.0))
                        + max(0.0, float(e.get("dur", 0.0))) / 2.0, e)
                       for e in members), key=lambda t: t[0])
        last = len(mids) - 1
        for i, (mid, e) in enumerate(mids):
            ev = {"name": "flow", "cat": "flow",
                  "ph": "s" if i == 0 else ("f" if i == last else "t"),
                  "id": fid, "pid": int(e.get("_pid", 0)),
                  "tid": int(e.get("tid", 0)),
                  "ts": round(mid * 1e6, 3)}
            if i == last:
                ev["bp"] = "e"     # bind to the enclosing slice
            out.append(ev)
    return out


def _remap_flow(flow, pid: int):
    """Stitched exports keep CROSS-PROCESS ids (>= XFLOW_BASE — minted
    by exactly one process, so globally unique) verbatim and move each
    log's local ids into a per-input namespace: replica 0's chunk
    chain 3 and replica 1's chunk chain 3 are different chains."""
    def one(i):
        if isinstance(i, (int, float)) and 0 < int(i) < XFLOW_BASE:
            return (pid + 1) * _LOCAL_FLOW_NS + int(i)
        return i
    if isinstance(flow, list):
        return [one(i) for i in flow]
    return one(flow)


def _collect(records, pid: int, remap: bool, job_mode: bool):
    """One log's records -> (span bodies tagged `_pid` [+ remapped
    flows], non-span events). Counter tracks / compile slabs / phase
    lanes are process-global, so job mode drops them (module
    docstring)."""
    spans: list[dict] = []
    events: list[dict] = []
    phase_t = 0.0
    for rec in records:
        if "spanEntry" in rec:
            e = dict(rec["spanEntry"])
            e["_pid"] = pid
            if remap and "flow" in e:
                e["flow"] = _remap_flow(e["flow"], pid)
            spans.append(e)
        elif not job_mode and "metricsEntry" in rec:
            events.extend(_counter_events(rec["metricsEntry"], pid))
        elif not job_mode and "qualityEntry" in rec:
            events.extend(
                _quality_counter_events(rec["qualityEntry"], pid))
        elif not job_mode and "costEntry" in rec:
            c = rec["costEntry"]
            ts = c.get("ts")
            if ts is not None:
                dur = max(0.0, float(c.get("lowerSeconds", 0.0))
                          + float(c.get("compileSeconds", 0.0)))
                args = {k: v for k, v in c.items()
                        if k not in ("ts", "program")}
                events.append(
                    {"name": f"compile:{c.get('program', '?')}",
                     "cat": "compile", "ph": "X", "pid": pid,
                     "tid": 998,
                     "ts": round(max(0.0, float(ts) - dur) * 1e6, 3),
                     "dur": round(dur * 1e6, 3), "args": args})
        elif not job_mode and "phase" in rec:
            p = rec["phase"]
            dur = max(0.0, float(p.get("seconds", 0.0)))
            args = {k: v for k, v in p.items()
                    if k not in ("name", "seconds")}
            events.append({"name": p.get("name", "?"), "cat": "phase",
                           "ph": "X", "pid": pid, "tid": 999,
                           "ts": round(phase_t * 1e6, 3),
                           "dur": round(dur * 1e6, 3), "args": args})
            phase_t += dur
    return spans, events


def export_stitched(inputs, job: str | None = None) -> dict:
    """[(label, records), ...] -> ONE Chrome trace-event JSON object.

    Each input becomes its own Perfetto process lane (pid = position,
    named `label` via process_name metadata when there are several);
    flow chains connect across inputs by shared CROSS-PROCESS ids
    (module docstring) while local ids are kept per-input. `job`
    filters to one job's causal trace across every input — for a fleet
    log set that is the gateway routing leg AND the replica solve leg,
    joined by the job's X-TT-Flow chain."""
    multi = len(inputs) > 1
    spans: list[dict] = []
    events: list[dict] = []
    meta: list[dict] = []
    for pid, (label, records) in enumerate(inputs):
        s, ev = _collect(records, pid, remap=multi,
                         job_mode=job is not None)
        spans.extend(s)
        events.extend(ev)
        if multi and label:
            meta.append({"name": "process_name", "ph": "M",
                         "pid": pid, "tid": 0,
                         "args": {"name": str(label)}})
    only = None
    if job is not None:
        job = str(job)
        spans = [e for e in spans if _span_matches_job(e, job)]
        # the job's OWN chain: the flow id its exclusively-tagged spans
        # (admit / shed / finalize — scalar job=) carry. Packed spans
        # also list the co-tenants' chain ids; drawing those would wire
        # the job's timeline to arrows about other tenants. Fallback to
        # every chain among the kept spans when no scalar tag survived
        # (a torn log that lost the admit record).
        only = {fid for e in spans
                if not isinstance(e.get("job"), list)
                for fid in _flow_ids(e)} or None
    events = meta + [_span_event(e) for e in spans] \
        + _flow_events(spans, only=only) + events
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"source": "tt trace",
                         "format": "timetabling_ga_tpu JSONL"}}
    if multi:
        doc["otherData"]["inputs"] = [str(lb) for lb, _ in inputs]
    if job is not None:
        doc["otherData"]["job"] = job
    return doc


def export_chrome_trace(records, job: str | None = None) -> dict:
    """JSONL record dicts -> Chrome trace-event JSON object (the
    single-log form; `tt trace` with several inputs uses
    export_stitched).

    `job` filters to one serve job's causal trace (see module
    docstring): its tagged spans, every span sharing its flow ids, and
    their flow arrows only."""
    return export_stitched([(None, records)], job=job)


def read_jsonl(path: str) -> list[dict]:
    records = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                # a torn tail line (killed run) must not block export
                continue
    return records


def main_trace(argv) -> int:
    """`tt trace <log.jsonl> [more.jsonl ...] [-o trace.json]
    [--job ID]` entry point."""
    inputs: list[str] = []
    out, job = None, None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print("usage: tt trace <log.jsonl> [more.jsonl ...] "
                  "[-o trace.json] [--job ID]\n\n"
                  "export spanEntry/phase/metricsEntry records as "
                  "Chrome trace-event JSON (Perfetto / chrome://tracing)"
                  "\nwith flow arrows connecting causal chains across "
                  "thread lanes; --job ID renders one serve job's\n"
                  "end-to-end timeline (admit -> pack -> quantum -> "
                  "park -> resume) and nothing else.\n"
                  "Several inputs (gateway.jsonl replica*.jsonl) "
                  "stitch into ONE timeline with a process lane per\n"
                  "log and flow arrows crossing the process boundary "
                  "(a routed job's gateway leg + replica leg)")
            return 0
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
        inputs.append(a)
        i += 1
    if not inputs:
        raise SystemExit("usage: tt trace <log.jsonl> [more.jsonl ...]"
                         " [-o trace.json] [--job ID]")
    resolved: list = []
    for p in inputs:
        records = read_jsonl(p)
        # an INCIDENT BUNDLE (the JAX package's obs/flight.py) needs the
        # flight recorder, which is not ported yet: refused by name
        if any(isinstance(r, dict) and isinstance(r.get("incident"), dict)
               for r in records):
            raise SystemExit(f"{p}: incident bundles are not yet ported "
                             f"to timetabling_ga_tpu_torch (use "
                             f"timetabling_ga_tpu)")
        resolved.append((os.path.basename(p), records))
    doc = export_stitched(resolved, job=job)
    if out is None:
        out = inputs[0] + ".trace.json"
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    n = len(doc["traceEvents"])
    tag = f" (job {job})" if job is not None else ""
    src = (inputs[0] if len(inputs) == 1
           else f"{len(inputs)} stitched logs")
    print(f"tt trace: {n} event{'s' if n != 1 else ''}{tag} from "
          f"{src} -> {out}", file=sys.stderr)
    return 0
