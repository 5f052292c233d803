"""`stats` — human-readable summary of a JSONL record stream (copy of
timetabling_ga_tpu/obs/logstats.py, under the same names; the output is
byte for byte the same on the same logs).

    tt stats run.jsonl

Answers the questions people were answering with jq one-liners: what
did each island/job converge to and how fast (best-so-far curve,
time-to-feasible), did the run recover from faults (sites, actions,
degradation levels), how long did serve jobs take (per-job latency from
their solution records), and what did the last metrics snapshot say.

For serve logs recorded with `--obs`, the jobEntry lifecycle and the
job-tagged spanEntry records additionally yield a per-job WALL-TIME
BREAKDOWN — where each job's latency went:

  queued      admission to its first pack (waiting for a lane)
  routed      the fleet gateway's placement leg (admit-at-gateway →
              accepted-by-replica: the `routed` span a gateway log
              carries per placed job — fleet/gateway.py, tt-obs v5)
  recovered   warm-start snapshot admission on a RESUMED job (the
              fleet-resume seam, serve/scheduler._admit_resumed):
              what a failed-over or preempted job paid to not replay
              — only present for resumed jobs
  packed      pack / resume / park spans it rode (the per-quantum
              host-side cost of the park/resume serving model)
  executing   its quantum spans (device time advancing the job)
  parked      everything else between admit and finalize — sitting as
              a host snapshot while co-tenants ran

with p50/p99 across jobs per component — the numbers that say whether
a slow service needs more lanes (queued), a faster gateway (routed),
bigger quanta (packed), or faster kernels (executing). Several inputs
concatenate (`tt stats gateway.jsonl replica*.jsonl` summarizes a
fleet's whole log set); each log's timestamps live in its OWN tracer
epoch, so the breakdown windows a job over its replica-side spans
only and adds the gateway leg as the clock-safe `routed` duration sum
(see `_job_breakdown`) — timestamps from different logs are never
differenced.

Gateway logs additionally yield a per-replica PLACEMENT summary from
the routeEntry records (tt-obs v5): placements per replica with the
router's hit/warm/miss affinity outcomes — `tt stats` answers "where
did my bucket land and was it warm" without a Perfetto round trip.

Stdlib-only and device-free, like the trace exporter.
"""

from __future__ import annotations

import json

from timetabling_ga_tpu_torch.obs.trace_export import read_jsonl

FEASIBLE_LIMIT = 1_000_000


def _key(proc_id, job):
    return f"job {job}" if job is not None else f"island {proc_id}"


# span taxonomy feeding the per-job breakdown (scheduler.py span names
# + the gateway's placement leg, fleet/gateway.py)
_EXEC_SPANS = ("quantum",)
_PACKED_SPANS = ("pack", "resume", "park")   # init nests inside pack
_ROUTED_SPANS = ("routed",)                  # gateway admit→placed
_RECOVERED_SPANS = ("recover",)              # warm-start snapshot
#                                              admission on a resumed
#                                              job (the fleet-resume
#                                              seam, serve/scheduler
#                                              _admit_resumed)


def _pctl(vals, q):
    """Nearest-rank percentile over a sorted list (the same estimator
    the legacy latency line uses)."""
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def _job_breakdown(spans) -> dict:
    """Per-job wall-time decomposition from job-tagged spans.

    A span tagged with a job LIST (a packed dispatch advancing many
    lanes) counts fully toward every listed job: each job really did
    spend that wall time inside the span — concurrency, not
    attribution error. `parked` is the remainder between admission and
    the job's last span: time spent as a host snapshot while
    co-tenants held the lanes.

    Clock discipline for fleet log sets: each log's `ts` is seconds
    since ITS tracer epoch, so gateway and replica timestamps must
    never be differenced. The time WINDOW (t0/end → total, queued,
    parked) is therefore computed from the replica-side spans alone
    (everything not `cat="fleet"`); the gateway leg enters as the
    `routed` component — a span-duration SUM, clock-safe by
    construction — added on top of the window, so `total ≈ e2e` and
    the printed identity `total = queued + routed + packed +
    executing + parked` holds (modulo the unprinted finalize sliver).
    A gateway-only log (no replica spans for the job) falls back to
    its own window, where the routed span IS inside and is subtracted
    from the remainder instead."""
    per: dict = {}
    for s in spans:
        j = s.get("job")
        ids = ([str(x) for x in j] if isinstance(j, list)
               else [str(j)] if j is not None else [])
        for jid in ids:
            per.setdefault(jid, []).append(s)
    out: dict = {}
    for jid, ss in sorted(per.items()):
        base = [s for s in ss if s.get("cat") != "fleet"] or ss
        in_window = base is ss       # gateway-only: routed inside
        # one SOURCE log for the window: a failed-over job has replica
        # spans in TWO logs with unrelated epochs (`_src` is stamped
        # by main_stats per input file). The authoritative leg is the
        # one that finalized — the dead replica's partial leg is the
        # copy the gateway's failover discarded; fall back to the
        # largest leg when no finalize survived. The replica-side
        # tallies (executing/packed/finalize) come from the same leg,
        # so the components describe the run the job's record stream
        # actually is; only `routed` sums across sources (the gateway
        # leg lives in its own log by construction).
        by_src: dict = {}
        for s in base:
            by_src.setdefault(s.get("_src", 0), []).append(s)
        if len(by_src) > 1:
            base = next(
                (grp for grp in by_src.values()
                 if any(s.get("name") == "finalize" for s in grp)),
                max(by_src.values(), key=len))
        t0 = min(float(s.get("ts", 0.0)) for s in base)
        end = max(float(s.get("ts", 0.0))
                  + max(0.0, float(s.get("dur", 0.0))) for s in base)
        base_total = max(0.0, end - t0)

        def tally(names, ss=base):
            return sum(max(0.0, float(s.get("dur", 0.0))) for s in ss
                       if s.get("name") in names)

        executing = tally(_EXEC_SPANS)
        packed = tally(_PACKED_SPANS)
        routed = tally(_ROUTED_SPANS, ss)   # the gateway leg: every
        #                                     placement round, summed
        recovered = tally(_RECOVERED_SPANS)  # snapshot unpack +
        #                                      rehydrate on resume —
        #                                      what a failed-over job
        #                                      paid to NOT replay
        work = _EXEC_SPANS + _PACKED_SPANS + _RECOVERED_SPANS \
            + (_ROUTED_SPANS if in_window else ())
        first_work = min(
            (float(s.get("ts", 0.0)) for s in base
             if s.get("name") in work), default=end)
        queued = max(0.0, first_work - t0)
        fin = tally(("finalize",))
        rest = max(0.0, base_total - queued - packed - executing
                   - recovered - fin
                   - (routed if in_window else 0.0))
        total = base_total if in_window else base_total + routed
        out[jid] = {"total": total, "queued": queued,
                    "routed": routed, "recovered": recovered,
                    "packed": packed, "executing": executing,
                    "parked": rest}
    return out


def summarize(records) -> str:
    """The `tt stats` report text for a list of record dicts."""
    curves: dict = {}       # stream key -> list of (best, time)
    solutions: dict = {}    # stream key -> solution record
    runs = []
    faults: list = []
    jobs: dict = {}         # job id -> lifecycle events
    spans: list = []        # spanEntry bodies (per-job breakdown)
    flight_spans: list = []  # flight_dump spans (incident section)
    routes: list = []       # routeEntry bodies (placement summary)
    compiles: list = []     # costEntry bodies (compile accounting)
    usage_recs: list = []   # whole records (obs/usage.py summarize)
    scale_recs: list = []   # whole records (fleet/autoscaler.py
    #                         summarize_entries — the tt-scale
    #                         decision log)
    quality_recs: list = []  # whole records (obs/quality.py summarize)
    prof_recs: list = []    # profEntry bodies (tt-prof attribution)
    counts: dict = {}
    last_metrics = None
    for rec in records:
        kind = next(iter(rec), None)
        counts[kind] = counts.get(kind, 0) + 1
        body = rec.get(kind)
        if kind == "logEntry":
            k = _key(body.get("procID"), body.get("job"))
            curves.setdefault(k, []).append(
                (body.get("best"), body.get("time", 0.0)))
        elif kind == "solution":
            solutions[_key(body.get("procID"), body.get("job"))] = body
        elif kind == "runEntry":
            runs.append(body)
        elif kind == "faultEntry":
            faults.append(body)
        elif kind == "jobEntry":
            jobs.setdefault(body.get("job"), []).append(body)
        elif kind == "spanEntry":
            if body.get("job") is not None:
                spans.append(body)
            if body.get("name") == "flight_dump":
                flight_spans.append(body)
        elif kind == "routeEntry":
            routes.append(body)
        elif kind == "costEntry":
            compiles.append(body)
        elif kind == "usageEntry":
            usage_recs.append(rec)
        elif kind == "scaleEntry":
            scale_recs.append(rec)
        elif kind == "qualityEntry":
            quality_recs.append(rec)
        elif kind == "profEntry":
            prof_recs.append(body)
        elif kind == "metricsEntry":
            last_metrics = body

    lines = ["== record stream"]
    lines.append("  " + "  ".join(f"{k}:{v}" for k, v in
                                  sorted(counts.items())))

    if curves or solutions:
        lines.append("== best-so-far")
        for k in sorted(set(curves) | set(solutions)):
            pts = curves.get(k, [])
            sol = solutions.get(k)
            parts = [f"  {k}:"]
            if pts:
                first_b, first_t = pts[0]
                last_b, last_t = pts[-1]
                parts.append(f"{first_b} @ {first_t:.1f}s -> "
                             f"{last_b} @ {last_t:.1f}s "
                             f"({len(pts)} improvements)")
                feas = next((t for b, t in pts if b < FEASIBLE_LIMIT),
                            None)
                if feas is not None:
                    parts.append(f"feasible @ {feas:.1f}s")
            if sol is not None:
                feas_s = ("feasible" if sol.get("feasible")
                          else "INFEASIBLE")
                parts.append(f"final {sol.get('totalBest')} ({feas_s}, "
                             f"{sol.get('totalTime', 0.0):.1f}s)")
            lines.append(" ".join(parts))

    if runs:
        final = runs[-1]
        lines.append(f"== run: totalBest {final.get('totalBest')} "
                     f"feasible={final.get('feasible')}"
                     + (f" totalTime {final['totalTime']:.1f}s"
                        if "totalTime" in final else ""))

    if faults:
        lines.append(f"== faults ({len(faults)} records)")
        by_site: dict = {}
        for f in faults:
            by_site.setdefault((f.get("site"), f.get("action")), []
                               ).append(f)
        for (site, action), fs in sorted(by_site.items()):
            worst = max(f.get("level", 0) for f in fs)
            lines.append(f"  {site}/{action}: {len(fs)}x "
                         f"(max level {worst}); last: "
                         f"{str(fs[-1].get('error', ''))[:80]}")
    else:
        lines.append("== faults: none")

    if jobs:
        lines.append(f"== jobs ({len(jobs)})")
        lats = []
        edit_lats = []          # mode=edit jobs, split out (tt-edit)
        edit_demoted = 0
        edit_dists = []
        for jid, evs in sorted(jobs.items()):
            events = [e.get("event") for e in evs]
            sol = solutions.get(f"job {jid}")
            lat = sol.get("totalTime") if sol else None
            if lat is not None:
                lats.append(lat)
            done = next((e for e in evs if e.get("event") == "done"),
                        None)
            mode = next((e.get("mode") for e in evs
                         if e.get("mode")), None)
            tag = ""
            if mode:
                tag = f" [{mode}]"
                if mode == "edit":
                    if lat is not None:
                        edit_lats.append(lat)
                    if any(e.get("demoted") for e in evs):
                        edit_demoted += 1
                        tag = " [edit, demoted]"
                    if done and done.get("edit_distance") is not None:
                        edit_dists.append(int(done["edit_distance"]))
            lines.append(
                f"  {jid}{tag}: {'->'.join(events)}"
                + (f" best {done.get('best')} gens {done.get('gens')}"
                   if done else "")
                + (f" latency {lat:.2f}s" if lat is not None else ""))
        if lats:
            lats.sort()
            p = (lambda q: lats[min(len(lats) - 1,
                                    int(q * len(lats)))])
            lines.append(f"  latency p50 {p(0.5):.2f}s "
                         f"p95 {p(0.95):.2f}s max {lats[-1]:.2f}s")
        if edit_lats or edit_demoted:
            # incremental re-solves get their own latency row: warm
            # edits are the latency story tt-edit exists to improve,
            # so averaging them into cold solves would hide it
            edit_lats.sort()
            parts = [f"  edit: {len(edit_lats)} jobs"
                     + (f" ({edit_demoted} demoted)"
                        if edit_demoted else "")]
            if edit_lats:
                parts.append(
                    f"latency p50 {_pctl(edit_lats, 0.5):.2f}s "
                    f"p95 {_pctl(edit_lats, 0.95):.2f}s")
            if edit_dists:
                ds = sorted(edit_dists)
                parts.append(f"edit_distance p50 {_pctl(ds, 0.5)} "
                             f"max {ds[-1]}")
            lines.append(" ".join(parts))

    breakdown = _job_breakdown(spans)
    if breakdown:
        # the `routed` column only appears when some job actually has
        # a gateway placement span — plain serve logs keep the old shape
        with_routed = any(b["routed"] > 0 for b in breakdown.values())
        # likewise `recovered`: only resumed jobs (fleet failover /
        # preemption) carry the snapshot-admission span
        with_rec = any(b["recovered"] > 0 for b in breakdown.values())
        lines.append(f"== job latency breakdown ({len(breakdown)} "
                     f"jobs, from spans)")
        for jid, b in breakdown.items():
            routed_s = (f"routed {b['routed']:.2f} + "
                        if with_routed else "")
            rec_s = (f"recovered {b['recovered']:.2f} + "
                     if with_rec else "")
            lines.append(
                f"  {jid}: total {b['total']:.2f}s = "
                f"queued {b['queued']:.2f} + {routed_s}{rec_s}"
                f"packed {b['packed']:.2f} "
                f"+ executing {b['executing']:.2f} "
                f"+ parked {b['parked']:.2f}")
        comps = ("total", "queued") \
            + (("routed",) if with_routed else ()) \
            + (("recovered",) if with_rec else ()) \
            + ("packed", "executing", "parked")
        for comp in comps:
            vals = sorted(b[comp] for b in breakdown.values())
            lines.append(f"  {comp}: p50 {_pctl(vals, 0.5):.2f}s "
                         f"p99 {_pctl(vals, 0.99):.2f}s "
                         f"max {vals[-1]:.2f}s")

    if routes:
        # gateway placement summary (routeEntry, tt-obs v5): per
        # replica, how many placements landed there and how warm —
        # the affinity story per replica, straight off the log
        lines.append(f"== placements ({len(routes)} routeEntry "
                     f"records)")
        by_rep: dict = {}
        for r in routes:
            by_rep.setdefault(r.get("replica", "?"), []).append(r)
        for rep, rs in sorted(by_rep.items()):
            outcomes: dict = {}
            buckets = set()
            for r in rs:
                o = r.get("outcome", "?")
                outcomes[o] = outcomes.get(o, 0) + 1
                if r.get("bucket") is not None:
                    buckets.add(tuple(r["bucket"]))
            ostr = " ".join(f"{k}:{v}" for k, v in
                            sorted(outcomes.items()))
            lines.append(f"  {rep}: {len(rs)} placements "
                         f"({ostr}) over {len(buckets)} "
                         f"bucket{'s' if len(buckets) != 1 else ''}")

    if flight_spans:
        # tt-flight (obs/flight.py): every `flight_dump` span is one
        # incident bundle written — its duration is the TIME-TO-DUMP
        # (trigger instant -> bundle on disk), the latency of the
        # black box itself
        lines.append(f"== incidents ({len(flight_spans)} dumps)")
        by_trig: dict = {}
        for s in flight_spans:
            by_trig.setdefault(s.get("trigger", "?"), []).append(
                max(0.0, float(s.get("dur", 0.0))))
        for trig, durs in sorted(by_trig.items()):
            durs.sort()
            lines.append(
                f"  {trig}: {len(durs)}x, time-to-dump "
                f"p50 {_pctl(durs, 0.5):.3f}s "
                f"p99 {_pctl(durs, 0.99):.3f}s")

    if prof_recs:
        # tt-prof (obs/prof.py): per-phase share of attributed device
        # time across this log's profiler captures — p50/p95 of each
        # phase's fraction over the profEntry records, so a phase whose
        # share GREW between captures shows as a spread, not an average
        lines.append(f"== phases ({len(prof_recs)} profEntry records)")
        shares: dict = {}
        secs: dict = {}
        for b in prof_recs:
            for name, ph in (b.get("phases") or {}).items():
                shares.setdefault(name, []).append(
                    float(ph.get("frac", 0.0)))
                secs.setdefault(name, []).append(
                    float(ph.get("s", 0.0)))
            shares.setdefault("unattributed", []).append(
                float(b.get("unattributedFrac", 0.0)))
            secs.setdefault("unattributed", []).append(
                float(b.get("unattributedSeconds", 0.0)))
        order = sorted(shares, key=lambda n: -sorted(shares[n])[
            min(len(shares[n]) - 1, len(shares[n]) // 2)])
        for name in order:
            fr = sorted(shares[name])
            lines.append(
                f"  {name}: share p50 {_pctl(fr, 0.5):.1%} "
                f"p95 {_pctl(fr, 0.95):.1%} "
                f"({sum(secs[name]):.3f}s over "
                f"{len(fr)} capture{'s' if len(fr) != 1 else ''})")

    if compiles:
        # cost observatory (obs/cost.py): per-program compile count,
        # total lower+compile seconds, and the latest roofline numbers
        lines.append(f"== compiles ({len(compiles)} costEntry records)")
        by_prog: dict = {}
        for c in compiles:
            by_prog.setdefault(c.get("program", "?"), []).append(c)
        for prog, cs in sorted(by_prog.items()):
            total = sum(float(c.get("lowerSeconds", 0.0))
                        + float(c.get("compileSeconds", 0.0))
                        for c in cs)
            # latest entry CARRYING roofline numbers (a backend may
            # omit flops on some compiles)
            last = next((c for c in reversed(cs)
                         if c.get("flops") is not None), cs[-1])
            tail = ""
            if last.get("flops") is not None:
                tail = f" flops {last['flops']:.3g}"
                if last.get("intensity") is not None:
                    tail += f" AI {last['intensity']:.1f}"
            lines.append(f"  {prog}: {len(cs)}x, {total:.2f}s "
                         f"lower+compile{tail}")

    if usage_recs:
        # tt-meter (obs/usage.py owns the report): who consumed the
        # capacity — per-tenant and per-job device seconds, FLOPs,
        # queue/park wall, compile amortization
        from timetabling_ga_tpu_torch.obs import usage as obs_usage
        lines.append(obs_usage.summarize_entries(usage_recs))

    if scale_recs:
        # tt-scale (fleet/autoscaler.py owns the report): the
        # autoscaler decision log with its sustained-window evidence
        from timetabling_ga_tpu_torch.fleet.autoscaler import (
            summarize_entries as scale_summary)
        lines.append(scale_summary(scale_recs))

    if quality_recs:
        # search-quality observatory (obs/quality.py owns the report):
        # diversity trend, operator hit rates, migration gain, and the
        # stall/kick event log (faultEntry site `quality`)
        from timetabling_ga_tpu_torch.obs import quality as obs_quality
        lines.append(obs_quality.summarize(
            quality_recs + [{"faultEntry": f} for f in faults
                            if f.get("site") == "quality"]))

    if last_metrics is not None:
        lines.append("== last metrics snapshot")
        for kind in ("counters", "gauges"):
            for name, v in sorted((last_metrics.get(kind) or {}).items()):
                lines.append(f"  {name}: {v}")
        for name, h in sorted((last_metrics.get("histograms")
                               or {}).items()):
            if h.get("count"):
                lines.append(f"  {name}: n={h['count']} "
                             f"p50={h.get('p50')} p95={h.get('p95')} "
                             f"max={h.get('max')}")
    return "\n".join(lines)


def main_stats(argv) -> int:
    """`tt stats <log.jsonl> [more.jsonl ...]` entry point."""
    inputs: list = []
    for a in argv:
        if a in ("-h", "--help"):
            print("usage: tt stats <log.jsonl> [more.jsonl ...]\n\n"
                  "summarize a JSONL record stream: best-so-far curves, "
                  "time-to-feasible, recoveries and fault sites, per-job "
                  "latency (serve+obs logs: queued/routed/packed/"
                  "executing/parked breakdown, p50/p99 across jobs), "
                  "gateway placement summary (routeEntry), last metrics "
                  "snapshot. Several inputs concatenate — `tt stats "
                  "gateway.jsonl replica*.jsonl` reads a fleet's whole "
                  "log set")
            return 0
        if a.startswith("-"):
            raise SystemExit(f"unknown argument: {a}")
        inputs.append(a)
    if not inputs:
        raise SystemExit("usage: tt stats <log.jsonl> [more.jsonl ...]")
    records: list = []
    for idx, path in enumerate(inputs):
        batch = read_jsonl(path)
        if len(inputs) > 1:
            # stamp span provenance: each log's timestamps live in
            # its own tracer epoch, and _job_breakdown must window a
            # job inside ONE log (a failed-over job has spans in two
            # replica logs whose epochs are unrelated)
            for rec in batch:
                body = rec.get("spanEntry")
                if isinstance(body, dict):
                    body["_src"] = idx
        records.extend(batch)
    print(summarize(records))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main_stats(sys.argv[1:]))
