"""The fleet autoscaler (port of timetabling_ga_tpu/fleet/autoscaler.py,
under the same names): a policy-driven actuator over sustained fleet
signals, and its decision report.

A control-loop thread on the gateway evaluates the policy every
`--scale-every` seconds over the history ring of the gateway's own
registry (obs/history.py `sustained`, `rate`, `mean_over`) and acts
through two seams only:

  SPAWN   fleet/replicas.spawn_one (a fresh local port; `--boot-grace`
          covers the worker's start), adopted through
          Gateway.adopt_replica;
  RETIRE  Gateway.preempt_replica, i.e. POST /v1/drain?mode=preempt&
          replica=NAME: the victim parks and ships every job it owns
          and the dispatcher resumes them on the survivors, so a
          scale-down loses no job.

The policy (FleetConfig's `--scale-*` flags):

  scale UP (while live < --scale-max), the first match wins:
    min_floor    live replicas below --scale-min (bypasses the
                 cooldown);
    queue_depth  sustained("serve.queue_depth", ">=",
                 --scale-up-queue, --scale-up-for);
    slo_burn     sustained("fleet.slo_burn", ">=", 1, --scale-up-for);
    tenant_starved:<t>  rate("usage.tenant.<t>.queue_seconds",
                 --scale-up-for) >= --scale-starve-rate (per-tenant
                 FLOP/s demand rides every decision as evidence).

  scale DOWN (while live > --scale-min):
    idle         sustained("serve.queue_depth", "<=",
                 --scale-down-queue, --scale-down-for), and the victim
                 itself shows mean_over("fleet.replica.<n>.backlog",
                 --scale-idle-window) at or below the same threshold.

  WARMTH GUARD: a scale-down never retires the only warm replica of a
  hot bucket (in-flight jobs, or routed within --scale-warm-recent
  seconds): the dispatcher publishes the protections each tick
  (Gateway._refresh_view) and choose_victim skips them
  (`fleet.scale.blocked_warmth`).

  COOLDOWN (--scale-cooldown): after an action, further actions are
  held (`fleet.scale.blocked_cooldown`).

Every decision (actions and blocks; calm ticks are silent) is a
scaleEntry record on the gateway log with its window evidence (a
TIMING_RECORDS member: the job streams are the same with the scaler on
or off); `fleet.scale.*` counts them; a scale action triggers the
flight recorder; the `scaler` fault site fires once a tick, and a hung
or dead scaler freezes the fleet at its size without stalling anything
else; `--scale-dry-run` evaluates and logs without acting.

Stdlib only at import (runtime/faults, runtime/jsonl): the `scale`
reader below runs on any machine a gateway log was copied to.
"""

from __future__ import annotations

import json
import re
import sys
import threading
import warnings

from timetabling_ga_tpu_torch.runtime import faults, jsonl

# usage.tenant.<t>.queue_seconds — the starvation trigger's series
# (obs/usage.py ledger counters, sampled by obs/history.py)
_TENANT_QUEUE_RE = re.compile(
    r"^usage\.tenant\.(?P<tenant>.+)\.queue_seconds$")
_TENANT_FLOPS_RE = re.compile(
    r"^usage\.tenant\.(?P<tenant>.+)\.flops$")

# per-tenant FLOP/s demand window (seconds): context evidence on every
# decision (`rate("usage.tenant.acme.flops", 60)`)
DEMAND_WINDOW_S = 60.0


def choose_victim(replicas: dict, protected: dict) -> tuple:
    """The scale-down victim among `replicas` ({name: {"inflight": n,
    "idle": bool, ...}} — dead/retired entries must already be
    filtered out), honoring the warmth guard: `protected` maps replica
    name -> the hot buckets it is the ONLY warm home of.

    Candidates must be individually idle (the mean-backlog guard the
    caller evaluated); preference is DEVICE-COLD first — a replica
    whose scraped `serve.resident_groups` gauge reads zero retires
    for free, while a warm one flushes every resident group back
    through the park path — then fewest `serve.resident_bytes` among
    the warm (smallest flush), then fewest in-flight jobs, then name
    (deterministic). A replica whose residency was never scraped
    (None) sorts with the warm ones: unknown is not known-cold.
    Pins deliberately do NOT drive the order: warmth protection is
    the correctness layer, and a cold bucket's re-warm after its idle
    home retires is a bounded warm-up cost, not a lost job. Returns
    (victim_name_or_None, [names the warmth guard skipped]) — a
    skipped name means the policy WANTED that replica and the guard
    refused (`fleet.scale.blocked_warmth`)."""
    def _key(n):
        v = replicas[n]
        rg = v.get("resident_groups")
        rb = v.get("resident_bytes")
        return (0 if rg == 0 else 1,
                rb if isinstance(rb, (int, float)) else float("inf"),
                v.get("inflight", 0), n)
    order = sorted(
        (name for name, v in replicas.items() if v.get("idle")),
        key=_key)
    skipped = []
    for name in order:
        if protected.get(name):
            skipped.append(name)
            continue
        return name, skipped
    return None, skipped


class AutoScaler:
    """The gateway's scaling control loop: one daemon thread, one
    policy evaluation per `--scale-every` seconds (`tick()` is the
    testable unit), actuating ONLY through the spawn pool and the
    preempt-drain seam. The thread never touches router or job state
    directly — it reads the dispatcher's published scale snapshot and
    the history ring, both lock-guarded, and its actuations are an
    inbox enqueue (preempt) plus a subprocess spawn + handle adoption
    (both designed for off-dispatcher callers); it is the only place
    that actuates."""

    def __init__(self, gw, cfg, spawn_fn=None, now=None):
        self._gw = gw
        self._cfg = cfg
        self._now = now or gw.now
        self._spawn_fn = spawn_fn    # name -> ReplicaHandle; None =
        #                              nothing to grow (dry-run, or a
        #                              static fleet being evaluated)
        self._last_action_t = None   # cooldown anchor
        self._last_emitted = None    # (action, reason, blocked) of
        #                              the last record: a sustained
        #                              block emits ONE record per
        #                              stretch, not one per tick
        self._spawn_seq = 0
        self._tick_errored = False   # warn once per failure stretch
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="tt-scale", daemon=True)
        # pre-create the decision counters/gauges so the history ring
        # samples the families from tick one (a trigger that fires on
        # a series born mid-window would otherwise lack coverage)
        reg = gw.registry
        for name in ("ups", "downs", "blocked_warmth",
                     "blocked_cooldown", "tick_errors"):
            reg.counter(f"fleet.scale.{name}")
        reg.gauge("fleet.scale.replicas_target")
        reg.gauge("fleet.scale.replicas_live")

    # -- lifecycle (the history-sampler discipline) ----------------------

    def start(self) -> "AutoScaler":
        self._thread.start()
        return self

    def alive(self) -> bool:
        return self._thread.is_alive()

    def close(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:   # never-started: no join
            self._thread.join(timeout=2.0)   # a hung scaler is
            #                                  abandoned (daemon)

    def _loop(self) -> None:
        while True:
            if not self.tick():
                return
            if self._stop.wait(self._cfg.scale_every):
                return

    # -- one evaluation --------------------------------------------------

    def tick(self) -> bool:
        """One policy evaluation + (maybe) one actuation; False when
        the thread should exit (injected death / teardown). Any other
        failure skips the tick — a torn snapshot or a failed spawn
        must degrade to 'no scaling this second', never kill the
        loop or stall anything else."""
        if sys.is_finalizing():
            return False
        try:
            faults.maybe_fail("scaler")
            decision = self.evaluate()
            self._apply(decision)
        except SystemExit:
            return False            # injected death: exit silently
        except Exception as e:
            # the honest-degradation discipline (usage.dropped, the
            # flight rings' *_dropped): a failing tick freezes the
            # fleet at its current size, and an empty decision log
            # under sustained load must be distinguishable from calm
            # — count it, and warn once per failure stretch
            try:
                self._gw.registry.counter(
                    "fleet.scale.tick_errors").inc()
                if not self._tick_errored:
                    self._tick_errored = True
                    warnings.warn(
                        f"scaler: tick failed ({e!r}); scaling is "
                        "frozen until a tick succeeds (counting "
                        "fleet.scale.tick_errors)", RuntimeWarning)
            except Exception:
                pass
            return True
        self._tick_errored = False
        return True

    def _live(self) -> list:
        """Handles the policy counts as serving capacity: not dead,
        not already retired by an earlier decision (a retiring worker
        is still draining, but it is no longer capacity)."""
        return [h for h in self._gw.replicas.all()
                if not h.dead and not getattr(h, "retired", False)]

    def evaluate(self):
        """The pure policy decision: a dict proposal (the scaleEntry
        body shape minus actuation results), or None for a silent
        idle tick. Reads ONLY the history ring and the dispatcher's
        scale snapshot — no job table, no router internals."""
        gw, cfg = self._gw, self._cfg
        h = gw.history
        live = self._live()
        n_live = len(live)
        live_names = {x.name for x in live}
        demand = self._tenant_demand(h)

        # -- spawn triggers (first match wins) --------------------------
        if n_live < cfg.scale_min:
            return {"action": "up", "reason": "min_floor",
                    "evidence": {"live": n_live,
                                 "scale_min": cfg.scale_min}}
        if n_live < cfg.scale_max:
            if h.sustained("serve.queue_depth", ">=",
                           cfg.scale_up_queue, cfg.scale_up_for):
                ev = {"serve.queue_depth": {
                    "op": ">=", "threshold": cfg.scale_up_queue,
                    "for_s": cfg.scale_up_for,
                    "mean": h.mean_over("serve.queue_depth",
                                        cfg.scale_up_for)}}
                if demand:
                    ev["demand_flops_per_s"] = demand
                return {"action": "up", "reason": "queue_depth",
                        "evidence": ev}
            if h.sustained("fleet.slo_burn", ">=", 1.0,
                           cfg.scale_up_for):
                return {"action": "up", "reason": "slo_burn",
                        "evidence": {"fleet.slo_burn": {
                            "op": ">=", "threshold": 1.0,
                            "for_s": cfg.scale_up_for},
                            **({"demand_flops_per_s": demand}
                               if demand else {})}}
            starved = self._starved_tenant(h)
            if starved is not None:
                tenant, rate = starved
                ev = {f"usage.tenant.{tenant}.queue_seconds": {
                    "rate_per_s": round(rate, 6),
                    "threshold": cfg.scale_starve_rate,
                    "window_s": cfg.scale_up_for}}
                if demand:
                    ev["demand_flops_per_s"] = demand
                return {"action": "up",
                        "reason": f"tenant_starved:{tenant}",
                        "evidence": ev}

        # -- scale-down guard -------------------------------------------
        if (n_live > cfg.scale_min
                and h.sustained("serve.queue_depth", "<=",
                                cfg.scale_down_queue,
                                cfg.scale_down_for)):
            snap = gw.scale_snapshot() or {}
            reps = {}
            for name, v in (snap.get("replicas") or {}).items():
                if name not in live_names:
                    continue         # snapshot lags adoption/retire
                mean = h.mean_over(f"fleet.replica.{name}.backlog",
                                   cfg.scale_idle_window)
                reps[name] = dict(
                    v, backlog_mean=mean,
                    # an unwatched backlog (never probed, or a
                    # replica younger than its first sample) is NOT
                    # idle — the ring answers with evidence or the
                    # guard answers no
                    idle=(mean is not None
                          and mean <= cfg.scale_down_queue))
            protected = {k: v for k, v
                         in (snap.get("protected") or {}).items()
                         if k in reps}
            victim, skipped = choose_victim(reps, protected)
            ev = {"serve.queue_depth": {
                "op": "<=", "threshold": cfg.scale_down_queue,
                "for_s": cfg.scale_down_for,
                "mean": h.mean_over("serve.queue_depth",
                                    cfg.scale_down_for)},
                "replicas": {n: {"inflight": v.get("inflight", 0),
                                 "backlog_mean": v.get("backlog_mean"),
                                 "idle": v.get("idle", False),
                                 "resident_groups":
                                     v.get("resident_groups"),
                                 "resident_bytes":
                                     v.get("resident_bytes")}
                             for n, v in reps.items()}}
            if skipped:
                ev["warmth_skipped"] = {
                    n: protected.get(n, []) for n in skipped}
            return {"action": "down", "reason": "idle",
                    "replica": victim, "warmth_skipped": skipped,
                    "evidence": ev}
        return None

    def _tenant_demand(self, h) -> dict:
        """Per-tenant FLOP/s over the last DEMAND_WINDOW_S, attached to
        every decision as evidence (never a trigger by itself)."""
        demand = {}
        for name in h.names():
            m = _TENANT_FLOPS_RE.match(name)
            if m is None:
                continue
            r = h.rate(name, DEMAND_WINDOW_S)
            if r is not None and r > 0:
                demand[m.group("tenant")] = round(r, 3)
        return demand

    def _starved_tenant(self, h):
        """(tenant, rate) of the worst queue_seconds growth at/above
        --scale-starve-rate, or None. queue_seconds is a cumulative
        counter: its RATE is how many seconds of queue wall the
        tenant accrues per wall second — >= 1.0 means jobs queue
        faster than they start."""
        cfg = self._cfg
        if cfg.scale_starve_rate <= 0:
            return None
        worst = None
        for name in h.names():
            m = _TENANT_QUEUE_RE.match(name)
            if m is None:
                continue
            r = h.rate(name, cfg.scale_up_for)
            if r is not None and r >= cfg.scale_starve_rate:
                if worst is None or r > worst[1]:
                    worst = (m.group("tenant"), r)
        return worst

    # -- actuation -------------------------------------------------------

    def _apply(self, decision) -> None:
        gw, cfg = self._gw, self._cfg
        n_live = len(self._live())
        reg = gw.registry
        reg.gauge("fleet.scale.replicas_live").set(float(n_live))
        if decision is None:
            reg.gauge("fleet.scale.replicas_target").set(
                float(min(max(n_live, cfg.scale_min), cfg.scale_max)))
            self._last_emitted = None     # a calm tick re-arms the
            #                               one-record-per-stretch latch
            return
        now = self._now()
        action = decision["action"]
        # cooldown hysteresis (min_floor heals regardless)
        if (decision["reason"] != "min_floor"
                and self._last_action_t is not None
                and cfg.scale_cooldown > 0
                and now - self._last_action_t < cfg.scale_cooldown):
            reg.counter("fleet.scale.blocked_cooldown").inc()
            self._emit(decision, n_live, blocked="cooldown")
            return
        if action == "down":
            for _ in decision.get("warmth_skipped", ()):
                reg.counter("fleet.scale.blocked_warmth").inc()
            if decision.get("replica") is None:
                # every candidate protected or not-idle: the guard
                # held the whole action
                self._emit(decision, n_live, blocked="warmth"
                           if decision.get("warmth_skipped")
                           else "no_idle_victim")
                return
            if not cfg.scale_dry_run:
                self._retire(decision["replica"])
            reg.counter("fleet.scale.downs").inc()
            self._done(decision, n_live, n_live - 1, now)
            return
        # action == "up"
        target = min(n_live + 1, cfg.scale_max)
        name = None
        if not cfg.scale_dry_run:
            if self._spawn_fn is None:
                self._emit(decision, n_live, blocked="no_pool")
                return
            name = self._next_name()
            handle = self._spawn_fn(name)
            gw.adopt_replica(handle)
        reg.counter("fleet.scale.ups").inc()
        self._done(dict(decision, replica=name), n_live, target, now)

    def _retire(self, name: str) -> None:
        """Lossless scale-down: mark the handle retired (the prober
        will not respawn its expected exit) and preempt-drain it —
        the victim parks + ships, the dispatcher resumes its jobs on
        the survivors."""
        handle = self._gw.replicas.get(name)
        if handle is not None:
            handle.retired = True
        self._gw.preempt_replica(name)

    def _next_name(self) -> str:
        taken = {h.name for h in self._gw.replicas.all()}
        while f"s{self._spawn_seq}" in taken:
            self._spawn_seq += 1
        name = f"s{self._spawn_seq}"
        self._spawn_seq += 1
        return name

    def _done(self, decision, live, target, now) -> None:
        self._last_action_t = now
        self._last_emitted = None
        reg = self._gw.registry
        reg.gauge("fleet.scale.replicas_target").set(float(target))
        # re-publish live AFTER the actuation: an adoption/retire this
        # tick is visible on the gauge this tick
        reg.gauge("fleet.scale.replicas_live").set(
            float(len(self._live())))
        flight = getattr(self._gw, "flight", None)
        if flight is not None and not self._cfg.scale_dry_run:
            try:
                # a scale action is an incident-bundle trigger peer of
                # failover/burn: a retire pulls the victim's final
                # bundle into the stitched record (enqueue only — the
                # pull runs on the RECORDER thread)
                peers = ([decision["replica"]]
                         if decision["action"] == "down"
                         and decision.get("replica") else [])
                flight.trigger(
                    f"scale_{decision['action']}", peers=peers)
            except Exception:
                pass
        self._emit(decision, live, target=target, acted=True)

    # -- the decision log ------------------------------------------------

    def _emit(self, decision, live, blocked=None, target=None,
              acted=False) -> None:
        """One scaleEntry on the gateway log (via the gw_writer
        isolation guard — a dead log writer never stalls scaling).
        Actions always emit; a sustained BLOCK emits once per stretch
        (the latch re-arms on any action or calm tick), so a 1 Hz
        scaler inside a 60 s cooldown writes one record, not sixty."""
        key = (decision["action"], decision["reason"], blocked)
        if not acted:
            if key == self._last_emitted:
                return
            self._last_emitted = key
        gw = self._gw
        extra = {"live": int(live),
                 "dry_run": bool(self._cfg.scale_dry_run)}
        if target is not None:
            extra["target"] = int(target)
        if blocked is not None:
            extra["blocked"] = blocked
        if decision.get("replica") is not None:
            extra["replica"] = decision["replica"]
        if decision.get("evidence"):
            extra["evidence"] = decision["evidence"]
        gw._rec(jsonl.scale_entry, gw.writer, decision["action"],
                decision["reason"], ts=gw.tracer.now(), **extra)


# ---------------------------------------------------------------- report


def summarize_entries(records) -> str:
    """The `tt scale` / `tt stats == scale` report over scaleEntry
    records: the decision log with its sustained-window evidence,
    plus action/block tallies."""
    entries = [r["scaleEntry"] for r in records if "scaleEntry" in r]
    if not entries:
        return "== scale: no scaleEntry records"
    lines = [f"== scale decisions ({len(entries)} records)"]
    tallies: dict = {}
    for e in entries:
        kind = (f"blocked_{e['blocked']}" if e.get("blocked")
                else e.get("action", "?"))
        tallies[kind] = tallies.get(kind, 0) + 1
        ts = e.get("ts")
        head = f"  {ts:.1f}s" if isinstance(ts, (int, float)) else "  -"
        what = (f"{e.get('action')} ({e.get('reason')})"
                + (f" BLOCKED:{e['blocked']}" if e.get("blocked")
                   else ""))
        parts = [head, what]
        if e.get("replica"):
            sign = "-" if e.get("action") == "down" else "+"
            parts.append(f"{sign}{e['replica']}")
        if e.get("live") is not None:
            tgt = (f"->{e['target']}" if e.get("target") is not None
                   else "")
            parts.append(f"live {e['live']}{tgt}")
        if e.get("dry_run"):
            parts.append("[dry-run]")
        lines.append(" ".join(parts))
        for line in _evidence_lines(e.get("evidence") or {}):
            lines.append("      " + line)
    lines.append("  " + "  ".join(f"{k}:{v}"
                                  for k, v in sorted(tallies.items())))
    return "\n".join(lines)


def _evidence_lines(ev: dict) -> list:
    """Render one decision's evidence dict: the window queries that
    justified it, one per line."""
    out = []
    for name, v in sorted(ev.items()):
        if name == "demand_flops_per_s" and isinstance(v, dict):
            flat = " ".join(f"{t}:{r:g}" for t, r in sorted(v.items()))
            out.append(f"demand flop/s: {flat}")
        elif name == "replicas" and isinstance(v, dict):
            def _res(d):
                rg = d.get("resident_groups")
                if rg is None:
                    return ""
                if rg == 0:
                    return ", cold"
                rb = d.get("resident_bytes")
                return (f", {rg:g} resident"
                        + (f" ({rb:g}B)" if rb is not None else ""))
            flat = " ".join(
                f"{n}(inflight {d.get('inflight', 0)}, "
                f"mean backlog "
                f"{d.get('backlog_mean') if d.get('backlog_mean') is not None else '?'}"
                f"{', idle' if d.get('idle') else ''}{_res(d)})"
                for n, d in sorted(v.items()))
            out.append(f"victims considered: {flat}")
        elif name == "warmth_skipped" and isinstance(v, dict):
            flat = "; ".join(f"{n} sole-warm for {b}"
                             for n, b in sorted(v.items()))
            out.append(f"warmth guard: {flat}")
        elif isinstance(v, dict) and "op" in v:
            mean = (f", window mean {v['mean']:g}"
                    if isinstance(v.get("mean"), (int, float))
                    else "")
            out.append(f"{name} {v['op']} {v['threshold']:g} "
                       f"sustained {v['for_s']:g}s{mean}")
        elif isinstance(v, dict) and "rate_per_s" in v:
            out.append(f"{name} rate {v['rate_per_s']:g}/s >= "
                       f"{v['threshold']:g} over {v['window_s']:g}s")
        else:
            out.append(f"{name}: {v}")
    return out


def main_scale(argv) -> int:
    """`tt scale <gateway.jsonl> [more.jsonl ...]` — render the
    autoscaler's decision log (stdlib, no torch, like tt stats)."""
    inputs = []
    as_json = False
    for a in argv:
        if a in ("-h", "--help"):
            print("usage: tt scale <gateway.jsonl> [more.jsonl ...] "
                  "[--json]\n\n"
                  "summarize the tt-scale decision log: every "
                  "scaleEntry with the sustained-window evidence that "
                  "justified it (spawn triggers, idle guards, warmth "
                  "blocks, cooldown holds), plus action tallies")
            return 0
        if a == "--json":
            as_json = True
        elif a.startswith("-"):
            raise SystemExit(f"unknown argument: {a}")
        else:
            inputs.append(a)
    if not inputs:
        raise SystemExit("usage: tt scale <gateway.jsonl> "
                         "[more.jsonl ...] [--json]")
    records = []
    for path in inputs:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue        # torn tail line of a live log
    if as_json:
        print(json.dumps([r["scaleEntry"] for r in records
                          if "scaleEntry" in r], indent=2))
        return 0
    print(summarize_entries(records))
    return 0


if __name__ == "__main__":
    sys.exit(main_scale(sys.argv[1:]))
