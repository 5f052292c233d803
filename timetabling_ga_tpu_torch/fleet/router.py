"""The bucket-affine router (port of timetabling_ga_tpu/fleet/router.py,
under the same names): send each job to the replica where its bucket is
already warm.

A replica's warm asset is its per-bucket state: the first call of a lane
program at a bucket's shapes (the port's "compile", obs/cost.py:
`compile.count`; later calls count `compile.cache_hits`) pays the
kernels' load and the bucket's first placements, and a warm bucket serves
any instance of that bucket without them (serve/bucket.py). A router that
sprays jobs round-robin pays that on every replica for every bucket; a
bucket-affine router pays it once a bucket fleet-wide.

Routing inputs, all refreshed by the ReplicaSet's probe thread
(fleet/replicas.py), never fetched on the routing path itself:

  /readyz      the structured reasons (`backlog_full`, `near_hbm_limit`,
               `stalled`, `draining`, ...): a not-ready replica keeps
               its pins but takes no new work while a reason is up,
               unless every live replica is not ready, when the least
               loaded one is used anyway (admission downstream is the
               real gate);
  backlog      the `serve.queue_depth` gauge scraped from /metrics, the
               load part of the placement score;
  compile-hit  `compile.{count,cache_hits}` from /metrics: a bucket
               placed fresh prefers the replica whose calls are mostly
               warm.

Each routing is one of three outcomes:

  hit      the chosen replica is already warm for the bucket;
  warm     the bucket's first landing anywhere in the fleet (excluded
           from the rate);
  miss     a cold landing of a bucket the fleet already served: the job
           detoured off its warm home (not ready, failover exclusion)
           or the pin moved after a death. A detour never moves the
           pin: the bucket returns home once it probes ready again.

`hit_rate()` = hits / (hits + misses), the affinity the acceptance test
holds at >= 0.9 after warm-up on a stable fleet.

Stdlib only, single-threaded by design: only the gateway's dispatcher
thread calls `route`, the same thread that handles failover.
"""

from __future__ import annotations

from timetabling_ga_tpu_torch.runtime import faults


class NoReplicaError(RuntimeError):
    """No live replica can take the job (all dead or excluded)."""


class Router:
    """Bucket -> replica placement with affinity, scoring and failover.

    `registry` (optional, the gateway's MetricsRegistry) receives the
    routing counters `fleet.route.{hit,warm,miss}` and
    `fleet.route.repins`, so `/v1/fleet`'s affinity numbers are also on
    `/metrics`. `last_decision` holds the latest placement's score inputs
    (outcome, backlog, pin count, compile-hit rate); the gateway reads it
    right after `route()`, on the same thread, for its routeEntry."""

    def __init__(self, replica_set, registry=None):
        self._set = replica_set
        self._metrics = registry
        self._pins: dict = {}        # bucket -> replica name
        self._warm: dict = {}        # replica name -> set of buckets
        self._seen: set = set()      # buckets routed at least once
        self.pin_counts: dict = {}   # replica name -> pinned buckets
        #                              (kept at every pin move, so the
        #                              `pins` gauge is one dict read)
        self.last_decision: dict = {}
        self.routed = 0
        self.hits = 0
        self.warmups = 0
        self.misses = 0
        self.repins = 0              # pin moved (home left the live
        #                              set); a detour is a miss, never
        #                              a repin

    # -- the decision ---------------------------------------------------

    def route(self, bucket: tuple, exclude: tuple = ()):
        """Pick the replica for one job of `bucket`. Deterministic given
        the probe state; raises NoReplicaError when nothing live remains.
        `exclude` names replicas this job already failed on."""
        # the `route` fault site: an injected hang or die parks or ends
        # the gateway's dispatcher thread only
        faults.maybe_fail("route")
        live = [h for h in self._set.live() if h.name not in exclude]
        if not live:
            raise NoReplicaError(
                f"no live replica for bucket {bucket} "
                f"(excluded: {list(exclude)})")
        ready = [h for h in live if h.ready]
        pool = ready or live     # a degraded fleet: least-bad placement
        pinned = self._pins.get(bucket)
        if pinned is not None:
            handle = next((h for h in pool if h.name == pinned), None)
            if handle is not None:
                return self._account(bucket, handle)
            # the home is unusable now. While it is still live (not
            # ready, or excluded for this job) the job detours and the
            # pin stays; only a home gone from the live set moves it
            fallback = min(pool, key=self._score)
            if not any(h.name == pinned
                       for h in self._set.live()):
                self._set_pin(bucket, fallback.name)
                self.repins += 1
                if self._metrics is not None:
                    self._metrics.counter("fleet.route.repins").inc()
            return self._account(bucket, fallback)
        handle = min(pool, key=self._score)
        self._set_pin(bucket, handle.name)
        return self._account(bucket, handle)

    def _set_pin(self, bucket: tuple, name: str) -> None:
        old = self._pins.get(bucket)
        if old == name:
            return
        if old is not None:
            self.pin_counts[old] = max(0, self.pin_counts.get(old, 1)
                                       - 1)
        self._pins[bucket] = name
        self.pin_counts[name] = self.pin_counts.get(name, 0) + 1

    def _account(self, bucket: tuple, handle):
        """One placement's outcome (hit / warm / miss), its counter and
        the `last_decision` snapshot."""
        warm = bucket in self._warm.setdefault(handle.name, set())
        self.routed += 1
        if warm:
            outcome = "hit"
            self.hits += 1
        elif bucket in self._seen:
            outcome = "miss"
            self.misses += 1
            self._warm[handle.name].add(bucket)
        else:
            outcome = "warm"
            self.warmups += 1
            self._warm[handle.name].add(bucket)
        self._seen.add(bucket)
        if self._metrics is not None:
            self._metrics.counter(f"fleet.route.{outcome}").inc()
        self.last_decision = {
            "outcome": outcome, "replica": handle.name,
            "backlog": handle.queue_depth,
            "pins": self.pin_counts.get(handle.name, 0),
            "compile_hit_rate": round(handle.compile_hit_rate(), 4)}
        return handle

    def _score(self, handle) -> tuple:
        """The score of a replica for a bucket with no usable pin: fewest
        queued jobs, then fewest pinned buckets (spreads fresh buckets
        before the load gauges move), then the highest compile-hit rate,
        then the name."""
        depth = handle.queue_depth
        if depth is None or depth != depth:
            depth = 0.0
        pinned_here = sum(1 for r in self._pins.values()
                          if r == handle.name)
        return (depth, pinned_here, -handle.compile_hit_rate(),
                handle.name)

    # -- failover hooks -------------------------------------------------

    def on_replica_dead(self, name: str) -> None:
        """Forget a dead replica: its pins move on their next routing
        (counted as repins) and its warm set is gone (a restarted
        process starts cold)."""
        self._warm.pop(name, None)
        for bucket in [b for b, r in self._pins.items() if r == name]:
            del self._pins[bucket]
        self.pin_counts[name] = 0

    def sole_warm_owner(self, bucket: tuple, live_names) -> str | None:
        """The one live replica warm for `bucket`, or None when none or
        several are: the autoscaler's warmth guard never retires a hot
        bucket's only warm home. Dispatcher thread only."""
        owners = [n for n in live_names
                  if bucket in self._warm.get(n, ())]
        return owners[0] if len(owners) == 1 else None

    # -- accounting -----------------------------------------------------

    def hit_rate(self) -> float:
        """Of the routings that could have landed warm (all but each
        bucket's first), the fraction that did."""
        eligible = self.hits + self.misses
        return self.hits / eligible if eligible > 0 else 1.0

    def stats(self) -> dict:
        return {"routed": self.routed, "affinity_hits": self.hits,
                "warmups": self.warmups, "misses": self.misses,
                "repins": self.repins,
                "affinity_hit_rate": round(self.hit_rate(), 4),
                "pins": {str(list(b)): r
                         for b, r in sorted(self._pins.items())}}
