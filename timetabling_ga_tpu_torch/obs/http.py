"""The pull front: an opt-in HTTP listener on a daemon thread (port of
timetabling_ga_tpu/obs/http.py, under the same names).

`--obs-listen HOST:PORT` (RunConfig and ServeConfig) starts a stdlib
`http.server` serving:

  /metrics   OpenMetrics 1.0 text from the process MetricsRegistry
             (obs/metrics.py), with histogram exemplars: the latest
             `serve.job_seconds` / `engine.dispatch_seconds`
             observation per bucket carries its `job=` / `dispatch=`
             label
  /healthz   process and writer-thread liveness (the `probes` dict the
             owner registers; 503 when any probe fails)
  /readyz    readiness from registry state alone (`readiness`: queue
             depth against the admission bound, the fault supervisor's
             ladder, the recovery budget, the memory poller's
             near-HBM fraction, the stall detector, a drain); its
             reason strings are a wire contract
  /metrics/history   the history ring (obs/history.py) as JSON,
             `?window=S` bounded; 404 with no ring
  /profile   the on-demand capture trigger (obs/cost.py
             ProfileCapture; `profile` is the client): `?for=N` answers
             the trigger's ack, 200 or 409 while one is active;
             `?last=1` the newest capture's attribution (obs/prof.py);
             404 where no capture is wired

Handlers only READ: registry snapshots and expositions, never a counter
bump or a gauge write (/profile's trigger is a state flip and a worker
wake, the capture runs on its own thread), so a scrape changes no
number another consumer reads; they do no blocking I/O beyond their own
socket. The server is a
`ThreadingHTTPServer` with daemon threads and `block_on_close=False`:
a hung handler (the `scrape` fault site's `hang`) parks its own thread
and nothing else. The listener writes no records, so the JSONL stream
is the same with it on or off.

Stdlib only at import (obs/cost.py imports torch only inside its stats
function).
"""

from __future__ import annotations

import http.server
import json
import threading

from timetabling_ga_tpu_torch.obs import cost as obs_cost
from timetabling_ga_tpu_torch.obs import metrics as obs_metrics
from timetabling_ga_tpu_torch.runtime import faults

OPENMETRICS_CT = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def parse_listen(spec: str) -> tuple[str, int]:
    """'HOST:PORT' -> (host, port); port 0 binds an ephemeral port
    (tests/bench). Raises ValueError on anything else."""
    host, sep, port_s = str(spec).rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"listen spec wants HOST:PORT, got {spec!r}")
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(
            f"listen port must be an integer, got {port_s!r}"
        ) from None
    if not 0 <= port <= 65535:
        raise ValueError(f"listen port out of range: {port}")
    return host, port


def readiness(registry) -> tuple[bool, dict]:
    """Readiness decision from registry state ALONE (read-only: one
    snapshot). Not ready when any of:

      - `serve.queue_depth` >= `serve.backlog` (admission would reject
        — new work should be routed to another replica);
      - `engine.degrade_level` >= 2 (the fault supervisor's ladder is
        past 'serial': the process is shrinking dispatches to survive;
        the ladder also steps back UP after a clean stretch —
        engine._Supervisor.maybe_relax — so this reason CLEARS live,
        it is not a one-way trip);
      - `engine.recovery_budget_remaining` <= 0 while recovery was
        configured (the next transient failure aborts the run);
      - `device.mem_frac_used` >= obs/cost.py NEAR_HBM_FRAC (the cost
        observatory's memory poller says the next placement is an OOM
        gamble — route new work elsewhere until the pressure clears);
      - `engine.stalled` >= 1 (the search-quality observatory's stall
        detector: the run has plateaued with a collapsed population —
        obs/quality.py StallDetector; the gauge clears when a new best
        lands or the auto-kick fires, so the reason is live, not a
        one-way trip);
      - `serve.draining` >= 1 (a fleet drain is in flight — the
        replica finishes its parked jobs but admits nothing new, so
        the router must stop sending work; fleet/replicas.py sets the
        gauge from the drive loop when a `/v1/drain` lands);
      - gateway-only (fleet/gateway.py, tt-obs v5): `no_ready_replica`
        (zero ready replicas behind the front), `dispatcher_stalled`
        (the dispatcher's tick age exceeded `--stall-after` — it
        accepts jobs it will never place) and `slo_burn` (the
        `--slo-p99` rolling-window latency monitor is over its bound)
        — the gateway answers the SAME pinned contract as replicas,
        so HA stacks and meta-gateways route around it identically.

    Absent gauges (an engine run has no serve queue; a serve process
    may never have set the ladder; no memory poller on CPU) are simply
    not conditions.

    The body is structured JSON (content-type application/json):
    `{"ready": bool, "reasons": [...], ...}` with one context key per
    condition — the fleet router (fleet/router.py) PARSES the reasons
    (`near_hbm_limit`, `stalled`, `draining`, ...) rather than
    scraping text, so the reason strings here are a wire contract
    (tests/test_fleet.py pins body shape and content type)."""
    gauges = registry.snapshot().get("gauges", {})
    reasons = []
    depth = gauges.get("serve.queue_depth")
    bound = gauges.get("serve.backlog")
    if depth is not None and bound is not None and bound > 0 \
            and depth >= bound:
        reasons.append("backlog_full")
    level = gauges.get("engine.degrade_level")
    if level is not None and level >= 2:
        reasons.append("degraded")
    budget = gauges.get("engine.recovery_budget_remaining")
    if budget is not None and budget <= 0 and gauges.get(
            "engine.recovery_budget_configured", 0) > 0:
        reasons.append("recovery_exhausted")
    mem_frac = gauges.get("device.mem_frac_used")
    if mem_frac is not None and mem_frac >= obs_cost.NEAR_HBM_FRAC:
        reasons.append("near_hbm_limit")
    stalled = gauges.get("engine.stalled")
    if stalled is not None and stalled >= 1:
        reasons.append("stalled")
    draining = gauges.get("serve.draining")
    if draining is not None and draining >= 1:
        reasons.append("draining")
    # gateway-only gauge (fleet/gateway.py binds it to the replica
    # set): a fleet front with zero ready replicas can accept work but
    # not place it — upstream load balancers should know
    fleet_ready = gauges.get("fleet.replicas_ready")
    if fleet_ready is not None and fleet_ready < 1:
        reasons.append("no_ready_replica")
    # gateway dispatcher watchdog (fleet/gateway.py, tt-obs v5):
    # `fleet.tick_age_s` is a pull gauge over the dispatcher's last
    # loop tick, `fleet.tick_stall_after` the configured threshold
    # (--stall-after; 0/absent disables). A dead or wedged dispatcher
    # still ACCEPTS jobs it will never place — an HA stack must see
    # that on the same /readyz contract replicas answer.
    tick_age = gauges.get("fleet.tick_age_s")
    stall_after = gauges.get("fleet.tick_stall_after")
    if (tick_age is not None and stall_after is not None
            and stall_after > 0 and tick_age >= stall_after):
        reasons.append("dispatcher_stalled")
    # gateway SLO monitor (--slo-p99): the rolling-window p99 over
    # e2e job latencies is over its bound — stop sending latency-
    # sensitive traffic here until the burn clears (the gauge flips
    # back when the window's p99 recovers, so the reason is live)
    slo_burn = gauges.get("fleet.slo_burn")
    if slo_burn is not None and slo_burn >= 1:
        reasons.append("slo_burn")
    return not reasons, {"ready": not reasons, "reasons": reasons,
                         "queue_depth": depth, "backlog": bound,
                         "degrade_level": level,
                         "recovery_budget_remaining": budget,
                         "mem_frac_used": mem_frac,
                         "stalled": stalled,
                         "draining": draining}


class _Handler(http.server.BaseHTTPRequestHandler):
    """GET router for the endpoints. READ-ONLY over the registry:
    snapshots and expositions, never instrument touches."""

    # the default HTTPServer protocol closes per request; 1.1 lets a
    # scraper keep its connection
    protocol_version = "HTTP/1.1"

    def do_GET(self):  # noqa: N802 (http.server's naming)
        # fault-injection point (runtime/faults.py `scrape` site): a
        # `hang` parks THIS daemon handler thread only; `die`/`error`
        # abort this request — the serve/dispatch/writer paths never
        # block on any of it (tests pin that)
        try:
            faults.maybe_fail("scrape")
        except SystemExit:
            # `die`: this handler ends with no response — the client
            # sees a dropped connection, nothing else notices. Absorbed
            # here because a SystemExit escaping the handler thread
            # trips process-wide thread-excepthook machinery, which is
            # exactly the cross-thread coupling the listener must not
            # have.
            self.close_connection = True
            return
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            body = self.server.registry.to_openmetrics().encode()
            self._reply(200, body, OPENMETRICS_CT)
        elif path == "/metrics/history":
            # tt-flight (obs/history.py): the bounded per-series
            # sample rings as JSON — `?window=S` restricts to the last
            # S seconds. A pure read by construction: window() reads
            # the ring under ITS lock and never touches the registry
            # (the sampler thread owns the registry reads).
            ring = getattr(self.server, "history", None)
            if ring is None:
                self._reply_json(404, {"ok": False,
                                       "reason": "no history ring "
                                                 "wired "
                                                 "(--history-every)"})
                return
            params = dict(
                p.split("=", 1) for p in query.split("&") if "=" in p)
            window = None
            if "window" in params:
                try:
                    window = float(params["window"])
                except ValueError:
                    self._reply_json(400, {"ok": False,
                                           "reason": "window must be "
                                                     "seconds"})
                    return
            out = ring.window(window)
            if window is not None:
                out["window"] = window
            self._reply_json(200, out)
        elif path == "/profile":
            # the on-demand capture trigger (obs/cost.py ProfileCapture;
            # `profile` is the client): trigger() flips state and wakes
            # the capture worker — no blocking I/O here, no registry
            # touch; the profiler calls happen on the worker
            capture = getattr(self.server, "profile", None)
            if capture is None:
                self._reply_json(404, {"ok": False,
                                       "reason": "no profile capture "
                                                 "wired (--profile-dir"
                                                 "/--profile-for)"})
                return
            params = dict(
                p.split("=", 1) for p in query.split("&") if "=" in p)
            if params.get("last"):
                # the newest completed capture's attribution (the
                # capture worker ran obs/prof.capture_hook): a pure read
                last = capture.last()
                self._reply_json(200, {"ok": True, **last})
                return
            try:
                n = int(params.get("for", 1))
            except ValueError:
                self._reply_json(400, {"ok": False,
                                       "reason": "for must be an int"})
                return
            ack = capture.trigger(n)
            self._reply_json(200 if ack.get("ok") else 409, ack)
        elif path == "/healthz":
            probes = {}
            for name, fn in self.server.probes.items():
                try:
                    probes[name] = bool(fn())
                except Exception:
                    probes[name] = False
            ok = all(probes.values())
            self._reply_json(200 if ok else 503,
                             {"ok": ok, "probes": probes})
        elif path == "/readyz":
            ok, detail = readiness(self.server.registry)
            self._reply_json(200 if ok else 503, detail)
        else:
            self._reply_json(404, {"error": f"no route {path!r}"})

    def _reply(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, status: int, obj: dict) -> None:
        self._reply(status, json.dumps(obj).encode(),
                    "application/json")

    def log_message(self, fmt, *args):
        """Silence the default stderr access log: the run's stderr
        carries solver warnings, not scrape noise."""


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True      # a hung handler must not survive exit
    block_on_close = False     # ...nor block close() until it returns
    allow_reuse_address = True

    def handle_error(self, request, client_address):
        """Silence per-request tracebacks (the default prints to
        stderr): a failed scrape — including the `scrape` fault site's
        die/error actions — aborts its own request and nothing else;
        the run's stderr carries solver warnings, not scrape noise."""


class ObsServer:
    """The listener lifecycle: bind at construction (so the ephemeral
    port is known immediately), serve from a daemon thread after
    `start()`, stop on `close()`.

    `probes` maps name -> zero-arg callable for /healthz (the owner
    registers e.g. its AsyncWriter's worker liveness). `profile` is the
    ProfileCapture /profile triggers and polls (absent: 404). The
    registry defaults
    to THE process REGISTRY — the same numbers every other consumer
    sees. `history` is the ring /metrics/history serves (absent: 404);
    handlers only READ it, like the registry.

    The fleet fronts reuse this lifecycle with a handler of their own
    (JAX obs/http.py:334-356): `handler` swaps the request router (a
    `_Handler` subclass adding the `/v1` solve API, fleet/gateway.py
    ApiHandler), `api` is the enqueue-or-read-only object those handlers
    call, and `site` names the accept loop's thread (`tt-<site>`) and
    its fault site (`obs_listen` here; a replica front keeps it, the
    fleet gateway's is `gateway`)."""

    def __init__(self, listen: str, registry=None, probes=None,
                 profile=None, handler=None, api=None,
                 site: str = "obs_listen", history=None):
        host, port = parse_listen(listen)
        self._srv = _Server((host, port), handler or _Handler)
        self._srv.registry = (obs_metrics.REGISTRY if registry is None
                              else registry)
        self._srv.probes = dict(probes or {})
        self._srv.history = history
        self._srv.profile = profile
        self._srv.api = api
        self._site = site
        self._thread = threading.Thread(
            target=self._serve, name=f"tt-{site}", daemon=True)
        self._state_lock = threading.Lock()
        self._serving = False
        self._closed = False

    @property
    def address(self) -> tuple[str, int]:
        """(host, port) actually bound — port is resolved for ':0'."""
        return self._srv.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def _serve(self) -> None:
        # fault-injection point (`obs_listen`, or the owner's `site`): a
        # `die` here kills ONLY the accept loop — the process, and every
        # solve path, runs on untouched
        try:
            faults.maybe_fail(self._site)
        except SystemExit:
            self._srv.server_close()
            return
        # handshake with close() under the state lock: close() may only
        # call shutdown() once serve_forever is (about to be) running —
        # shutdown() waits on an event ONLY serve_forever sets, so a
        # never-started accept loop (hang/die injected above) would
        # deadlock it. And if close() already won the race and closed
        # the socket, entering serve_forever here would die with a
        # ValueError on the dead descriptor — exactly the cross-thread
        # stderr noise this module promises not to make.
        with self._state_lock:
            if self._closed:
                return
            self._serving = True
        self._srv.serve_forever(poll_interval=0.1)

    def start(self) -> "ObsServer":
        self._thread.start()
        return self

    def alive(self) -> bool:
        return self._thread.is_alive()

    def close(self) -> None:
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
            serving = self._serving
        if serving:
            try:
                self._srv.shutdown()
            except Exception:
                pass
        self._srv.server_close()
        if self._thread.ident is not None:   # never-started: no join
            self._thread.join(timeout=2.0)
