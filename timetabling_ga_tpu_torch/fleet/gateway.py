"""The fleet's `/v1` solve protocol (port of timetabling_ga_tpu/fleet/
gateway.py:124-432, under the same names): the request router and the
payload parsing that a gateway and every replica front share, so that a
router can treat a replica as a one-member fleet.

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
                        or at --preempt-grace).
  GET    /v1/fleet /v1/incident /v1/usage   the fleet view (a gateway's;
                        a replica answers 404), the newest incident
                        bundle, the usage ledger.
  GET    /metrics /healthz /readyz ...   the pull front (obs/http.py),
                        on the same port.

Handlers enqueue and read only: a POST validates cheap text (the `.tim`
header), puts a command in the owner's inbox and returns; a GET reads
cached or queue state. Every body read is bounded by Content-Length and
MAX_BODY. No handler does outbound I/O or touches the card: the
owner's one drive thread does.

The gateway itself (GatewayJob, GatewayApi, Gateway, the router and
main_fleet) is not ported yet: the `fleet` and `submit` subcommands stop
the parse by name. This module is the protocol half, and imports only
the standard library and the port's obs/http.py, so a client of it
loads no torch.
"""

from __future__ import annotations

import json
import urllib.parse

from timetabling_ga_tpu_torch.obs import http as obs_http

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
