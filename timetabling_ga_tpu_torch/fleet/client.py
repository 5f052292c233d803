"""The `submit` solve client (port of timetabling_ga_tpu/fleet/
client.py, under the same names).

It POSTs one `.tim` instance to a gateway (or straight to a replica: the
same protocol), polls the job to its end and prints the final state as
JSON on stdout:

    python -m timetabling_ga_tpu_torch submit http://127.0.0.1:8070 \
        comp01.tim -s 42 --generations 200 --priority 5
    ... --no-wait                 just the job id
    ... --records                 with the record tail
    ... --records-out job.jsonl   the record tail as JSONL lines, the
                                  stream an unrouted solve writes
                                  (`stats job.jsonl`, `trace --job ID
                                  job.jsonl gateway.jsonl`)

Standard library only (urllib + json): it runs on any machine that
reaches the fleet, with no torch. Exit status: 0 when the job ends
`done`, 1 for any other terminal state, 2 for usage and transport
errors.
"""

from __future__ import annotations

import json
import sys
import time

from timetabling_ga_tpu_torch.fleet.gateway import TERMINAL
from timetabling_ga_tpu_torch.fleet.replicas import (
    FleetHTTPError, http_json)

_USAGE = """\
usage: python -m timetabling_ga_tpu_torch submit URL INSTANCE.tim [flags]

submit one instance to a fleet gateway (or a single replica) and wait:
  --id <str>            job id (default: server-assigned)
  --tenant <str>        tenant tag for usage metering: every share of
                        fleet capacity the job consumes is attributed
                        to this tag (`usage URL` reports it)
  --priority <int>      scheduling priority (higher first)
  -s <int>              seed
  --generations <int>   generation budget
  --deadline <float>    wall-clock deadline, seconds
  --poll <float>        poll interval, seconds (default 0.5)
  --timeout <float>     give up after this many seconds (default 3600)
  --records             print the job-tagged record tail too
  --records-out <path>  write the record tail as JSONL lines to this
                        file (stats / trace input)
  --snapshot <path>     warm-start the job from a wire snapshot JSON
                        file (serve/snapshot.py): the job resumes at
                        the snapshot's progress instead of generation
                        0; the file is a GET /v1/jobs/<id>?snapshot=1
                        view's "snapshot" object, or the object itself
                        (with --edit-of it is the BASE job's snapshot
                        to transplant from instead of the gateway's
                        cached/fetched one)
  --edit-of <job id>    incremental re-solve: submit INSTANCE.tim as an
                        EDIT of the named base job — the gateway
                        resolves the base instance and its freshest
                        snapshot, the replica diffs the two,
                        transplants the base population onto the
                        edited instance, and solves under the
                        anchored objective; the result carries
                        `edit_distance` (events moved vs the base
                        solution)
  --edit-ops <path>     JSON op list (the serve/editsolve.py grammar:
                        add_event / remove_event / set_attendance /
                        set_event_features / set_room_size /
                        set_room_features) applied to the base
                        instead of a full edited instance — INSTANCE
                        may then be '-'
  --anchor-weight <int> soft penalty per carried event placed away
                        from the base solution's slot (default 1;
                        0 = solve the plain objective, bit-identical
                        to an unanchored stream)
  --no-wait             print the job id and exit without polling
  -h, --help            show this message and exit"""


def submit_and_wait(url: str, payload: dict, poll: float = 0.5,
                    timeout: float = 3600.0, wait: bool = True):
    """POST /v1/solve then poll GET /v1/jobs/<id> until terminal.
    Returns the final job view (or the accept reply when not
    waiting). Raises FleetHTTPError/OSError on transport failure and
    TimeoutError when the budget runs out."""
    url = url.rstrip("/")
    accepted = http_json("POST", url + "/v1/solve", payload,
                         ok=(200, 202))
    if not wait:
        return accepted
    job_id = accepted["id"]
    deadline = time.monotonic() + timeout
    from urllib.parse import quote
    while True:
        # steady-state polls are STATE-ONLY (the record tail is the
        # expensive part of the view — same discipline as the
        # gateway's dispatcher); the full view is fetched once, at
        # terminal
        view = http_json(
            "GET", f"{url}/v1/jobs/{quote(job_id)}?records=0",
            ok=(200,))
        if view.get("state") in TERMINAL:
            return http_json(
                "GET", f"{url}/v1/jobs/{quote(job_id)}", ok=(200,))
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"job {job_id} still {view.get('state')!r} after "
                f"{timeout:.0f}s")
        time.sleep(poll)


def main_submit(argv) -> int:
    """The `submit` entry point (cli.py dispatches here)."""
    args = list(argv)
    if not args or args[0] in ("-h", "--help"):
        print(_USAGE)
        return 0
    if len(args) < 2:
        print(_USAGE, file=sys.stderr)
        return 2
    url, instance = args[0], args[1]
    rest = args[2:]
    payload: dict = {}
    poll, timeout = 0.5, 3600.0
    wait = True
    records = False
    records_out = None
    i = 0
    flag_types = {"--id": ("id", str), "--priority": ("priority", int),
                  "--tenant": ("tenant", str),
                  "-s": ("seed", int),
                  "--generations": ("generations", int),
                  "--deadline": ("deadline", float)}
    edit_of = None
    edit_ops = None
    anchor_w = None
    while i < len(rest):
        a = rest[i]
        if a in ("-h", "--help"):
            print(_USAGE)
            return 0
        if a == "--records":
            records = True
            i += 1
            continue
        if a == "--records-out":
            if i + 1 >= len(rest):
                print("flag --records-out needs a value",
                      file=sys.stderr)
                return 2
            records_out = rest[i + 1]
            i += 2
            continue
        if a == "--snapshot":
            if i + 1 >= len(rest):
                print("flag --snapshot needs a value",
                      file=sys.stderr)
                return 2
            try:
                with open(rest[i + 1], "r", encoding="utf-8") as fh:
                    snap = json.load(fh)
            except (OSError, ValueError) as e:
                print(f"tt submit: bad snapshot file: {e}",
                      file=sys.stderr)
                return 2
            # accept either the bare wire object or a saved
            # ?snapshot=1 job view wrapping one
            if isinstance(snap, dict) and "snapshot" in snap \
                    and "npz" not in snap:
                snap = snap["snapshot"]
            payload["snapshot"] = snap
            i += 2
            continue
        if a == "--edit-of":
            if i + 1 >= len(rest):
                print("flag --edit-of needs a value", file=sys.stderr)
                return 2
            edit_of = rest[i + 1]
            i += 2
            continue
        if a == "--edit-ops":
            if i + 1 >= len(rest):
                print("flag --edit-ops needs a value",
                      file=sys.stderr)
                return 2
            try:
                with open(rest[i + 1], "r", encoding="utf-8") as fh:
                    ops = json.load(fh)
            except (OSError, ValueError) as e:
                print(f"tt submit: bad edit-ops file: {e}",
                      file=sys.stderr)
                return 2
            # accept the bare op list or an {"ops": [...]} wrapper
            if isinstance(ops, dict) and "ops" in ops:
                ops = ops["ops"]
            edit_ops = ops
            i += 2
            continue
        if a == "--anchor-weight":
            if i + 1 >= len(rest):
                print("flag --anchor-weight needs a value",
                      file=sys.stderr)
                return 2
            try:
                anchor_w = int(rest[i + 1])
            except ValueError:
                print(f"flag --anchor-weight wants int, got "
                      f"{rest[i + 1]!r}", file=sys.stderr)
                return 2
            i += 2
            continue
        if a == "--no-wait":
            wait = False
            i += 1
            continue
        if a in ("--poll", "--timeout"):
            if i + 1 >= len(rest):
                print(f"flag {a} needs a value", file=sys.stderr)
                return 2
            try:
                if a == "--poll":
                    poll = float(rest[i + 1])
                else:
                    timeout = float(rest[i + 1])
            except ValueError:
                print(f"flag {a} wants a number, got "
                      f"{rest[i + 1]!r}", file=sys.stderr)
                return 2
            i += 2
            continue
        if a not in flag_types:
            print(f"unknown flag: {a}", file=sys.stderr)
            return 2
        if i + 1 >= len(rest):
            print(f"flag {a} needs a value", file=sys.stderr)
            return 2
        key, typ = flag_types[a]
        try:
            payload[key] = typ(rest[i + 1])
        except ValueError:
            # usage errors share the transport-error contract: one
            # line on stderr, status 2, never a traceback
            print(f"flag {a} wants {typ.__name__}, got "
                  f"{rest[i + 1]!r}", file=sys.stderr)
            return 2
        i += 2
    if edit_ops is not None and edit_of is None:
        print("--edit-ops needs --edit-of", file=sys.stderr)
        return 2
    try:
        tim_text = None
        if instance != "-":
            with open(instance, "r") as fh:
                tim_text = fh.read()
        if edit_of is not None:
            edit: dict = {"base": edit_of}
            if edit_ops is not None:
                edit["ops"] = edit_ops
            elif tim_text is not None:
                edit["edited"] = {"tim": tim_text}
            else:
                print("tt submit: --edit-of needs an edited "
                      "INSTANCE.tim or --edit-ops", file=sys.stderr)
                return 2
            if anchor_w is not None:
                edit["w_anchor"] = anchor_w
            if "snapshot" in payload:
                # with --edit-of the snapshot file is the BASE job's
                # wire to transplant from, not this job's own resume
                edit["snapshot"] = payload.pop("snapshot")
            payload["edit"] = edit
        elif tim_text is not None:
            payload["tim"] = tim_text
        else:
            print("tt submit: INSTANCE '-' needs --edit-of with "
                  "--edit-ops", file=sys.stderr)
            return 2
        view = submit_and_wait(url, payload, poll=poll,
                               timeout=timeout, wait=wait)
    except (FleetHTTPError, OSError, TimeoutError) as e:
        # a missing instance file and a dead gateway exit the same
        # way: status 2 with one line, never a traceback
        print(f"tt submit: {e}", file=sys.stderr)
        return 2
    if not wait:
        print(json.dumps(view))
        return 0
    if records_out is not None:
        # the record tail as a JSONL stream, laid out as an unrouted
        # solve's -o file, so stats and trace (the stitched fleet
        # timeline too) read it directly
        try:
            with open(records_out, "w", encoding="utf-8") as fh:
                for rec in view.get("records") or []:
                    fh.write(json.dumps(rec, separators=(",", ":"))
                             + "\n")
        except OSError as e:
            print(f"tt submit: {e}", file=sys.stderr)
            return 2
    if not records:
        view = {k: v for k, v in view.items() if k != "records"}
    print(json.dumps(view))
    return 0 if view.get("state") == "done" else 1
