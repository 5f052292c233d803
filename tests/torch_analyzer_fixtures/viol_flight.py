"""TT606 fixture: bundle serialization off the recorder thread.

Not imported or executed — parsed by tests/test_torch_analysis.py (the
test config adds this file to `dispatch_modules`). Bundle
serialization and file I/O run on the recorder thread only: never in
device programs or dispatch loops, and never from an HTTP handler,
which reads the in-memory `latest()` / `window()` state.
"""
import http.server
import json


def program(name, fn):
    return fn


def dispatch_loop(chunks, runner, state):
    for chunk in chunks:
        state = runner(state, chunk)
        blob = json.dumps({"state": 1})              # EXPECT TT606
        with open("bundle.json", "w") as fh:         # EXPECT TT606
            fh.write(blob)
    return state


def device_dump(x):
    json.dumps({"x": 1})                             # EXPECT TT606
    return x * 2


def driver(x):
    return program("dump", device_dump)(x)


class FlightHandler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        core = self.server.flight.dump()             # EXPECT TT606
        self.server.flight.trigger("manual")         # EXPECT TT606
        self._write_bundle(core)

    def _write_bundle(self, core):
        json.dump(core, self.wfile)                  # EXPECT TT606

    def do_HEAD(self):
        # OK: the in-memory copy
        core = self.server.flight.latest()
        window = self.server.history.window(30.0)
        self.wfile.write(str((core, window)).encode())


def recorder_thread_is_fine(recorder, core):
    # OK: the recorder thread's dump body
    with open("incident.json", "w") as fh:
        json.dump(core, fh)
    recorder.trigger("manual")
