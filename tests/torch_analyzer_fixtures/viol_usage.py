"""TT607 fixture: usage-ledger mutation / wall-clock metering off its
home threads.

Not imported or executed — parsed by tests/test_torch_analysis.py. The
ledger is fed from the scheduler's park fence and folded on its own
thread; handlers (and *Api surfaces) only READ the meter.
"""
import http.server
import time

import torch


def program(name, fn):
    return fn


def device_meter(x, ledger):
    ledger.dispatch({"gens": 1})                     # EXPECT TT607
    return x * 2


def driver(x, ledger, usage, xs):
    program("meter", device_meter)(x, ledger)
    return torch.vmap(lambda v: usage.final("j", "t", {}) or v)(xs)  # EXPECT TT607


class UsageHandler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        t0 = time.monotonic()                        # EXPECT TT607
        self.server.usage.job("j1", "acme")          # EXPECT TT607
        self._meter(t0)

    def _meter(self, t0):
        dt = time.perf_counter() - t0                # EXPECT TT607
        self.server.ledger.final("j1", "acme", {"s": dt})  # EXPECT TT607

    def do_HEAD(self):
        # OK: reading the meter
        self.wfile.write(str(self.server.usage.totals()).encode())


class MeterApi:
    def usage_view(self):
        return 200, {"tenants": self._ledger.totals()}   # OK: read

    def accept_solve(self, payload):
        self._ledger.job(payload["id"], payload["tenant"])  # EXPECT TT607
        return 202, {"id": payload["id"]}


def drive_loop_fence_is_fine(ledger, now):
    # OK: the park fence is the sanctioned feed point
    t0 = now()
    ledger.dispatch({"gens": 5, "lanes": []})
    ledger.final("j", "t", {"queue_seconds": now() - t0})
