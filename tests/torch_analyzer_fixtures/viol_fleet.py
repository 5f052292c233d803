"""TT605 fixture: device work / unbounded reads on fleet handler paths.

Not imported or executed — parsed by tests/test_torch_analysis.py (the
test config adds this file to `fleet_modules`). HTTP handlers ENQUEUE
and READ ONLY: the drive loop is the only thread on the card.
"""
import http.server
import time

import torch

from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.runtime import dispatch_core as dcore


class SolveFrontHandler(http.server.BaseHTTPRequestHandler):
    def do_POST(self):
        body = self.rfile.read()                     # EXPECT TT605
        job = self.server.api.svc.submit(body)       # EXPECT TT605
        self._solve_inline(job)

    def _solve_inline(self, job):
        state = self.server.api.scheduler.step()     # EXPECT TT605
        torch.cuda.synchronize()                     # EXPECT TT605
        rows = state.slots.to(self.server.device)    # EXPECT TT605
        kernels.launch("breed")                      # EXPECT TT605
        push_result(state, rows)

    def do_GET(self):
        time.sleep(0.1)                              # EXPECT TT602
        n = int(self.headers.get("Content-Length", 0))
        chunk = self.rfile.read(n)                   # OK: bounded read
        view = self.server.snapshot.slots.to(torch.int64)  # OK: a cast
        self.wfile.write(chunk + bytes(view))


def push_result(state, rows):
    host = dcore.fetch_state(state)                  # EXPECT TT605
    copy = dcore.HostCopy(rows)                      # EXPECT TT605
    return host, copy


def drive_loop_is_fine(svc):
    # OK: not reachable from any handler — the drive loop owns the card
    while svc.queue.ready():
        svc.step()
        torch.cuda.synchronize()
