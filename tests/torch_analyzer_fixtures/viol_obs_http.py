"""TT602 fixture: blocking I/O / registry mutation in handler paths.

Not imported or executed — parsed by tests/test_torch_analysis.py. A
scrape is a pure observer: it reads registry snapshots and writes its
own response socket, nothing else.
"""
import http.server
import time

from timetabling_ga_tpu_torch.obs import metrics as obs_metrics

REGISTRY = obs_metrics.REGISTRY


class ScrapeHandler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        REGISTRY.counter("scrapes").inc()            # EXPECT TT602
        time.sleep(0.5)                              # EXPECT TT602
        body = self.server.registry.to_prometheus()  # OK: read-only
        self._audit(body)
        self.wfile.write(body.encode())              # OK: own socket

    def _audit(self, body):
        with open("scrapes.log", "a") as fh:         # EXPECT TT602
            fh.write(str(len(body)))
        touch_gauge()


def touch_gauge():
    obs_metrics.REGISTRY.gauge("scrape.last").set(1.0)   # EXPECT TT602


def host_side_is_fine():
    # OK: not reachable from any handler
    obs_metrics.REGISTRY.counter("serve.jobs_done").inc()
    time.sleep(0.001)
