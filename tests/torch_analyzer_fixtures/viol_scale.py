"""TT608 fixture: fleet actuation off the scaler thread.

Not imported or executed — parsed by tests/test_torch_analysis.py (the
test config adds this file to `fleet_modules`). Spawning, preempting and
adopting replicas happen ONLY on the autoscaler's control loop.
"""
import http.server
import subprocess


class ScaleHandler(http.server.BaseHTTPRequestHandler):
    def do_POST(self):
        self.server.gw.preempt_replica("r0")             # EXPECT TT608
        subprocess.Popen(["tt"])  # EXPECT TT608 # EXPECT TT602

    def _grow(self):
        handle = spawn_one(self.server.cfg, "s9")        # EXPECT TT608
        self.server.gw.adopt_replica(handle)             # EXPECT TT608

    def do_PUT(self):
        self._grow()


class ScalerApi:
    def accept_scale(self, payload):
        self._gw.retire_replica(payload["replica"])      # EXPECT TT608
        return 202, {}

    def scale_view(self):
        return 200, self._gw.scale_snapshot()            # OK: read


class FakeGateway:
    def _dispatch_loop(self):
        while True:
            self._poll_jobs()
            self.preempt_replica("r1")                   # EXPECT TT608

    def _handle(self, cmd):
        return free_port()                               # EXPECT TT608

    def _drain_tick(self):
        for handle in self.replicas.live():
            handle.drain(timeout=2.0)                    # OK: a command


def spawn_one(cfg, name):
    return (cfg, name)


def free_port():
    return 0


def scaler_thread_is_fine(gw, victim):
    # OK: the autoscaler's control loop is the actuation site
    gw.preempt_replica(victim)
