"""TT602/TT605 fixture: *Api surfaces are handler-path roots.

Not imported or executed — parsed by tests/test_torch_analysis.py (the
test config adds this file to `fleet_modules`; `handler_api_suffixes`
defaults to ["Api"]). The fleet fronts route every request into an api
object whose methods run ON the handler thread.
"""
import urllib.request


class WrongGatewayApi:
    def __init__(self, gw, registry):
        self._gw = gw
        self._registry = registry

    def accept_solve(self, payload):
        self._registry.counter("fleet.jobs_accepted").inc()  # EXPECT TT602
        self._gw.inbox.put(("submit", payload))
        return 202, {"ok": True}

    def fleet_view(self):
        body = urllib.request.urlopen("http://r0:1/metrics")  # EXPECT TT602
        return 200, {"metrics": body.read().decode()}

    def accept_drain(self):
        self._drain_inline()
        return 200, {"draining": True}

    def _drain_inline(self):
        self._gw.svc.drive()                                 # EXPECT TT605
        self._gw.state.cuda()                                # EXPECT TT605


class ReadOnlyViewApi:
    """OK: enqueue commands, read cached state, mutate nothing."""

    def __init__(self, gw):
        self._gw = gw

    def accept_solve(self, payload):
        self._gw.inbox.put(("submit", payload))
        return 202, {"ok": True}


def dispatcher_side_is_fine(gw, registry):
    # OK: not reachable from any handler or api class
    registry.counter("fleet.jobs_routed").inc()
    urllib.request.urlopen(gw.url + "/metrics")
    gw.svc.drive()
