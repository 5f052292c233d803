"""TT310 fixture: phase scopes outside the PHASES registry, or on
handler paths.

Not imported or executed — parsed by tests/test_torch_analysis.py;
PHASES is read by AST from timetabling_ga_tpu_torch/obs/prof.py.
"""
import http.server

import torch
from torch.profiler import record_function

from timetabling_ga_tpu_torch.obs import prof as obs_prof
from timetabling_ga_tpu_torch.obs.prof import scope


@obs_prof.scope("tt.fitness")                       # OK: registered
def fitness(x):
    return x


@scope("tt.fitnes")                                 # EXPECT TT310
def misspelled(x):
    return x


def ranges(x, name):
    with torch.profiler.record_function("my_phase"):  # EXPECT TT310
        x = x + 1
    with record_function(name):                     # EXPECT TT310
        x = x * 2
    with obs_prof.scope("tt.sweep"):                # OK: registered
        return x


class ProfHandler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        with obs_prof.scope("tt.ga"):               # EXPECT TT310
            self.wfile.write(b"ok")
