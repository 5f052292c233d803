"""Dispatch loops breaking the whole-program discipline ACROSS the
module boundary into interproc/core.py: every fact here — the program
factory, the device programs, the sanctioned fetch, the host copy — is
declared in the other module, which is exactly what the single-module
rules (TT301/TT203) cannot see."""

import numpy as np
import torch

from interproc import core


def taint_sink_loop(pa, steps):
    """TT303: host-forcing sinks on values a cross-module dispatch
    program produced, inside the dispatch loop."""
    runner = core.program("runner", core.mesh_step)
    state = pa
    for i in range(steps):
        state = runner(None, state, i)
        cur = float(state)                          # EXPECT TT303
        hist = state.tolist()                       # EXPECT TT303
        host = state.cpu()                          # EXPECT TT303
        if state.min() > cur:                       # EXPECT TT303
            break
        if state.any():                             # EXPECT TT303
            break
    return state, hist, host


def summary_taint(pa, steps):
    """TT303 through a device-returning SUMMARY and the nested
    `program(...)(...)` call form."""
    state = pa
    for i in range(steps):
        state = core.advance(state, i)
        done = bool(state)                          # EXPECT TT303
        rows = core.program("s", core.mesh_step)(None, state, i)
        arr = np.asarray(rows)                      # EXPECT TT303
        direct = core.mesh_step(None, state, i)
        for row in direct:
            print(row.item())                       # EXPECT TT303
        if done:
            break
    return state, arr


def copy_read_loop(traces):
    """TT304: a HostCopy made by another module read before its wait."""
    out = []
    for t in traces:
        hc = core.HostCopy(t)
        out.append(hc.host.sum())                   # EXPECT TT304
        many = core.host_copies([t])
        first = many[0].host                        # EXPECT TT304
        out.append(first)
    return out


def copy_waited(traces):
    """CLEAN under TT304: `.wait()` / a sanctioned fetch fence the copy
    before its destination is read."""
    out = []
    for t in traces:
        hc = core.HostCopy(t)
        hc.wait()
        out.append(hc.host)
        hc2 = core.HostCopy(t)
        out.append(core.fetch(hc2))
        out.append(hc2.host)
    return out


def telemetry_fence_loop(pa, steps):
    """TT305(a): a telemetry-only fetch BEFORE the dispatch fences it —
    only control reads may precede a dispatch."""
    runner = core.program("runner", core.mesh_step)
    state = pa
    rows = []
    for i in range(steps):
        trace = core.fetch(state)                   # EXPECT TT305
        rows.append(trace)
        state = runner(None, state, i)
    return state, rows


def sync_control_loop(pa, steps):
    """TT305(b): control flow steered through a synchronize instead of
    the sanctioned packed fetch."""
    runner = core.program("runner", core.mesh_step)
    state = pa
    for i in range(steps):
        state = runner(None, state, i)
        torch.cuda.synchronize()     # EXPECT TT305 # EXPECT TT301
        if state:                                   # EXPECT TT303
            break
    return state


def control_fetch_clean(pa, steps):
    """CLEAN: the control read precedes the next dispatch and steers the
    loop through the sanctioned fetch."""
    runner = core.program("runner", core.mesh_step)
    state = pa
    for i in range(steps):
        stats = core.fetch(state)
        if stats[0] == 0:
            break
        state = runner(None, state, i)
    return state


def resident_fetch_loop(sched, steps):
    """TT306: host fetches of resident-group state outside a park
    fence — the direct store read, a name rooted in it, and a
    conversion sink all flag."""
    rows = []
    snap = None
    for bkey in list(sched._resident):
        entry = sched._resident[bkey]
        snap = core.fetch(entry["state"])           # EXPECT TT306
        rows.append(
            np.asarray(sched._resident[bkey]["state"]))  # EXPECT TT306
        rows.append(entry["state"].cpu())           # EXPECT TT306
    return snap, rows


def _flush_bucket(sched, bkey):
    """CLEAN: a fence helper is the sanctioned resident fetch site."""
    return core.fetch(sched._resident[bkey]["state"])


def resident_dispatch_clean(sched, steps):
    """CLEAN under TT306: the resident state feeds the dispatch, and
    the park fetch reads the runner's OUTPUT."""
    runner = core.program("runner", core.mesh_step)
    state = sched._resident["b"]["state"]
    for i in range(steps):
        state = runner(None, state, i)
    host = core.fetch(state)
    return host
