"""TT301 fixture: hidden host syncs in a dispatch loop.

Not imported or executed — parsed by tests/test_torch_analysis.py (the
test config adds this file to `dispatch_modules`). `early_host_read` is
the sync family's unscoped half (TT203), so a strict run over this file
fails under the default config too.
"""
import numpy as np
import torch


def program(name, fn):
    return fn


def mesh_init(mesh, pas, gens, pop_size):
    return pas


def fetch(x):
    """Sanctioned readback: its body is exempt."""
    return x.cpu().numpy()


def drive(mesh, pas, gens, cfg, n):
    runner = program("runner", cfg)
    state = mesh_init(mesh, pas, gens, 8)
    for i in range(n):
        state, stats = runner(mesh, pas, gens, state, i)
        best = stats[0].min().item()                # EXPECT TT301
        rows = np.asarray(stats)                    # EXPECT TT301
        hist = stats.tolist()                       # EXPECT TT301
        gap = float(stats[1].max())                 # EXPECT TT301
        host = stats.to("cpu")                      # EXPECT TT301
        torch.cuda.synchronize()                    # EXPECT TT301
        ok = fetch(stats)                           # OK: sanctioned
        n_ok = int(ok[0].min())                     # OK: host copy
        print(best, rows, hist, gap, host, n_ok)
    return state


def poll(events, x):
    while events:
        ev = events.pop()
        ev.synchronize()                            # EXPECT TT301
        y = x.cuda()
        print(y.numpy())                            # EXPECT TT301
    # OK: outside any loop
    return x.cuda().cpu()


def shapes_ok(stats):
    out = []
    for i in range(stats.shape[0]):
        out.append(stats.shape[1] * i)              # OK: no device value
    return out


def early_host_read(x):
    host = x.to("cpu", non_blocking=True)
    return host.sum()                               # EXPECT TT203
