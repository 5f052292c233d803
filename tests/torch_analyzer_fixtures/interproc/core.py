"""The clean side of the interproc fixtures: a miniature dispatch core.
`program` matches the `taint-sources` pattern (its product is a
dispatch program), `mesh_step` the `device-programs` pattern, `fetch`
is the sanctioned readback helper, `HostCopy` / `host_copies` start
non-blocking device->host copies, and `advance` is summarized
device-returning — all facts the whole-program layer must carry into
loop.py."""

import torch


def program(name, fn):
    """Factory: `fn` as a dispatch program."""
    return fn


def mesh_step(mesh, state, seed):
    return state


def fetch(x):
    """Sanctioned packed device->host readback."""
    return x.cpu().numpy()


class HostCopy:
    def __init__(self, x):
        self.host = torch.empty(x.shape, pin_memory=True)
        self.host.copy_(x, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self):
        self.event.synchronize()
        return self.host.numpy()


def host_copies(xs):
    return [HostCopy(x) for x in xs]


def advance(state, seed):
    """Device-returning helper: its result is a dispatch program's
    output, so callers in other modules inherit the taint."""
    return program("step", mesh_step)(None, state, seed)
