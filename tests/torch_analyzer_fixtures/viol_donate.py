"""TT203 fixture: non-blocking device->host copies read before their
fence.

Not imported or executed — parsed by tests/test_torch_analysis.py.
"""
import torch


def early_read(x):
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host.numpy()                             # EXPECT TT203


def to_cpu_read(x):
    y = x.to("cpu", non_blocking=True)
    total = y.sum()                                 # EXPECT TT203
    return total


class Copy:
    def __init__(self, x):
        self.host = torch.empty(x.shape, pin_memory=True)
        self.host.copy_(x, non_blocking=True)
        self.peek = self.host[0]                    # EXPECT TT203
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self):
        # OK: the event fences the copy before the read
        self.event.synchronize()
        return self.host.numpy()


def fenced(x):
    host = torch.empty(x.shape, pin_memory=True)
    host.copy_(x, non_blocking=True)
    torch.cuda.synchronize()
    return host.numpy()                             # OK: after the fence


def to_device_ok(w, device):
    # OK: a host->device copy; the card reads it in stream order
    d = w.pin_memory().to(device, non_blocking=True)
    return d.sum()
