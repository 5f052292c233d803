"""TT307 fixture: collectives inside a *Supervisor recovery policy.

Not imported or executed — parsed by tests/test_torch_analysis.py. The
healthy-path collective outside the class stays allowed.
"""
import torch.distributed as dist


class RunSupervisor:
    def agree(self, group, verdict):
        merged = group.broadcast([verdict])         # EXPECT TT307
        dist.all_gather([], verdict)                # EXPECT TT307
        return merged

    def classify(self, exc, channel):
        # OK: the host-side channel
        return channel.agree_on_fault({"site": str(exc)})


def healthy_fetch(group, x):
    # OK: the run loop's own collective, outside the recovery policy
    return group.all_gather(x, 0)
