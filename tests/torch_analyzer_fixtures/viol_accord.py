"""TT307 fixture: collectives in an accord module.

Not imported or executed — parsed by tests/test_torch_analysis.py (the
test config adds this file to `accord_modules`). The control side
channel decides what to do after a fault, when a collective is
poisoned on at least one process: it rides the TCPStore only.
"""
import torch.distributed as dist


class Channel:
    def __init__(self, store, group):
        self.store = store
        self.group = group

    def agree_on_fault(self, local):
        dist.all_reduce(local)                      # EXPECT TT307
        verdicts = self.group.all_gather(local, 0)  # EXPECT TT307
        dist.broadcast(local, 0)                    # EXPECT TT307
        return verdicts

    def publish(self, key, value):
        # OK: the TCPStore IS the channel
        self.store.set(key, value)
        self.store.add("n", 1)
        self.store.wait([key])
        return self.store.get(key)


class AccordSupervisor:
    """The recovery policy: TT307 under any config."""

    def agree_on_fault(self, group, local):
        return group.all_gather(local, 0)           # EXPECT TT307
