"""TT302 fixture: torch.distributed calls outside the comm group.

Not imported or executed — parsed by tests/test_torch_analysis.py (the
test config adds this file to `sharded_modules`; the Supervisor's
TT307 fires under any config).
"""
import torch.distributed as dist
from torch.distributed import all_gather as gather_all


def halo(to_next, to_prev, rank, world):
    dist.all_reduce(to_next)                        # EXPECT TT302
    reqs = dist.batch_isend_irecv([])               # EXPECT TT302
    parts = [to_next] * world
    gather_all(parts, to_next)                      # EXPECT TT302
    return reqs, parts


def local_ops(x, index, dim):
    # OK: a tensor's own scatter/gather, and a local named like a module
    dist_ = x.gather(dim, index)
    dists = dist_.scatter_add(dim, index, x)
    return dists


def via_group(group, x):
    # OK: the comm group carries the collective behind the accord guard
    return group.all_gather(x, 0)


class ShardSupervisor:
    """A recovery policy in a sharded module: TT307 wherever it is."""

    def agree(self, verdict):
        dist.broadcast(verdict, 0)   # EXPECT TT302 # EXPECT TT307
        return verdict
