"""The processes of a run split across processes: the port's
counterpart of jax.distributed and multihost_utils (JAX
runtime/engine.py:551-587, runtime/dispatch_core.py:404-429).

A `ProcessGroup` is this process's place in the run (its rank, the
world size, the torch.distributed backend and the TCPStore the group is
built on) and the collectives the run loop uses, each behind
`control_channel.active().guard_collective()` so that a dead or faulted
peer is classified on the host side (PeerLost, AccordPeerFault) instead
of hanging inside the collective. Each stages its tensors (under gloo,
a copy to the host that waits for this process's queued kernels)
before the guard, so a process enters the collective with its data in
hand and none waits inside it for a peer's kernels:

    all_gather      host arrays of every rank, joined in rank order along
                    an axis (JAX's process_allgather of a fetch)
    all_reduce_min  a device scalar's minimum over the ranks (the global
                    best, JAX's lax.pmin across hosts)
    exchange        the island ring's shard-boundary halo: one
                    batch_isend_irecv pair with the previous and the next
                    rank (JAX's lax.ppermute across hosts)
    broadcast       process 0's integers to every rank, the --no-accord
                    schedule agreement (JAX's broadcast_one_to_all)

On NCCL the tensors move on the rank's card; on gloo (a CPU run, or
two ranks sharing one card, which NCCL refuses) they are staged through
host memory. `SOLO` is the one-process group: every method is the
identity and nothing is guarded. Nothing here runs at import or touches
torch.distributed before a run asks for a group.
"""

from __future__ import annotations

import datetime
import sys

import numpy as np
import torch

from timetabling_ga_tpu_torch.runtime import control_channel


def _guard() -> None:
    ch = control_channel.active()
    if ch is not None:
        ch.guard_collective()


class ProcessGroup:
    """This process's rank in a run of `world` processes; `backend` is
    "nccl" or "gloo" (None alone), `device` where the collectives'
    tensors live (the rank's first card under NCCL, else the CPU)."""

    def __init__(self, rank: int = 0, world: int = 1, backend=None,
                 store=None, device=None):
        self.rank = int(rank)
        self.world = int(world)
        self.backend = backend
        self.store = store
        self.device = torch.device("cpu") if device is None else device

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device).contiguous()

    def all_gather(self, x: np.ndarray, axis: int = 0) -> np.ndarray:
        """Every rank's `x` (equal shapes) joined in rank order along
        `axis`."""
        if self.world == 1:
            return x
        import torch.distributed as dist
        t = self._stage(torch.from_numpy(np.ascontiguousarray(x)))
        _guard()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t)
        return np.concatenate([p.cpu().numpy() for p in parts], axis)

    def all_reduce_min(self, t: torch.Tensor) -> torch.Tensor:
        """The minimum of a scalar tensor over the ranks, on t's device."""
        if self.world == 1:
            return t
        import torch.distributed as dist
        s = self._stage(t.reshape(1))
        if s.is_cuda:
            torch.cuda.synchronize(s.device)
        _guard()
        dist.all_reduce(s, op=dist.ReduceOp.MIN)
        return s.to(t.device).reshape(t.shape)

    def exchange(self, to_next: torch.Tensor, to_prev: torch.Tensor):
        """Send `to_next` to the next rank and `to_prev` to the previous
        one, in one batch_isend_irecv; returns (from_prev, from_next),
        on the senders' device. The rows sent are the caller's copies,
        taken before any rank writes its population."""
        if self.world == 1:
            return to_next, to_prev
        import torch.distributed as dist
        nxt = (self.rank + 1) % self.world
        prv = (self.rank - 1) % self.world
        a, b = self._stage(to_next), self._stage(to_prev)
        if a.is_cuda:
            torch.cuda.synchronize(a.device)
        _guard()
        from_prev, from_next = torch.empty_like(a), torch.empty_like(b)
        # the tags tell the two messages apart when prev == next (two
        # ranks); NCCL matches them in issue order, which is the same
        ops = [dist.P2POp(dist.isend, a, nxt, tag=1),
               dist.P2POp(dist.isend, b, prv, tag=2),
               dist.P2POp(dist.irecv, from_prev, prv, tag=1),
               dist.P2POp(dist.irecv, from_next, nxt, tag=2)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return (from_prev.to(to_next.device), from_next.to(to_prev.device))

    def broadcast(self, vals) -> list:
        """Process 0's integers on every rank."""
        if self.world == 1:
            return [int(v) for v in vals]
        import torch.distributed as dist
        t = self._stage(torch.tensor([int(v) for v in vals],
                                     dtype=torch.int64))
        _guard()
        dist.broadcast(t, 0)
        return [int(v) for v in t.cpu().tolist()]


SOLO = ProcessGroup()
_ACTIVE = SOLO


def active() -> ProcessGroup:
    """The run's process group (SOLO unless one was started)."""
    return _ACTIVE


def install(group: ProcessGroup) -> ProcessGroup:
    global _ACTIVE
    _ACTIVE = SOLO if group is None else group
    return _ACTIVE


def device_ids(devices) -> list:
    """A stable name of each device: the card's UUID, "cpu" for the
    host."""
    out = []
    for d in devices:
        if d.type == "cuda":
            out.append(str(torch.cuda.get_device_properties(d).uuid))
        else:
            out.append("cpu")
    return out


def choose_backend(cpu: bool, ids_by_rank: list) -> tuple:
    """(backend, reason): gloo for a CPU run and when two ranks share a
    card (NCCL refuses two ranks on one device), NCCL otherwise."""
    if cpu:
        return "gloo", "--backend cpu"
    owner = {}
    for rank, ids in enumerate(ids_by_rank):
        for u in ids:
            if u in owner and owner[u] != rank:
                return "gloo", (f"ranks {owner[u]} and {rank} share card "
                                f"{u}; NCCL refuses two ranks on one "
                                f"device, so the halo rows and gathers are "
                                f"staged through host memory")
            owner[u] = rank
    return "nccl", "no two ranks share a card"


def start(store, rank: int, world: int, devices, cpu: bool,
          timeout_s: float) -> ProcessGroup:
    """Build this rank's process group on `store` (a TCPStore every rank
    reaches). The ranks first publish their shard count and their
    shards' device ids on the store; the backend is chosen once from
    those (choose_backend), printed on stderr, and never changed after a
    failure. Every rank must hold the same number of shards."""
    import torch.distributed as dist
    store.set(f"tt-mesh/shards/{rank}", str(len(devices)))
    store.set(f"tt-mesh/ids/{rank}", ",".join(device_ids(devices)))
    counts = [int(store.get(f"tt-mesh/shards/{r}")) for r in range(world)]
    if len(set(counts)) != 1:
        raise ValueError(f"every process must hold the same number of "
                         f"shards; the ranks hold {counts}")
    ids = [store.get(f"tt-mesh/ids/{r}").decode().split(",")
           for r in range(world)]
    backend, why = choose_backend(cpu, ids)
    print(f"# tt: process {rank} of {world}: {backend} process group "
          f"({why})", file=sys.stderr)
    kw = {}
    if timeout_s > 0:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, store=dist.PrefixStore("tt-pg", store),
                            rank=rank, world_size=world, **kw)
    dev = devices[0] if backend == "nccl" else torch.device("cpu")
    return install(ProcessGroup(rank, world, backend, store, dev))
