"""NSGA-II selection on (hcv, scv) (port of timetabling_ga_tpu/ops/nsga.py).

Hard and soft violations are two minimised objectives: individuals are
ranked by non-dominated fronts (complete peeling, no bound on the number
of fronts), ties within a front broken by crowding distance (float32,
the global range of each objective, +inf at a front's boundary). The
penalty's anchor term plays no part.

`rank_crowd` (the parents' ranks and crowding, for the crowded
tournament) and `survivors` (the replacement: parents + children ->
the best `keep` by (rank asc, crowding desc, position), re-sorted by
(penalty, scv) in that order) are the wrappers of kernel K11
(csrc/nsga.cu, entries `nsga_rank` and `nsga_survivors`); the functions
without a kernel are their plain versions, batched over islands as
consecutive equal row blocks (`groups`), as ops/ga.py's populations are.
"""

from __future__ import annotations

from typing import Optional

import torch

from timetabling_ga_tpu_torch import kernels, work
from timetabling_ga_tpu_torch.ops import fitness

INF = float("inf")


def domination_matrix(hcv, scv) -> torch.Tensor:
    """dom[..., i, j] = True iff i dominates j on (hcv, scv) (..., n):
    no worse in both and strictly better in at least one."""
    h, s = hcv[..., :, None], scv[..., :, None]
    h2, s2 = hcv[..., None, :], scv[..., None, :]
    return (h <= h2) & (s <= s2) & ((h < h2) | (s < s2))


def nondominated_ranks(hcv, scv) -> torch.Tensor:
    """Front index (..., n) int32 per individual, 0 = the Pareto front:
    each round takes every unassigned individual none of whose
    dominators is still unassigned (JAX nsga.py:40)."""
    dom = domination_matrix(hcv, scv)
    n_dom = dom.sum(-2).to(torch.int32)
    ranks = torch.full(hcv.shape, -1, dtype=torch.int32, device=hcv.device)
    f = 0
    while bool((ranks < 0).any()):
        front = (n_dom == 0) & (ranks < 0)
        ranks = torch.where(front, f, ranks).to(torch.int32)
        removed = (dom & front[..., :, None]).sum(-2).to(torch.int32)
        n_dom = torch.where(front, -1, n_dom - removed)
        f += 1
    return ranks


def crowding_distance(hcv, scv, ranks) -> torch.Tensor:
    """Crowding distance (..., n) float32 within each front (larger =
    lonelier): per objective, a stable sort by (rank, objective); the
    neighbours' gap over the objective's range, max(max - min, 1), where
    both neighbours share the front, else +inf; the two objectives'
    gaps added to 0 in order (JAX nsga.py:69)."""
    dist = torch.zeros(hcv.shape, dtype=torch.float32, device=hcv.device)
    for obj_i in (hcv, scv):
        order = fitness.lex_order(ranks, obj_i)
        obj = obj_i.to(torch.float32)
        obj_s = torch.gather(obj, -1, order)
        rank_s = torch.gather(ranks, -1, order)
        pad = torch.full(obj.shape[:-1] + (1,), INF, dtype=torch.float32,
                         device=obj.device)
        lo = torch.cat([-pad, obj_s[..., :-1]], -1)
        hi = torch.cat([obj_s[..., 1:], pad], -1)
        no = torch.zeros(obj.shape[:-1] + (1,), dtype=torch.bool,
                         device=obj.device)
        same = rank_s[..., 1:] == rank_s[..., :-1]
        both = torch.cat([no, same], -1) & torch.cat([same, no], -1)
        rng = torch.clamp_min(obj.amax(-1, keepdim=True)
                              - obj.amin(-1, keepdim=True), 1.0)
        gap = torch.where(both, (hi - lo) / rng, INF)
        dist = dist.scatter_add(-1, order, gap)
    return dist


def crowded_order(ranks, crowd) -> torch.Tensor:
    """Indices sorting the last axis by (rank asc, crowd desc), ties by
    position: jnp.lexsort((-crowd, ranks)), two stable sorts."""
    o1 = torch.sort(-crowd, dim=-1, stable=True).indices
    o2 = torch.sort(torch.gather(ranks, -1, o1), dim=-1, stable=True).indices
    return torch.gather(o1, -1, o2)


def nsga_survivor_indices(hcv, scv, n_survivors: int) -> torch.Tensor:
    """Indices of the NSGA-II survivors, (rank asc, crowd desc)."""
    ranks = nondominated_ranks(hcv, scv)
    crowd = crowding_distance(hcv, scv, ranks)
    return crowded_order(ranks, crowd)[..., :n_survivors]


def crowded_tournament(draws, ranks, crowd) -> torch.Tensor:
    """Crowded-comparison tournament per child: draws (C, k) row indices
    -> (C,) the index of the best draw by (rank asc, crowd desc), the
    earliest draw on a full tie (jnp.lexsort(...)[0])."""
    order = crowded_order(ranks[draws], crowd[draws])
    return torch.gather(draws, 1, order[:, :1])[:, 0]


def _blocks(x, groups):
    return x.reshape((groups, -1) + tuple(x.shape[1:]))


def rank_crowd_plain(hcv, scv, groups: int = 1):
    """Plain version of K11's nsga_rank: each island's ranks (P,) int32
    and crowding (P,) float32."""
    h, s = _blocks(hcv, groups), _blocks(scv, groups)
    ranks = nondominated_ranks(h, s)
    return ranks.reshape(-1), crowding_distance(h, s, ranks).reshape(-1)


def _check_rows(*xs):
    for x in xs:
        if x.dtype != torch.int32:
            raise TypeError("nsga takes int32 rows")


def rank_crowd_kernel(hcv, scv, groups: int = 1):
    """Kernel K11's nsga_rank: one block per island."""
    hcv, scv = hcv.contiguous(), scv.contiguous()
    _check_rows(hcv, scv)
    P = hcv.shape[0]
    ranks = torch.empty_like(hcv)
    crowd = torch.empty(P, dtype=torch.float32, device=hcv.device)
    if P == 0:
        return ranks, crowd
    p = kernels.ptr
    kernels.launch("nsga_rank", p(hcv), p(scv), p(ranks), p(crowd), groups,
                   P // groups, work=work.nsga_rank(groups, P // groups))
    return ranks, crowd


def rank_crowd(hcv, scv, groups: int = 1):
    """Each island's non-dominated ranks and crowding distances (the
    crowded tournament's keys, computed once per generation on the
    parents, JAX ga.py:239-245). Kernel K11 on CUDA tensors, the plain
    version on CPU ones."""
    if not hcv.is_cuda:
        if hcv.shape[0]:
            kernels.tally(work.nsga_rank(groups, hcv.shape[0] // groups))
        return rank_crowd_plain(hcv, scv, groups)
    return rank_crowd_kernel(hcv, scv, groups)


def survivors_plain(a, b, groups: int = 1, keep: Optional[int] = None):
    """Plain version of K11's nsga_survivors: each island's rows of `a`
    then of `b`; the `keep` best by (rank asc, crowd desc, position),
    then those sorted by (penalty, scv) with ties in that order
    (JAX ga.py:282-288)."""
    PopState = type(a)
    both = PopState(*(
        torch.cat([_blocks(x, groups), _blocks(y, groups)], 1)
        for x, y in zip(a, b)))
    n = both.penalty.shape[1]
    keep = n if keep is None else keep
    kept = nsga_survivor_indices(both.hcv, both.scv, keep)
    order = torch.gather(kept, 1, fitness.lex_order(
        torch.gather(both.penalty, 1, kept), torch.gather(both.scv, 1, kept)))
    flat = (order + torch.arange(groups, device=order.device)[:, None]
            * n).reshape(-1)
    return PopState(*(x.reshape((groups * n,) + tuple(x.shape[2:]))[flat]
                      for x in both))


def survivors_kernel(a, b, groups: int = 1, keep: Optional[int] = None):
    """Kernel K11's nsga_survivors: every island in one launch."""
    PopState = type(a)
    na = a.slots.shape[0] // groups
    nb = b.slots.shape[0] // groups
    keep = na + nb if keep is None else keep
    E = a.slots.shape[1]
    ins = [x.contiguous() for x in a] + [x.contiguous() for x in b]
    _check_rows(*ins)
    dev = a.slots.device
    out = PopState(
        torch.empty((groups * keep, E), dtype=torch.int32, device=dev),
        torch.empty((groups * keep, E), dtype=torch.int32, device=dev),
        *(torch.empty(groups * keep, dtype=torch.int32, device=dev)
          for _ in range(3)))
    p = kernels.ptr
    kernels.launch("nsga_survivors", *(p(x) for x in ins),
                   *(p(x) for x in out), groups, na, nb, keep, E,
                   work=work.nsga_survivors(groups, na, nb, keep, E))
    return out


def survivors(a, b, groups: int = 1, keep: Optional[int] = None):
    """The NSGA-II (mu+lambda) replacement of each island: parents `a`
    and children `b` ranked on (hcv, scv), the best `keep` (default all)
    by (rank, crowding) kept, penalty-sorted so rows 0/1 stay the
    migration emigrants. Kernel K11 on CUDA tensors, the plain version
    on CPU ones."""
    if not a.slots.is_cuda:
        na = a.slots.shape[0] // groups
        nb = b.slots.shape[0] // groups
        kernels.tally(work.nsga_survivors(
            groups, na, nb, na + nb if keep is None else keep,
            a.slots.shape[1]))
        return survivors_plain(a, b, groups, keep)
    return survivors_kernel(a, b, groups, keep)
