"""Batched fitness evaluation (port of timetabling_ga_tpu/ops/fitness.py).

Every function takes a population: slots/rooms `(P, E)` int32 -> `(P,)`.
The plain versions repeat the JAX contractions over one-hot operands in
float32 (all values are small exact integers, so every sum is exact);
`batch_penalty` is the wrapper of kernel K2 (csrc/batch_penalty.cu),
which computes the same counts in int32 on the card, a cluster of CS
CTAs an individual (`penalty_cluster`). Its body (csrc/penalty_dev.cuh)
also scores the children inside K6 (ops/ga.py make_children) and the
rows K8's local search returns (ops/delta.py random_local_search).
"""

from __future__ import annotations

import torch

from timetabling_ga_tpu_torch import kernels, work
from timetabling_ga_tpu_torch.obs import prof as obs_prof
from timetabling_ga_tpu_torch.problem import K2_CLUSTERS

# Penalty encoding (reference Solution.cpp:167 and ga.cpp:191)
INFEASIBLE_OFFSET = 1_000_000


def check_no_tf32(t: torch.Tensor) -> None:
    """The plain versions' float32 matmuls are exact only without TF32:
    refuse to run them on the card with it enabled."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are enabled; the plain fitness "
                           "contractions need full float32")


def slot_onehot(slots: torch.Tensor, n_slots: int) -> torch.Tensor:
    """(P, E) int -> (P, T, E) float32 one-hot of event timeslots."""
    ar = torch.arange(n_slots, device=slots.device, dtype=slots.dtype)
    return (slots[:, None, :] == ar[None, :, None]).to(torch.float32)


def room_onehot(rooms: torch.Tensor, n_rooms: int) -> torch.Tensor:
    """(P, E) int -> (P, R, E) float32 one-hot of event rooms."""
    ar = torch.arange(n_rooms, device=rooms.device, dtype=rooms.dtype)
    return (rooms[:, None, :] == ar[None, :, None]).to(torch.float32)


@obs_prof.scope("tt.fitness")
def compute_hcv(pa, slots, rooms) -> torch.Tensor:
    """Hard-constraint violations (P,) int32: room clash pairs,
    correlated pairs sharing a slot, events in unsuitable rooms
    (Solution.cpp:141-160; JAX fitness.py:57)."""
    check_no_tf32(slots)
    X = slot_onehot(slots, pa.n_slots) * pa.event_mask[None, None, :]
    Y = room_onehot(rooms, pa.n_rooms)
    occ = X @ Y.transpose(1, 2)                         # (P, T, R)
    pair_clash = (occ * (occ - 1.0)).sum((1, 2)) * 0.5
    full = ((X @ pa.conflict) * X).sum((1, 2))
    diag = torch.diagonal(pa.conflict).sum()
    corr_pairs = (full - diag) * 0.5
    E = slots.shape[1]
    ar = torch.arange(E, device=slots.device)
    unsuitable = ((~pa.possible[ar[None, :], rooms.long()]).to(torch.int32)
                  * pa.live[None, :]).sum(1)
    return (pair_clash + corr_pairs).to(torch.int32) + unsuitable.to(
        torch.int32)


@obs_prof.scope("tt.fitness")
def attendance_matrix(pa, slots) -> torch.Tensor:
    """Per-(student, slot) attended-event counts (P, S, T) float32."""
    check_no_tf32(slots)
    X = slot_onehot(slots, pa.n_slots)                  # (P, T, E)
    return pa.attends @ X.transpose(1, 2)               # (P, S, T)


def day_view(x: torch.Tensor, n_days: int, spd: int) -> torch.Tensor:
    """(..., T) -> (..., D, spd)."""
    return x.reshape(x.shape[:-1] + (n_days, spd))


@obs_prof.scope("tt.fitness")
def scv_from_attendance(pa, slots, att) -> torch.Tensor:
    """Soft-constraint violations (P,) int32 given attendance counts:
    last-slot classes weighted by students, runs of >= 3, single-class
    days (Solution.cpp:86-139; JAX fitness.py:106)."""
    spd = pa.slots_per_day
    last_mask = (slots % spd) == (spd - 1)
    last = torch.where(last_mask, pa.student_count[None, :], 0).sum(1)
    b = day_view(att > 0, pa.n_days, spd)               # (P, S, D, spd)
    consec = (b[..., 2:] & b[..., 1:-1] & b[..., :-2]).to(
        torch.int32).sum((1, 2, 3))
    single = (b.sum(-1) == 1).to(torch.int32).sum((1, 2))
    return (last + consec + single).to(torch.int32)


def compute_scv(pa, slots) -> torch.Tensor:
    return scv_from_attendance(pa, slots, attendance_matrix(pa, slots))


def base_penalty(hcv, scv):
    """scv if feasible else 1_000_000 + hcv (Solution.cpp:162-170)."""
    return torch.where(hcv == 0, scv, INFEASIBLE_OFFSET + hcv)


@obs_prof.scope("tt.fitness")
def anchor_cost(pa, slots) -> torch.Tensor:
    """Weighted Hamming distance to the anchor timetable (P,) int32."""
    return (pa.anchor_w[None, :]
            * (slots != pa.anchor_slots[None, :]).to(torch.int32)).sum(1)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (P, E), idx (P, ...) -> x[p, idx[p, ...]] with idx's shape."""
    P = x.shape[0]
    return torch.gather(x, 1, idx.reshape(P, -1).long()).reshape(idx.shape)


@obs_prof.scope("tt.fitness")
def anchor_delta(pa, slots, evs, new_slots) -> torch.Tensor:
    """Anchor-cost change of sparse moves: slots (P, E), evs/new_slots
    (P, ..., M) -> (P, ...). Inactive lanes pass new == old and cancel."""
    evl = evs.long()
    w = pa.anchor_w[evl]
    old = gather_rows(slots, evs)
    anc = pa.anchor_slots[evl]
    return (w * ((new_slots != anc).to(torch.int32)
                 - (old != anc).to(torch.int32))).sum(-1)


def batch_penalty_plain(pa, slots, rooms):
    """Plain version of K2: (penalty, hcv, scv), each (P,) int32."""
    hcv = compute_hcv(pa, slots, rooms)
    scv = compute_scv(pa, slots)
    penalty = base_penalty(hcv, scv) + anchor_cost(pa, slots)
    return penalty.to(torch.int32), hcv, scv


# the largest of the cluster sizes K2 takes (problem.K2_CLUSTERS, the
# sizes its students are split for; csrc/batch_penalty.cu K2_MAX_CLUSTER)
K2_MAX_CLUSTER = K2_CLUSTERS[-1]


def penalty_cluster_size(P: int, sm_count: int) -> int:
    """K2's CTAs per individual: the largest power of two up to
    K2_MAX_CLUSTER whose P x CS CTAs still fit one to an SM, at least 1."""
    cs = 1
    while cs < K2_MAX_CLUSTER and 2 * cs * P <= sm_count:
        cs *= 2
    return cs


def penalty_cluster(pa, P: int, device) -> int:
    """The cluster size K2's wrapper takes on `device` for P rows."""
    # a read of the struct PyTorch keeps for each card from its first
    # query (at::cuda::getDeviceProperties), not a driver call
    # tt-analyze: ignore[TT603]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return penalty_cluster_size(P, sms)


# threads of a K2 CTA (csrc/batch_penalty.cu K2_THREADS)
K2_THREADS = 256


def batch_penalty_stage(pa) -> tuple:
    """(shared memory of one K2 CTA without its staged CSR slice and
    conflict rows, whether it stages the (T, R) int32 occupancy): a CTA
    always stages the row, the live flags, the slot bitsets and the
    reductions' scratch (csrc/batch_penalty.cu, ints rounded up to 4),
    and the occupancy where it fits (kernels.stage_regions; else a
    global scratch row a CTA)."""
    def up(x):
        return -(-x // 4) * 4
    n_red = 4 * (K2_THREADS // 32) + 4 * K2_MAX_CLUSTER
    base = 4 * (3 * up(pa.n_events)
                + up(pa.n_slots * pa.conflict_bits.shape[1]) + up(n_red))
    total, (occ,) = kernels.stage_regions(
        base, [4 * up(pa.n_slots * pa.n_rooms)])
    return total, occ


def batch_penalty_kernel(pa, slots, rooms, cluster: int = None):
    """Kernel K2 on CUDA tensors: every row in one launch, a cluster of
    `cluster` CTAs a row (None: `penalty_cluster`; an explicit size, 1,
    2, 4 or 8, is for tests and the chip smoke). Returns the (3, P) int32
    tensor of (penalty, hcv, scv) rows. Where the occupancy does not fit
    in shared memory each CTA keeps it in a global scratch row and the
    clusters stride over the rows, as many clusters as
    kernels.resident_grid gives CTAs: a row a CTA of every individual
    would be P x CS x 4 T R bytes (24 GB at pop 32,768 and R = 4,095).
    A cluster the card refuses raises; there is no fallback."""
    P, E = slots.shape
    if slots.dtype != torch.int32 or rooms.dtype != torch.int32:
        raise TypeError("batch_penalty takes int32 slots and rooms")
    slots = slots.contiguous()
    rooms = rooms.contiguous()
    out = torch.empty((3, P), dtype=torch.int32, device=slots.device)
    if cluster is not None and cluster not in K2_CLUSTERS:
        raise ValueError(f"batch_penalty: a cluster of {cluster} CTAs; K2 "
                         f"takes {K2_CLUSTERS}")
    if P == 0:
        return out
    p = kernels.ptr
    args = [p(slots), p(rooms), p(pa.possible_u8), p(pa.live),
            p(pa.student_count), p(pa.conflict_bits), p(pa.stu_ptr),
            p(pa.stu_ev), p(pa.anchor_slots), p(pa.anchor_w),
            pa.stu_split.data_ptr(), p(out[0]), p(out[1]), p(out[2])]
    if cluster is None:
        cluster = penalty_cluster(pa, P, slots.device)
    occ_staged = batch_penalty_stage(pa)[1]
    grid = (P if occ_staged else
            kernels.resident_grid(P, slots.device, cluster))
    occ = (None if occ_staged else
           torch.empty((grid * cluster, pa.n_slots, pa.n_rooms),
                       dtype=torch.int32, device=slots.device))
    kernels.launch(
        "batch_penalty", *args, None if occ is None else p(occ), P, E,
        pa.n_rooms, pa.n_students, pa.n_slots, pa.slots_per_day,
        pa.conflict_bits.shape[1], pa.conflict_diag, cluster,
        int(occ_staged), grid, work=work.batch_penalty(pa, slots))
    return out


@obs_prof.scope("tt.fitness")
def batch_penalty(pa, slots, rooms):
    """Evaluate a population: slots/rooms (P, E) int32 -> (penalty, hcv,
    scv), each (P,) int32. Kernel K2 on a CUDA tensor, the plain
    version on a CPU one."""
    if not slots.is_cuda:
        kernels.tally(work.batch_penalty(pa, slots))
        return batch_penalty_plain(pa, slots, rooms)
    out = batch_penalty_kernel(pa, slots, rooms)
    return out[0], out[1], out[2]


def lex_order(penalty, scv) -> torch.Tensor:
    """Indices sorting the last axis by (penalty, scv), ties by position:
    two stable sorts, the tie order of jnp.lexsort((scv, penalty))."""
    o1 = torch.sort(scv, dim=-1, stable=True).indices
    o2 = torch.sort(torch.gather(penalty, -1, o1), dim=-1,
                    stable=True).indices
    return torch.gather(o1, -1, o2)
