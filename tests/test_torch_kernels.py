"""The CUDA kernels K1-K4 against their plain PyTorch versions.

This file imports neither JAX nor the JAX package and needs no conftest
fixture, so it also runs on a machine with the card but without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

The `cuda` tests skip where there is no CUDA device (the kernels have
no CPU mode); the rest check, on any machine, the kernel build's
bookkeeping and that a CPU tensor takes the plain version.
"""

import numpy as np
import pytest
import torch

from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import delta, fitness, moves, rooms, sweep
from timetabling_ga_tpu_torch.problem import (
    derive, itc_like_instance, make_problem_arrays, random_instance)

torch.set_num_threads(1)


def padded_arrays(problem, n_pad_events=5, n_pad_rooms=2, device="cpu"):
    """ProblemArrays of `problem` padded with masked-out events and rooms
    (zero attendance and capacity, suitable nowhere)."""
    E, R = problem.n_events, problem.n_rooms
    Ep, Rp = E + n_pad_events, R + n_pad_rooms
    attends = np.zeros((problem.n_students, Ep), np.int8)
    attends[:, :E] = problem.attends
    feats = np.zeros((Ep, problem.n_features), np.int8)
    feats[:E] = problem.event_features
    room_feats = np.zeros((Rp, problem.n_features), np.int8)
    room_feats[:R] = problem.room_features
    size = np.zeros(Rp, np.int32)
    size[:R] = problem.room_size
    p = derive(Ep, Rp, problem.n_features, problem.n_students, size,
               attends, room_feats, feats)
    possible = np.array(p.possible)
    possible[E:, :] = False
    possible[:, R:] = False
    return make_problem_arrays(
        attends=p.attends, conflict=p.conflict, possible=possible,
        student_count=p.student_count, room_size=p.room_size,
        event_mask=(np.arange(Ep) < E).astype(np.float32),
        room_mask=np.arange(Rp) < R, anchor_slots=np.zeros(Ep, np.int32),
        anchor_w=np.zeros(Ep, np.int32), n_days=5, slots_per_day=9,
        device=device)


def _instances(device):
    comp = itc_like_instance(3, n_events=120, n_rooms=6, n_students=80)
    medium = random_instance(2, n_events=80, n_rooms=8, n_features=5,
                             n_students=60, attend_prob=0.08)
    anchored = make_problem_arrays(
        **{k: getattr(comp.device_arrays(), k).numpy() for k in (
            "attends", "conflict", "possible", "student_count",
            "room_size", "event_mask", "room_mask")},
        anchor_slots=np.arange(120, dtype=np.int32) % 45,
        anchor_w=np.arange(120, dtype=np.int32) % 3, n_days=5,
        slots_per_day=9, device=device)
    return [comp.device_arrays(device), medium.device_arrays(device),
            padded_arrays(medium, device=device), anchored]


def _state(pa, P, seed):
    g = torch.Generator(device=pa.device).manual_seed(seed)
    slots = torch.randint(0, pa.n_slots, (P, pa.n_events), generator=g,
                          device=pa.device, dtype=torch.int32)
    return delta.init_state(pa, slots, rooms.assign_rooms_plain(pa, slots))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_assign_rooms_equals_plain(cuda):
    for pa in _instances(cuda):
        st = _state(pa, 37, 1)
        assert torch.equal(rooms.assign_rooms(pa, st.slots),
                           rooms.assign_rooms_plain(pa, st.slots))


@pytest.mark.cuda
def test_k2_batch_penalty_equals_plain(cuda):
    for pa in _instances(cuda):
        st = _state(pa, 33, 2)
        r = torch.randint(0, pa.n_rooms, st.rooms.shape, device=cuda,
                          dtype=torch.int32)
        for rm in (st.rooms, r):
            got = fitness.batch_penalty(pa, st.slots, rm)
            want = fitness.batch_penalty_plain(pa, st.slots, rm)
            for w, g in zip(want, got):
                assert torch.equal(w, g)


@pytest.mark.cuda
def test_k3_move1_sweep_equals_plain(cuda):
    for pa in _instances(cuda):
        st = _state(pa, 9, 3)
        piv = torch.randint(0, pa.n_events, (9, 3), device=cuda,
                            dtype=torch.int32)
        got = sweep.move1_sweep(pa, st.slots, st.rooms, st.att, st.occ, piv)
        want = sweep.move1_sweep_plain(pa, st.slots, st.rooms, st.att,
                                       st.occ, piv)
        for w, g in zip(want, got):
            assert torch.equal(w, g)


@pytest.mark.cuda
def test_k4_delta_one_equals_plain(cuda):
    for pa in _instances(cuda):
        P, C = 7, 11
        st = _state(pa, P, 4)
        g = torch.Generator(device=cuda).manual_seed(5)
        d = moves.make_move_draws([g], P * C, pa.n_events, pa.n_slots,
                                  1.0, 1.0, 1.0, cuda)
        evs, ns, act = moves.sample_move(
            pa, d, st.slots.repeat_interleave(C, 0))
        evs, ns, act = (x.reshape(P, C, 3) for x in (evs, ns, act))
        # a duplicate-event candidate, as a hot-mode self-swap makes
        evs[0, 0, 1] = evs[0, 0, 0]
        got = delta.delta_one(pa, st.slots, st.rooms, st.att, st.occ, evs,
                              ns, act)
        want = delta.delta_one_plain(pa, st.slots, st.rooms, st.att,
                                     st.occ, evs, ns, act)
        for w, g2 in zip(want, got):
            assert torch.equal(w, g2)


@pytest.mark.cuda
def test_launch_counters_count_launches(cuda):
    pa = _instances(cuda)[1]
    st = _state(pa, 4, 6)
    kernels.reset_launches()
    fitness.batch_penalty(pa, st.slots, st.rooms)
    rooms.assign_rooms(pa, st.slots)
    assert kernels.LAUNCHES["batch_penalty"] == 1
    assert kernels.LAUNCHES["assign_rooms"] == 1
    assert kernels.LAUNCHES["delta_one"] == 0


def test_cpu_tensors_take_the_plain_version():
    pa = random_instance(2, n_events=40, n_rooms=5, n_features=3,
                         n_students=30, attend_prob=0.1).device_arrays()
    st = _state(pa, 3, 7)
    kernels.reset_launches()
    got = fitness.batch_penalty(pa, st.slots, st.rooms)
    want = fitness.batch_penalty_plain(pa, st.slots, st.rooms)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(rooms.assign_rooms(pa, st.slots),
                       rooms.assign_rooms_plain(pa, st.slots))
    assert sum(kernels.LAUNCHES.values()) == 0


def test_library_paths_are_keyed_by_source_hash():
    paths = {n: kernels._lib_path(n) for n in kernels.SIGNATURES}
    assert len(set(paths.values())) == len(paths)
    for name, path in paths.items():
        assert path.parent == kernels.BUILD_DIR
        assert path.name.startswith(name + "-")
        assert (kernels.CSRC / f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_conflict_bits_and_csr_encode_the_problem():
    pa = padded_arrays(random_instance(4, n_events=50, n_rooms=4,
                                       n_features=3, n_students=40,
                                       attend_prob=0.1))
    bits = pa.conflict_bits.numpy().view(np.uint32)
    E = pa.n_events
    dec = ((bits[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1)
    dec = dec.reshape(E, -1)[:, :E].astype(bool)
    np.testing.assert_array_equal(dec, pa.conflict.numpy() > 0.5)
    att = pa.attends.numpy() > 0.5
    ptr, ev = pa.stu_ptr.numpy(), pa.stu_ev.numpy()
    for s in range(pa.n_students):
        assert ev[ptr[s]:ptr[s + 1]].tolist() == np.nonzero(att[s])[0].tolist()
    ptr, st = pa.ev_ptr.numpy(), pa.ev_stu.numpy()
    for e in range(E):
        assert st[ptr[e]:ptr[e + 1]].tolist() == \
            np.nonzero(att[:, e])[0].tolist()
    assert pa.max_ev_students == int(att.sum(0).max())
