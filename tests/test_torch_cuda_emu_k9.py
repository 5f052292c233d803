"""K9 (parallel_rooms.cu) and K6's parallel matcher, built for the CPU
with the stand-in of tests/test_torch_cuda_emu.py, against their
plain versions. The file imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import emulated_fixture
from tests.test_torch_kernels import (
    _breed_case, _chained_augments, _instances, _matcher_equals_plain,
    _matching_instances, _past_one_warp, _state, WIDE_R, _wide_rooms)
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import ga, nsga, rooms

torch.set_num_threads(1)

emulated = emulated_fixture("parallel_rooms", "breed")


@pytest.mark.parametrize("inst", range(4))
def test_k9_and_k6_new_modes_equal_plain(emulated, inst):
    """K9 (augment_rooms from random rooms at 1 and 4 rounds, and
    parallel_assign_rooms) and K6's parallel matcher and crowded
    tournament on the four instances, slots crowded into few slots so
    the augments and the park rounds run."""
    pa = _instances("cpu")[inst]
    st = _state(pa, 5, 100 + inst)
    slots = st.slots.clone()
    slots[:, ::2] %= 3
    g = torch.Generator().manual_seed(inst)
    rms = torch.randint(0, pa.n_rooms, slots.shape, generator=g,
                        dtype=torch.int32)
    kernels.reset_launches()
    for n in (1, 4):
        assert torch.equal(rooms.augment_rooms_kernel(pa, slots, rms, n),
                           rooms.augment_rooms_plain(pa, slots, rms, n))
    assert torch.equal(rooms.augment_rooms_kernel(pa, slots, None),
                       rooms.parallel_assign_rooms(pa, slots))
    assert kernels.LAUNCHES["parallel_rooms"] == 3
    _, cfg, par, draws = _breed_case(pa, "cpu", 2, 3, 110 + inst)
    cfg = ga.GAConfig(pop_size=3, p3=0.4, rooms_mode="parallel",
                      multi_objective=True)
    mo = nsga.rank_crowd_plain(par.hcv, par.scv, 2)
    got = ga.make_children_kernel(pa, draws, par, 2, mo, "parallel")
    want = ga.make_children_plain(pa, draws, par, cfg, 2, mo)
    assert all(torch.equal(w, x) for w, x in zip(want, got))


@pytest.mark.parametrize("inst", range(4))
def test_k9_k6_parallel_matcher_on_edge_cases(emulated, inst):
    """The parallel matcher (K9 and K6, two-warp blocks, a warp a slot)
    on a slot holding every event (more than 32: several chunks and the
    claimed mask between them), R = 1, padded events and rooms and R =
    32, at 0, 1 and 4 rounds, K6 with crossover on, off and mixed."""
    pa = (_matching_instances("cpu") + [_wide_rooms("cpu")])[inst]
    kernels.reset_launches()
    _matcher_equals_plain(pa, "cpu", 270 + inst)
    assert kernels.LAUNCHES["parallel_rooms"] == 4
    assert kernels.LAUNCHES["breed"] == 3


def check_chained_augments(shift):
    """`_chained_augments` with its rooms `shift` ranks up: the plain
    version and K9 from the given rooms at 2 and 4 rounds, and K9 from
    best-fit ones, give the expected rooms."""
    pa, slots, rms, want = _chained_augments("cpu", shift)
    for n in (2, 4):
        assert torch.equal(rooms.augment_rooms_plain(pa, slots, rms, n), want)
        assert torch.equal(rooms.augment_rooms_kernel(pa, slots, rms, n),
                           want)
    assert torch.equal(rooms.augment_rooms_kernel(pa, slots, None), want)


def test_k9_augments_after_a_round_without_grabs(emulated):
    """A round of length-3 augments that follows a round in which no
    event grabbed a free room still runs (`_chained_augments`: the second
    round's augment matches event 3), from the given rooms and from
    best-fit ones, at 2 and 4 rounds."""
    check_chained_augments(0)


@pytest.mark.parametrize("shift", [27, 32, 70])
def test_k9_augments_past_one_warp(emulated, shift):
    """The same chain of augments with 27, 32 or 70 unsuitable rooms
    before its five: its ranks straddle the first two words, lie in the
    second, or in the third, so each grab, eviction and park reads the
    words past the first."""
    check_chained_augments(shift)


@pytest.mark.parametrize("R", WIDE_R)
def test_k9_k6_parallel_matcher_past_one_warp_equals_plain(emulated, R):
    """K9 and K6's parallel matcher at 33 and 80 rooms (two and three
    suitability words an event, the vacant, movable and bid-for words of
    a slot), on degenerate slot buckets, at 0, 1 and 4 rounds."""
    kernels.reset_launches()
    _matcher_equals_plain(_past_one_warp(R, "cpu"), "cpu", 740 + R)
    assert kernels.LAUNCHES["parallel_rooms"] == 4
