"""K1 (assign_rooms.cu) and K6 (breed.cu: both tournament modes, the
greedy matcher, its fused scores, its base parents and its relocation
entry), built for the CPU with the stand-in of
tests/test_torch_cuda_emu.py, against their plain versions. The file
imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import emulated_fixture
from tests.test_torch_kernels import (
    _breed_case, _degenerate_slots, _instances, k1_k6_wide_equal_plain,
    K6_MODES, k6_parents_equal_plain, _matching_instances, _past_one_warp,
    _state, WIDE_R)
from timetabling_ga_tpu_torch.ops import fitness, ga, moves, nsga, rooms

torch.set_num_threads(1)

emulated = emulated_fixture("assign_rooms", "breed")


@pytest.mark.parametrize("inst", range(4))
def test_k1_k6_sources_equal_plain(emulated, inst):
    """K1 and K6 (both entries) on the four instances: random, padded
    (dead events and rooms) and anchored; crossover and mutation each on
    for some children and off for others, with tournament ties."""
    pa = _instances("cpu")[inst]
    st = _state(pa, 6, 20 + inst)
    assert torch.equal(rooms.assign_rooms_kernel(pa, st.slots),
                       rooms.assign_rooms_plain(pa, st.slots))
    pop, cfg, par, draws = _breed_case(pa, "cpu", 2, 3, 30 + inst)
    got = ga.make_children_kernel(pa, draws, par, groups=2)
    want = ga.make_children_plain(pa, draws, par, cfg, groups=2)
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    d = moves.make_move_draws([torch.Generator().manual_seed(inst)] * 3, 6,
                              pa.n_events, pa.n_slots, 1.0, 1.0, 1.0,
                              "cpu")
    chain = moves.MoveDraws(*(x.reshape((3, 6) + x.shape[1:]) for x in d))
    got = moves.relocation_chain_kernel(pa, chain, st.slots, st.rooms, 2)
    want = moves.relocation_chain_plain(pa, chain, st.slots, st.rooms, 2)
    assert all(torch.equal(w, g) for w, g in zip(want, got))


@pytest.mark.parametrize("inst", range(3))
def test_k1_k6_sources_match_degenerate_buckets(emulated, inst):
    """K1 and K6's crossover matching, slot by slot, on degenerate
    buckets: every event in one slot, two slots and the rest empty, half
    the events in one slot; R = 1; padded events and rooms."""
    pa = _matching_instances("cpu")[inst]
    slots = _degenerate_slots(pa, 3, 220 + inst)
    assert torch.equal(rooms.assign_rooms_kernel(pa, slots),
                       rooms.assign_rooms_plain(pa, slots))
    _, cfg, par, draws = _breed_case(pa, "cpu", 1, 3, 230 + inst, slots)
    draws = draws._replace(do_x=torch.ones_like(draws.do_x))
    got = ga.make_children_kernel(pa, draws, par, groups=1)
    want = ga.make_children_plain(pa, draws, par, cfg, groups=1)
    assert all(torch.equal(w, g) for w, g in zip(want, got))


@pytest.mark.parametrize("mode", ["greedy", "parallel", "crowded"])
@pytest.mark.parametrize("inst", [1, 2, 3])
def test_k6_fused_scores_equal_plain(emulated, inst, mode):
    """The (penalty, hcv, scv) K6 writes for each child from its epilogue
    equal batch_penalty_plain of the child it wrote, in the greedy and
    parallel matching modes and under the crowded tournament."""
    pa = _instances("cpu")[inst]
    _, cfg, par, draws = _breed_case(pa, "cpu", 2, 3, 400 + inst)
    mo = None
    if mode == "crowded":
        mo = nsga.rank_crowd_plain(par.hcv, par.scv, 2)
    got = ga.make_children_kernel(pa, draws, par, 2, mo,
                                  "parallel" if mode == "parallel"
                                  else "scan")
    want = fitness.batch_penalty_plain(pa, got.slots, got.rooms)
    assert all(torch.equal(w, g) for w, g in zip(want, got[2:]))


@pytest.mark.parametrize("mode", K6_MODES)
def test_k6_base_parents_source_equals_plain(emulated, mode):
    """K6's base parents in the greedy, crowded and parallel modes."""
    k6_parents_equal_plain(_instances("cpu")[2], "cpu", 500, mode,
                           shapes=((2, 3),))


@pytest.mark.parametrize("R", WIDE_R)
def test_k1_k6_sources_past_one_warp_equal_plain(emulated, R):
    """K1 (a slot of every event: two chunks of 32 events, each lane
    over two or three rooms), K6 greedy and crowded and its relocation
    entry at 33 and 80 rooms."""
    k1_k6_wide_equal_plain(_past_one_warp(R, "cpu"), "cpu", 700 + R)
