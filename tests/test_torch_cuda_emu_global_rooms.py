"""The global-memory branches of the room kernels, built for the CPU
with the stand-in of tests/test_torch_cuda_emu.py, against their plain
versions: K1's occupancy, K6's (greedy, crowded and parallel breeding:
the child's occupancy, the matcher's rank rows and suitability words;
its relocation entry's rows a block, then each row's occupancy) and
K9's (the rank rows and words), with kernels.STAGE_LIMIT lowered so
that small instances take the branches hundreds of rooms take on the
card, and blocks striding over the rows; and the lane forms of K6 and
K8's chain so. The file imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import emulated_fixture
from tests.test_torch_kernels import (
    _breed_case, _instances, _lane_case, _lane_problems,
    _matcher_equals_plain, _past_one_warp, _state, k1_k6_wide_equal_plain,
    k6_lanes_equal_plain, k8_lanes_equal_plain)
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import delta, ga, moves, nsga, rooms

torch.set_num_threads(1)

emulated = emulated_fixture("assign_rooms", "breed", "parallel_rooms",
                            "random_ls")


def _inst(inst):
    return (_instances("cpu")[inst] if inst < 4
            else _past_one_warp(inst, "cpu"))


@pytest.mark.parametrize("inst", [2, 33, 80])
def test_room_kernels_global_branches_equal_plain(emulated, monkeypatch,
                                                  inst):
    """K1, K6 (greedy and crowded breeding, the relocation entry, the
    parallel matcher with crossover on, off and mixed) and K9 with
    nothing staged that grows with the rooms equal their plain versions
    on the padded instance and at 33 and 80 rooms."""
    monkeypatch.setattr(kernels, "STAGE_LIMIT", 0)
    pa = _inst(inst)
    assert rooms.assign_rooms_stage(pa)[1] == 0
    assert rooms.parallel_rooms_stage(pa)[1] == 0
    # parallel: no rows, words or occupancy; greedy: no occupancy (it has
    # no rows nor words)
    assert ga.breed_stage(pa, True)[1] == 0
    assert ga.breed_stage(pa, False)[1] == 3
    assert moves.relocate_stage(pa)[1] == 0
    kernels.reset_launches()
    k1_k6_wide_equal_plain(pa, "cpu", 800 + inst)
    _matcher_equals_plain(pa, "cpu", 810 + inst)
    assert kernels.LAUNCHES["assign_rooms"] == 1
    assert kernels.LAUNCHES["parallel_rooms"] == 4


def test_k6_breed_staged_rows_beside_global_words(emulated, monkeypatch):
    """K6's parallel matcher with its rank rows staged but its
    suitability words and the child's occupancy in global memory (the
    university instance's split on the card), under the crowded
    tournament, equals the plain breeding."""
    pa = _past_one_warp(80, "cpu")
    fixed = ga.breed_stage(pa, True)
    rows_only = fixed[0] - 4 * pa.n_events * 3 - 4 * pa.n_slots * 80
    monkeypatch.setattr(kernels, "STAGE_LIMIT", rows_only)
    assert ga.breed_stage(pa, True)[1] == 1
    _, _, par, draws = _breed_case(pa, "cpu", 2, 3, 830)
    cfg = ga.GAConfig(pop_size=3, p3=0.4, rooms_mode="parallel",
                      multi_objective=True)
    mo = nsga.rank_crowd_plain(par.hcv, par.scv, 2)
    got = ga.make_children_kernel(pa, draws, par, 2, mo, "parallel")
    want = ga.make_children_plain(pa, draws, par, cfg, 2, mo)
    assert all(torch.equal(w, x) for w, x in zip(want, got))


@pytest.mark.parametrize("rows", [2, 1])
def test_k6_relocation_fewer_rows_a_block(emulated, monkeypatch, rows):
    """K6's relocation entry where four rows do not fit but two or one
    do takes that many rows a block, each staged, and equals the plain
    chain."""
    pa = _past_one_warp(33, "cpu")
    row = 4 * (2 * pa.n_events + pa.n_slots * pa.n_rooms)
    monkeypatch.setattr(kernels, "STAGE_LIMIT", rows * row)
    assert moves.relocate_stage(pa)[1] == rows
    st = _state(pa, 5, 840 + rows)
    d = moves.make_move_draws([torch.Generator().manual_seed(rows)] * 3, 5,
                              pa.n_events, pa.n_slots, 1.0, 1.0, 1.0, "cpu")
    chain = moves.MoveDraws(*(x.reshape((3, 5) + x.shape[1:]) for x in d))
    got = moves.relocation_chain_kernel(pa, chain, st.slots, st.rooms, 3)
    want = moves.relocation_chain_plain(pa, chain, st.slots, st.rooms, 3)
    assert all(torch.equal(w, g) for w, g in zip(want, got))


def test_lane_forms_global_branches_equal_plain(emulated, monkeypatch):
    """K6 (greedy and parallel) and K8's chain with a lane table, two
    jobs of one bucket, with nothing staged that grows with the students
    or the rooms, equal their lane-looped plain versions."""
    monkeypatch.setattr(kernels, "STAGE_LIMIT", 0)
    lp = _lane_problems(2)
    assert delta.random_ls_layout(lp.first, 4)[2] == 0
    cfg, par, draws, rows, ls = _lane_case(lp, "cpu", 3, 850)
    kernels.reset_launches()
    k6_lanes_equal_plain(lp, cfg, par, draws)
    k6_lanes_equal_plain(lp, cfg, par, draws, rooms_mode="parallel")
    k8_lanes_equal_plain(lp, ls, rows)
    assert kernels.LAUNCHES["breed_lanes"] == 2
    assert kernels.LAUNCHES["random_ls_lanes"] == 1
