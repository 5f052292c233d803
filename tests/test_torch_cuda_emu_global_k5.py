"""K5's global-memory branch (csrc/sweep_pass.cu built with 128-thread
CTAs for the CPU stand-in of tests/test_torch_cuda_emu.py) against its
plain version: an individual's att, amask and occ past shared memory
(kernels.STAGE_LIMIT lowered, so small instances take the branch an
instance of thousands of students takes on the card), one copy an
individual, written by the cluster's rank 0 alone, at clusters of 1, 2
and 4 CTAs. The file imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import K5_SMALL, _tiny, emulated_fixture
from tests.test_torch_cuda_emu_k5 import CLUSTER_CASES
from tests.test_torch_kernels import (
    _half_feasible, _k5_equals_plain, _past_one_warp, _state)
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import delta, sweep

torch.set_num_threads(1)

emulated = emulated_fixture(K5_SMALL)


def k5_stage_limit(pa, sh, staged) -> int:
    """A STAGE_LIMIT at which K5 stages its Move1 masks and exactly the
    first `staged` of the state regions (occ, amask, att:
    delta.state_regions' order); None: nothing."""
    if staged is None:
        return 0
    saved, kernels.STAGE_LIMIT = kernels.STAGE_LIMIT, 0
    try:
        total, bits, _ = sweep.sweep_pass_layout(pa, sh)
    finally:
        kernels.STAGE_LIMIT = saved
    if bits:
        total -= delta.a16(4 * pa.n_events * pa.conflict_bits.shape[1])
    return total + delta.a16(8 * max(pa.max_ev_students, 1),
                             *delta.state_regions(pa)[:staged])


# (case, instance, state regions staged beside the Move1 masks, cluster
# sizes): nothing staged, the masks a global row a CTA too; occ and
# amask staged beside rank 0's att (the CTAs refresh their amask from
# it); occ alone
@pytest.mark.parametrize("case,inst,staged,clusters", [
    (CLUSTER_CASES[0], "tiny", None, (1, 2, 4)),
    (CLUSTER_CASES[1], "tiny", 2, (2, 4)),
    (CLUSTER_CASES[2], "wide", 1, (1, 2))])
def test_k5_global_branch_equals_plain(emulated, monkeypatch, case, inst,
                                       staged, clusters):
    """K5 with att (and amask, and occ, and the Move1 masks) in global
    memory, at clusters of 1, 2 and 4 CTAs over the cases, equals the
    plain pass from random and half-feasible starts, on the tiny
    instance and on one of 80 rooms."""
    monkeypatch.setitem(kernels._LIBS, "sweep_pass", kernels._LIBS[K5_SMALL])
    pa = _tiny() if inst == "tiny" else _past_one_warp(80, "cpu")
    sb, be, side, hot, p3 = case
    sh = sweep.sweep_shape(pa.n_events, pa.n_slots, sb, be, hot, p3)
    monkeypatch.setattr(kernels, "STAGE_LIMIT", k5_stage_limit(pa, sh,
                                                                staged))
    assert sweep.sweep_pass_layout(pa, sh)[2] == (
        0 if staged is None else (1 << staged) - 1 | sweep.K5_STAGE_MASKS)
    staged = staged or 0
    P = 2
    st = _state(pa, P, 60 + staged)
    draws = sweep.make_sweep_draws([torch.Generator().manual_seed(staged)],
                                   P, sh, pa.n_events, side, "cpu")
    kernels.reset_launches()
    _k5_equals_plain(pa, st, draws, case, clusters=clusters)
    _k5_equals_plain(pa, _half_feasible(st), draws, case,
                     clusters=clusters[-1:])
    assert kernels.LAUNCHES["sweep_pass"] == len(clusters) + 1
