"""K5's sweep pass (csrc/sweep_pass.cu), built for the CPU with the
stand-in of tests/test_torch_cuda_emu.py, against its plain version:
one CTA a row. The passes are split between this file and
test_torch_cuda_emu_k5_tiny.py (and the cluster and move-count tests
have files of their own), so that under `--dist loadfile` no one worker
carries them all. The file imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import _tiny, emulated_fixture
from tests.test_torch_kernels import (
    K5_CASES, _half_feasible, _instances, _k5_equals_plain, _state)
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import sweep

torch.set_num_threads(1)

emulated = emulated_fixture("sweep_pass")

# short passes (hot pivots, or the tiny instance's 24-event permutation
# in blocks of 2): the stand-in takes ~0.1 s per block and step
K5_PASSES = [(K5_CASES[0], 1), (K5_CASES[2], 3), (K5_CASES[3], 2),
             (K5_CASES[4], 0), (K5_CASES[1], "tiny"), (K5_CASES[5], "tiny")]

# passes whose candidates spread over a cluster: 11 partners and their
# 3-cycles (31 Move2/Move3 candidates a step, more than the 8 or 16 warps
# of two or four 128-thread CTAs) on 8 hot pivots, with sideways; the
# tiny instance's full permutation in blocks of two pivots, whose Move1
# goes to two ranks; hot pivots with sideways and 3-cycles
CLUSTER_CASES = [(11, 1, 0.3, 8, 0.2), (3, 2, 0.0, 0, 0.0), K5_CASES[0]]


def k5_passes(*idx):
    """K5_PASSES[i] for each i, as test parameters with the ids they
    have in one list (case<i>-<instance>)."""
    return [pytest.param(*K5_PASSES[i], id=f"case{i}-{K5_PASSES[i][1]}")
            for i in idx]


def check_k5_pass(case, inst):
    """One-CTA K5 on `inst` from a random and a half-feasible start
    equals the plain pass, in one launch each."""
    pa = _tiny() if inst == "tiny" else _instances("cpu")[inst]
    inst = 4 if inst == "tiny" else inst
    P = 2
    st = _state(pa, P, 8 + inst)
    sb, be, side, hot, p3 = case
    sh = sweep.sweep_shape(pa.n_events, pa.n_slots, sb, be, hot, p3)
    draws = sweep.make_sweep_draws([torch.Generator().manual_seed(9)], P,
                                   sh, pa.n_events, side, "cpu")
    kernels.reset_launches()
    _k5_equals_plain(pa, st, draws, case, clusters=(1,))
    _k5_equals_plain(pa, _half_feasible(st), draws, case, clusters=(1,))
    assert kernels.LAUNCHES["sweep_pass"] == 2


@pytest.mark.parametrize("case,inst", k5_passes(0, 1, 4))
def test_k5_source_equals_plain(emulated, case, inst):
    check_k5_pass(case, inst)
