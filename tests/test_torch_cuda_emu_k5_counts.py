"""K5's accepted-move counts a row (`--quality`'s sweep counts), built
for the CPU, against the plain pass's. The file imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import K5_SMALL, _tiny, emulated_fixture
from tests.test_torch_cuda_emu_k5 import CLUSTER_CASES
from tests.test_torch_kernels import (
    K5_CASES, _half_feasible, _instances, _state, k5_ops_equal_plain)
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import sweep

torch.set_num_threads(1)

emulated = emulated_fixture("sweep_pass", K5_SMALL)


@pytest.mark.parametrize("case,inst,cluster", [
    (K5_CASES[0], 1, 1), (K5_CASES[3], 2, 1), (K5_CASES[1], "tiny", 1),
    (CLUSTER_CASES[0], "tiny", 2)])
def test_k5_move_counts_source_equals_plain(emulated, monkeypatch, case,
                                            inst, cluster):
    """K5's accepted Move1/Move2/Move3 counts a row, added to a given
    ops_in, against the plain pass's (hot pivots with sideways and
    3-cycles, blocks of pivots, the full permutation, a cluster of two
    CTAs), and its other outputs unchanged."""
    if cluster > 1:
        monkeypatch.setitem(kernels._LIBS, "sweep_pass",
                            kernels._LIBS[K5_SMALL])
    pa = _tiny() if inst == "tiny" else _instances("cpu")[inst]
    P = 2
    st = _state(pa, P, 50 + cluster)
    sb, be, side, hot, p3 = case
    sh = sweep.sweep_shape(pa.n_events, pa.n_slots, sb, be, hot, p3)
    draws = sweep.make_sweep_draws([torch.Generator().manual_seed(51)], P,
                                   sh, pa.n_events, side, "cpu")
    n = k5_ops_equal_plain(pa, st, draws, case, clusters=(cluster,))
    n = n + k5_ops_equal_plain(pa, _half_feasible(st), draws, case,
                               clusters=(cluster,))
    assert int(n.sum()) > 0
