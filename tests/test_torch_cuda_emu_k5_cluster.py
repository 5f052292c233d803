"""K5 as thread-block clusters (csrc/sweep_pass.cu built with 128-thread
CTAs, the stand-in running a cluster's blocks at once), against its
plain version, and the refused cluster. The file imports no JAX.
"""

import ctypes

import pytest
import torch

from tests.test_torch_cuda_emu import K5_SMALL, _tiny, emulated_fixture
from tests.test_torch_cuda_emu_k5 import CLUSTER_CASES
from tests.test_torch_kernels import _half_feasible, _k5_equals_plain, _state
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import sweep

torch.set_num_threads(1)

emulated = emulated_fixture("sweep_pass", K5_SMALL)


@pytest.mark.parametrize("cluster", [2, 4])
@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_k5_cluster_source_equals_plain(emulated, monkeypatch, case,
                                        cluster):
    """K5 as clusters of 2 and 4 CTAs, each CTA on its own shared memory
    and the choice reduced through the others' (the stand-in runs a
    cluster's blocks at once), equals the plain pass from random and
    half-feasible starts. The CTAs have 128 threads, so the Move2/Move3
    candidates wrap around the cluster's 8 or 16 warps."""
    monkeypatch.setitem(kernels._LIBS, "sweep_pass", kernels._LIBS[K5_SMALL])
    pa = _tiny()
    P = 2
    st = _state(pa, P, 30 + cluster)
    sb, be, side, hot, p3 = case
    sh = sweep.sweep_shape(pa.n_events, pa.n_slots, sb, be, hot, p3)
    draws = sweep.make_sweep_draws([torch.Generator().manual_seed(cluster)],
                                   P, sh, pa.n_events, side, "cpu")
    kernels.reset_launches()
    _k5_equals_plain(pa, st, draws, case, clusters=(cluster,))
    _k5_equals_plain(pa, _half_feasible(st), draws, case,
                     clusters=(cluster,))
    assert kernels.LAUNCHES["sweep_pass"] == 2


def test_k5_refused_cluster_is_not_shrunk(emulated, monkeypatch):
    """When the card can place no cluster of the asked size, K5's entry
    point returns an error before it launches anything (the wrapper's
    kernels.launch raises on it), and no smaller cluster is tried."""
    pa = _tiny()
    st = _state(pa, 2, 3)
    sh = sweep.sweep_shape(pa.n_events, pa.n_slots, 3, 1, 0, 0.0)
    draws = sweep.make_sweep_draws([torch.Generator().manual_seed(0)], 2,
                                   sh, pa.n_events, 0.0, "cpu")
    lib = kernels._LIBS["sweep_pass"][0]
    answer = ctypes.c_int.in_dll(lib, "emu_max_active_clusters")
    rcs = []
    monkeypatch.setattr(kernels, "launch", lambda name, *args: rcs.append(
        kernels._LIBS[name][1](*args, None)))
    answer.value = 0
    try:
        sweep.sweep_pass_kernel(pa, draws, st, 3, cluster=3)
    finally:
        answer.value = 1
    assert rcs == [2]                      # cudaErrorLaunchOutOfResources
