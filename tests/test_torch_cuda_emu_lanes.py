"""The lane forms of the serve path (K6 and K8's chain with a lane
table), K13 (trace_compress.cu) and K14 (quality.cu), built for the CPU
with the stand-in of tests/test_torch_cuda_emu.py, against their
plain versions. The file imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import emulated_fixture
from tests.test_torch_kernels import (
    _instances, k13_equals_plain, k13_lanes_equal_plain, k14_div_equal_plain,
    k14_div_lanes_equal_plain, k14_ops_equal_plain, k6_lanes_equal_plain,
    k8_lanes_equal_plain, _lane_case, lane_counts, lane_masks, _lane_problems,
    moment_rows_equal_plain, _trace)
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import nsga
from timetabling_ga_tpu_torch.parallel import islands

torch.set_num_threads(1)

emulated = emulated_fixture("breed", "random_ls", "trace_compress", "quality")


@pytest.mark.parametrize("n_lanes", [2, 3])
def test_k6_k8_lane_tables_sources_equal_plain(emulated, n_lanes):
    """K6 (greedy and parallel matchers, both tournament modes) and K8's
    chain with a lane table against their lane-looped plain versions,
    each lane a different instance of one bucket (a full lane with the
    group's largest event, a lane padded in events and rooms with the
    shortest CSR, an anchored padded lane), built with 64-thread K6
    blocks and 2-warp K8 blocks whose rounds cross event chunks."""
    lp = _lane_problems(n_lanes)
    cfg, par, draws, rows, ls = _lane_case(lp, "cpu", 3, 70 + n_lanes)
    kernels.reset_launches()
    k6_lanes_equal_plain(lp, cfg, par, draws)
    k6_lanes_equal_plain(lp, cfg, par, draws, rooms_mode="parallel")
    k6_lanes_equal_plain(lp, cfg, par, draws,
                         nsga.rank_crowd_plain(par.hcv, par.scv, n_lanes))
    got = k8_lanes_equal_plain(lp, ls, rows)
    assert not torch.equal(got.slots, rows.slots)
    assert kernels.LAUNCHES["breed_lanes"] == 3
    assert kernels.LAUNCHES["random_ls_lanes"] == 1
    assert kernels.LAUNCHES["breed"] == kernels.LAUNCHES["random_ls"] == 0


@pytest.mark.parametrize("L,T", [(1, 1), (2, 8), (1, 33), (3, 64), (2, 200)])
@pytest.mark.parametrize("cap", [2, 64])
def test_k13_source_equals_plain(emulated, monkeypatch, L, T, cap):
    """K13's compress_trace in both modes (ties, long runs, sentinels,
    T not a multiple of 32, K below and above the counts) and its
    moment_rows entry."""
    monkeypatch.setattr(islands, "TRACE_DELTAS_CAP", cap)
    tr = _trace(L, T, 7 * T + cap, "cpu")
    for mode in ("deltas", "stats"):
        k13_equals_plain(tr, mode)
    moment_rows_equal_plain(tr[..., 0].contiguous(), tr[..., 1].contiguous())


@pytest.mark.parametrize("L,pop", [(1, 1), (1, 2), (2, 3), (4, 10),
                                   (2, 33), (3, 16)])
def test_k14_sources_equal_plain(emulated, L, pop):
    """K14's quality_ops (with and without the sweep's counts) and
    div_stats (pop 1 without Hamming pairs, 33 rows past the 32 pairs;
    on a padded instance, whose dead events never count) against their
    plain versions, with 64-thread blocks, so rows and pairs wrap."""
    pa = _instances("cpu")[2]
    kernels.reset_launches()
    k14_ops_equal_plain(L, pop, L + pop, "cpu", with_sweep=pop % 2 == 1)
    k14_div_equal_plain(pa, L, pop, L * pop)
    assert kernels.LAUNCHES["quality_ops"] == 1
    assert kernels.LAUNCHES["div_stats"] == 1


@pytest.mark.parametrize("L,T", [(1, 1), (3, 8), (4, 33), (3, 64),
                                 (2, 200)])
def test_k13_lanes_source_equals_plain(emulated, monkeypatch, L, T):
    """K13's lane form in both modes: a lane with count 0 (+inf and -inf
    exactly), a lane with count T, the rest between; cap 2 (overflow),
    64 and T."""
    tr = _trace(L, T, 11 * T + L, "cpu")
    nv = lane_counts(L, T, 3 * T + L)
    for mode in ("deltas", "stats"):
        for cap in (2, 64):
            monkeypatch.setattr(islands, "TRACE_DELTAS_CAP", cap)
            k13_lanes_equal_plain(tr, mode, nv)
        k13_lanes_equal_plain(tr, mode, nv, cap=T)


@pytest.mark.parametrize("L,pop", [(1, 2), (2, 3), (3, 10), (4, 33)])
def test_k14_div_lanes_source_equals_plain(emulated, L, pop):
    """K14's div_stats lane form, a mask row a lane: a lane with every
    event live, a lane padded to one live event, the rest between; pop
    33 past the 32 pairs, with 64-thread blocks."""
    k14_div_lanes_equal_plain(lane_masks(L, 40, L + pop), L, pop,
                              L * pop + 1)
