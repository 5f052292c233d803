"""K11 (nsga.cu: ranks and crowding, survivors), built for the CPU with
the stand-in of tests/test_torch_cuda_emu.py, against their plain
versions. The file imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import emulated_fixture, K11_NO_WORDS
from tests.test_torch_kernels import (
    _island_state, K11_CASES, _k11_equal_plain, _k11_island)
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import nsga

torch.set_num_threads(1)

emulated = emulated_fixture("nsga", K11_NO_WORDS)


@pytest.mark.parametrize("L,pop,spread", [(1, 8, 3), (2, 5, 2), (3, 11, 40)])
def test_k11_sources_equal_plain(emulated, L, pop, spread):
    g = torch.Generator().manual_seed(pop)
    par, ch = (_island_state(L, pop, s) for s in (1, 2))
    par, ch = (x._replace(
        hcv=torch.randint(0, spread, (L * pop,), generator=g,
                          dtype=torch.int32),
        scv=torch.randint(0, 2 * spread, (L * pop,), generator=g,
                          dtype=torch.int32)) for x in (par, ch))
    got = nsga.rank_crowd_kernel(par.hcv, par.scv, L)
    want = nsga.rank_crowd_plain(par.hcv, par.scv, L)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    for keep in (pop, 2 * pop):
        got = nsga.survivors_kernel(par, ch, L, keep)
        want = nsga.survivors_plain(par, ch, L, keep)
        assert all(torch.equal(w, x) for w, x in zip(want, got))


def k11_cases(*idx):
    """K11_CASES[i] for each i, as test parameters with the ids they
    have in one list (case<i>)."""
    return [pytest.param(K11_CASES[i], id=f"case{i}") for i in idx]


def check_k11_edge_case(case):
    """K11 with two-warp blocks on one of K11_CASES, one launch of
    nsga_rank and three of nsga_survivors."""
    kernels.reset_launches()
    _k11_equal_plain(case, "cpu")
    assert kernels.LAUNCHES["nsga_rank"] == 1
    assert kernels.LAUNCHES["nsga_survivors"] == 3


# the edge cases are split with test_torch_cuda_emu_k11_edges.py (cases
# 1 and 3, the longest after case 2), so that under `--dist loadfile` no
# one worker carries them all
@pytest.mark.parametrize("case", k11_cases(0, 2, 4, 5, 6))
def test_k11_sources_equal_plain_on_edge_cases(emulated, case):
    """K11 with two-warp blocks: islands of 33-140 rows (two to five
    dominator words, rows strided over the block's threads), a strict
    chain (every row its own front), one front with every range 0,
    keep = 1 and keep = n, E = 7 and rows off 16 bytes (4-byte copies)
    and E = 8 aligned (16-byte ones)."""
    check_k11_edge_case(case)


@pytest.mark.parametrize("case", [K11_CASES[1], K11_CASES[3],
                                  K11_CASES[5]])
def test_k11_peel_without_dominator_words_equals_plain(emulated,
                                                       monkeypatch, case):
    """K11 built to keep no dominator words (as an island too large for
    them in shared memory runs) counts each row's words anew each round
    and equals the plain versions."""
    for n in kernels.SOURCES["nsga"]:
        monkeypatch.setitem(kernels._LIBS, n,
                            kernels._LIBS[K11_NO_WORDS + n])
    _k11_equal_plain(case, "cpu", seed=10)


def test_k11_refuses_an_island_above_the_shared_memory_limit(emulated,
                                                             monkeypatch):
    """An island whose state does not fit in shared memory even without
    the dominator words (n = 10,000: 6 n ints) is refused before any
    launch (the wrapper's kernels.launch raises on it)."""
    par = _k11_island(1, 5000, "random", 1, E=1)
    rcs = []
    monkeypatch.setattr(kernels, "launch", lambda name, *args, work=None: rcs.append(
        kernels._LIBS[name][1](*args, None)))
    nsga.survivors_kernel(par, par, 1, 5000)
    assert rcs == [2]                      # cudaErrorLaunchOutOfResources
