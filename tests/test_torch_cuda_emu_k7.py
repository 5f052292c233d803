"""K7 (survivors.cu: survivors, migrate and its gain), built for the
CPU with the stand-in of tests/test_torch_cuda_emu.py, against their
plain versions. The file imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import emulated_fixture
from tests.test_torch_kernels import _island_state, k7_gain_equal_plain
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import ga
from timetabling_ga_tpu_torch.parallel import islands

torch.set_num_threads(1)

emulated = emulated_fixture("survivors")


@pytest.mark.parametrize("L,pop", [(1, 3), (2, 2), (4, 3), (2, 16), (1, 2),
                                   (1, 16), (2, 3), (4, 2), (4, 16),
                                   (16, 2), (16, 3), (16, 16)])
def test_k7_sources_equal_plain(emulated, L, pop):
    """K7's survivors (parents + children, and the sort alone) and
    migrate at L = 1, 2, 4, 16 islands of 2, 3 and 16 rows: a grid of
    ceil(keep / 2) blocks an island, each copying two rows, with rows of
    E = 8 (16-byte copies), E = 6 (8-byte ones) and E = 7 int32 (4-byte
    ones)."""
    for E in (8, 6, 7):
        par = _island_state(L, pop, 1, E=E)
        ch = _island_state(L, pop, 2, E=E)
        kernels.reset_launches()
        got = ga.survivors_kernel(par, ch, groups=L, keep=pop)
        want = ga.survivors_plain(par, ch, groups=L, keep=pop)
        assert all(torch.equal(w, g) for w, g in zip(want, got))
        got = ga.survivors_kernel(par, groups=L)
        want = ga.survivors_plain(par, groups=L)
        assert all(torch.equal(w, g) for w, g in zip(want, got))
        got = islands.migrate(want, L) if pop < 3 else \
            islands.migrate_kernel(want, L)
        assert all(torch.equal(w, g)
                   for w, g in zip(islands.migrate_plain(want, L), got))
        assert kernels.LAUNCHES["survivors"] == 2
        assert kernels.LAUNCHES["migrate"] == (1 if pop >= 3 else 0)


@pytest.mark.parametrize("L,pop", [(1, 3), (2, 2), (4, 3), (2, 16),
                                   (16, 3)])
def test_k7_migrate_gain_source_equals_plain(emulated, L, pop):
    """K7's migrate with its gain, rows of E = 8 and E = 7 int32."""
    for E in (8, 7):
        gain = k7_gain_equal_plain(L, pop, E, "cpu")
        assert (int(gain.sum()) > 0) == (L > 1 and pop >= 3)
