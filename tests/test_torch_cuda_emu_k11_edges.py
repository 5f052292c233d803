"""The rest of K11's edge cases (tests/test_torch_cuda_emu_k11.py has
the others): islands of 64 rows over two islands and a strict chain of
40, built for the CPU with the stand-in of tests/test_torch_cuda_emu.py,
against their plain versions. The file imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import emulated_fixture
from tests.test_torch_cuda_emu_k11 import check_k11_edge_case, k11_cases

torch.set_num_threads(1)

emulated = emulated_fixture("nsga")


@pytest.mark.parametrize("case", k11_cases(1, 3))
def test_k11_sources_equal_plain_on_edge_cases(emulated, case):
    """K11 with two-warp blocks on K11_CASES 1 and 3 (the rest and what
    they hold: tests/test_torch_cuda_emu_k11.py)."""
    check_k11_edge_case(case)
