"""The rest of K5's one-CTA passes (tests/test_torch_cuda_emu_k5.py has
the others): the longest, K5_CASES[5] on the tiny instance, with two
short hot-pivot passes. The file imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import emulated_fixture
from tests.test_torch_cuda_emu_k5 import check_k5_pass, k5_passes

torch.set_num_threads(1)

emulated = emulated_fixture("sweep_pass")


@pytest.mark.parametrize("case,inst", k5_passes(2, 3, 5))
def test_k5_source_equals_plain(emulated, case, inst):
    check_k5_pass(case, inst)
