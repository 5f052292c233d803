"""The rest of K5's one-CTA passes (tests/test_torch_cuda_emu_k5.py has
the others): the longest, K5_CASES[5] on the tiny instance, with two
short hot-pivot passes, and one at 300 rooms. The file imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import emulated_fixture
from tests.test_torch_cuda_emu_k5 import check_k5_pass, k5_passes
from tests.test_torch_kernels import K5_CASES

torch.set_num_threads(1)

emulated = emulated_fixture("sweep_pass")


@pytest.mark.parametrize("case,inst", k5_passes(2, 3, 5))
def test_k5_source_equals_plain(emulated, case, inst):
    check_k5_pass(case, inst)


def test_k5_source_past_one_warp_equals_plain(emulated):
    """One-CTA K5 at 300 rooms (hot pivots, sideways and 3-cycles): the
    K4 body's choice over ten rooms a lane and the candidates' rooms in
    their 12-bit packing beside hcv (rooms past 255 reach the high
    word)."""
    check_k5_pass(K5_CASES[0], "wide")
