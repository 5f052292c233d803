"""The generation past one warp of rooms (tests/test_torch_ga.py has
the other cases): 33 and 80 rooms, the port against JAX bit for bit
(64 rooms and 40 rooms padded to serve's 64-room bucket are the
parallel matcher's cases, test_torch_ga_wide_parallel.py; each case is
a JAX compile of its own, ~40 s on the CPU).
"""

import pytest
import torch

from tests.test_torch_ga import check_generation
from tests.test_torch_moves import wide_problem

torch.set_num_threads(1)


@pytest.mark.parametrize("which", ["r33", "r80"])
def test_generation_matches_jax_bit_for_bit(which):
    check_generation(wide_problem(which))
