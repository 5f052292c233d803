"""The generation under rooms_mode="parallel" past one warp of rooms
(tests/test_torch_ga.py has the other cases): the parallel matcher's
crossover rematch at 64 rooms and on 40 rooms padded to serve's
64-room bucket (dead rooms), the port against JAX bit for bit (33 and
80 rooms: test_torch_ga_wide.py).
"""

import pytest
import torch

from tests.test_torch_ga import check_generation_mode
from tests.test_torch_moves import wide_problem

torch.set_num_threads(1)


@pytest.mark.parametrize("which", [pytest.param(w, id=f"parallel-{w}")
                                   for w in ("r64", "r40pad64")])
def test_generation_nsga2_and_parallel_rooms_match_jax(which):
    check_generation_mode("parallel", wide_problem(which))
