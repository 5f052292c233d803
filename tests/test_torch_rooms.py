"""The port's room matching (timetabling_ga_tpu_torch/ops/rooms.py, kernel
K1 and its plain version) against the JAX rooms ops: identical rooms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moves import (  # noqa: F401  (fixtures)
    arrays, padded_problem, t32)
from timetabling_ga_tpu.ops import rooms as jrooms
from timetabling_ga_tpu_torch.ops import rooms as trooms

torch.set_num_threads(1)


def _slots(problem, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, problem.n_slots,
                        (n, problem.n_events)).astype(np.int32)


@pytest.mark.parametrize("which", ["small", "medium", "padded"])
def test_assign_rooms_matches_jax(which, small_problem, medium_problem,
                                  padded_problem):
    problem = {"small": small_problem, "medium": medium_problem,
               "padded": padded_problem}[which]
    jpa, tpa = arrays(problem)
    slots = _slots(problem, 6, 3)
    want = jrooms.batch_assign_rooms(jpa, jnp.asarray(slots))
    got = trooms.assign_rooms(tpa, t32(slots))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_choose_room_occupancy_and_rank_match_jax(padded_problem):
    problem = padded_problem
    jpa, tpa = arrays(problem)
    np.testing.assert_array_equal(np.asarray(jrooms.capacity_rank(jpa)),
                                  trooms.capacity_rank(tpa).numpy())
    np.testing.assert_array_equal(np.asarray(jrooms._dead_rooms(jpa)),
                                  trooms._dead_rooms(tpa).numpy())
    slots = _slots(problem, 4, 8)
    rooms = np.asarray(jrooms.batch_assign_rooms(jpa, jnp.asarray(slots)))
    occ = jax.vmap(lambda s, r: jrooms.occupancy(jpa, s, r))(
        jnp.asarray(slots), jnp.asarray(rooms))
    tocc = trooms.occupancy(tpa, t32(slots), t32(rooms))
    np.testing.assert_array_equal(np.asarray(occ), tocc.numpy())
    ev = np.arange(problem.n_events, dtype=np.int32)
    for i in range(4):
        rows = np.asarray(occ[i])[slots[i]]             # (E, R)
        want = jax.vmap(lambda row, e: jrooms.choose_room(jpa, row, e))(
            jnp.asarray(rows), jnp.asarray(ev))
        got = trooms.choose_room(tpa, torch.from_numpy(rows),
                                 torch.from_numpy(ev), tpa.cap_rank)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_key_packing_bound_is_kept(small_problem):
    _, tpa = arrays(small_problem)
    big = tpa.__class__(**{**tpa.__dict__, "possible": torch.zeros(
        (4096, 2), dtype=torch.bool)})
    with pytest.raises(ValueError, match="4096"):
        trooms.assign_rooms(big, torch.zeros((1, 4096), dtype=torch.int32))
