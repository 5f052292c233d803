"""The port's room matching (timetabling_ga_tpu_torch/ops/rooms.py, kernel
K1 and its plain version) against the JAX rooms ops: identical rooms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moves import (  # noqa: F401  (fixtures)
    WIDE_ROOMS, arrays, padded_problem, t32, wide_problem)
from timetabling_ga_tpu.ops import rooms as jrooms
from timetabling_ga_tpu_torch.ops import rooms as trooms

torch.set_num_threads(1)


def _slots(problem, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, problem.n_slots,
                        (n, problem.n_events)).astype(np.int32)


@pytest.mark.parametrize("which", ["small", "medium", "padded",
                                   *WIDE_ROOMS])
def test_assign_rooms_matches_jax(which, small_problem, medium_problem,
                                  padded_problem):
    """K1's plain version against JAX's batch_assign_rooms, up to 80
    rooms (ties across a lane's rooms l, l + 32, ... go to the lowest)."""
    problem = {"small": small_problem, "medium": medium_problem,
               "padded": padded_problem}.get(which) or wide_problem(which)
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


@pytest.fixture(scope="module")
def tight_problem():
    from timetabling_ga_tpu.problem import room_tight_instance
    return room_tight_instance(11, n_events=60, n_rooms=6, n_features=4,
                               n_students=50, attend_prob=0.08)


# past one warp of rooms at 4 rounds (each case is a JAX compile of its
# own, several seconds on the CPU)
@pytest.mark.parametrize("n_rounds,which", [
    *(pytest.param(n, w, id=f"{n}-{w}") for n in (1, 2, 3, 4)
      for w in ("small", "tight", "padded")),
    *(pytest.param(4, w, id=f"4-{w}") for w in WIDE_ROOMS)])
def test_parallel_matcher_matches_jax(which, n_rounds, small_problem,
                                      tight_problem, padded_problem):
    """augment_rooms from random incoming rooms and parallel_assign_rooms
    (best-fit start), both against the JAX matcher vmapped over rows, on
    random, room-tight and padded instances (padded rows carry random
    slots on their dead events, which keep their incoming room), and
    past one warp of rooms (several suitability words an event)."""
    problem = {"small": small_problem, "tight": tight_problem,
               "padded": padded_problem}.get(which) or wide_problem(which)
    jpa, tpa = arrays(problem)
    slots = _slots(problem, 5, 20 + n_rounds)
    # crowded slots make the augments and the park rounds do work; past
    # 32 rooms, every event of row 0 in one slot and the rest in two
    slots[:, ::2] = slots[:, ::2] % 3
    if which in WIDE_ROOMS:
        slots[0] = 0
        slots[1:] %= 2
    rng = np.random.default_rng(n_rounds)
    rooms = rng.integers(0, problem.n_rooms, slots.shape).astype(np.int32)
    want = jax.jit(jax.vmap(lambda s, r: jrooms.augment_rooms(
        jpa, s, r, n_rounds)))(
        jnp.asarray(slots), jnp.asarray(rooms))
    got = trooms.augment_rooms(tpa, t32(slots), t32(rooms), n_rounds)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    want = jax.jit(jax.vmap(lambda s: jrooms.parallel_assign_rooms(
        jpa, s, n_rounds)))(jnp.asarray(slots))
    got = trooms.parallel_assign_rooms(tpa, t32(slots), n_rounds)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
