"""The port's fitness (timetabling_ga_tpu_torch/ops/fitness.py, kernel K2
and its plain version) against the JAX batch_penalty, exactly."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moves import (  # noqa: F401  (fixtures)
    arrays, padded_problem, t32)
from timetabling_ga_tpu.ops import fitness as jfit
from timetabling_ga_tpu.problem import load_tim_file
from timetabling_ga_tpu_torch.ops import fitness as tfit

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_pop(problem, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, problem.n_slots, (n, problem.n_events)),
            rng.integers(0, problem.n_rooms, (n, problem.n_events)))


def _anchored(problem, seed):
    rng = np.random.default_rng(seed)
    return dataclasses.replace(
        problem,
        anchor_slots=rng.integers(0, problem.n_slots,
                                  problem.n_events).astype(np.int32),
        anchor_w=rng.integers(0, 4, problem.n_events).astype(np.int32))


@pytest.mark.parametrize("which", ["small", "medium", "padded", "anchored"])
def test_batch_penalty_plain_matches_jax(which, small_problem,
                                         medium_problem, padded_problem):
    problem = {"small": small_problem, "medium": medium_problem,
               "padded": padded_problem,
               "anchored": _anchored(medium_problem, 4)}[which]
    jpa, tpa = arrays(problem)
    slots, rooms = _random_pop(problem, 8, 11)
    want = jfit.batch_penalty(jpa, jnp.asarray(slots, jnp.int32),
                              jnp.asarray(rooms, jnp.int32))
    got = tfit.batch_penalty(tpa, t32(slots), t32(rooms))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    if which == "anchored":
        assert int(np.asarray(want[0]).max()) > 0


@pytest.mark.parametrize("name", ["comp01s", "comp05s"])
def test_witness_scores_zero(name):
    problem = load_tim_file(os.path.join(_REPO, "fixtures", f"{name}.tim"))
    with open(os.path.join(_REPO, "fixtures", f"{name}.witness.json")) as f:
        w = json.load(f)
    slots = np.asarray([w["slots"]], np.int32)
    rooms = np.asarray([w["rooms"]], np.int32)
    jpa, tpa = arrays(problem)
    pen, hcv, scv = tfit.batch_penalty(tpa, t32(slots), t32(rooms))
    assert (int(pen[0]), int(hcv[0]), int(scv[0])) == (0, 0, 0)
    want = jfit.batch_penalty(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    assert [int(np.asarray(x)[0]) for x in want] == [0, 0, 0]


def test_lex_order_and_tournament_tie_order():
    rng = np.random.default_rng(0)
    pen = rng.integers(0, 3, (5, 12)).astype(np.int32)
    scv = rng.integers(0, 3, (5, 12)).astype(np.int32)
    got = tfit.lex_order(torch.from_numpy(pen), torch.from_numpy(scv))
    for i in range(5):
        np.testing.assert_array_equal(
            np.asarray(jfit.lex_order(jnp.asarray(pen[i]),
                                      jnp.asarray(scv[i]))), got[i].numpy())


def test_anchor_terms_match_jax(medium_problem):
    problem = _anchored(medium_problem, 9)
    jpa, tpa = arrays(problem)
    slots, _ = _random_pop(problem, 4, 2)
    rng = np.random.default_rng(3)
    evs = rng.integers(0, problem.n_events, (4, 3)).astype(np.int32)
    ns = rng.integers(0, problem.n_slots, (4, 3)).astype(np.int32)
    for i in range(4):
        assert int(jfit.anchor_cost(jpa, jnp.asarray(slots[i]))) == int(
            tfit.anchor_cost(tpa, t32(slots[i:i + 1]))[0])
        assert int(jfit.anchor_delta(jpa, jnp.asarray(slots[i]),
                                     jnp.asarray(evs[i]),
                                     jnp.asarray(ns[i]))) == int(
            tfit.anchor_delta(tpa, t32(slots[i:i + 1]), t32(evs[i:i + 1]),
                              t32(ns[i:i + 1]))[0])


@pytest.mark.parametrize("which,pop", [
    ("tiny", 16), ("small", 8), ("medium", 4), ("room_tight", 6)])
def test_fitness_matches_scalar_oracle(which, pop, tiny_problem,
                                       small_problem, medium_problem):
    """The port's batch_penalty (its plain version on the CPU) against
    the scalar oracle (oracle/reference_oracle.py: Solution.cpp:63-170
    transcribed), exactly, on random rows; the terms too."""
    from timetabling_ga_tpu.oracle import (
        oracle_hcv, oracle_penalty, oracle_scv)
    from timetabling_ga_tpu_torch.problem import room_tight_instance
    problem = {"tiny": tiny_problem, "small": small_problem,
               "medium": medium_problem,
               "room_tight": room_tight_instance(
                   5, n_events=30, n_rooms=3, n_features=5,
                   n_students=25)}[which]
    _, tpa = arrays(problem)
    slots, rooms = _random_pop(problem, pop, 42)
    pen, hcv, scv = tfit.batch_penalty(tpa, t32(slots), t32(rooms))
    th = tfit.compute_hcv(tpa, t32(slots), t32(rooms))
    ts = tfit.compute_scv(tpa, t32(slots))
    for i in range(pop):
        want_h = oracle_hcv(problem, slots[i], rooms[i])
        want_s = oracle_scv(problem, slots[i])
        assert int(hcv[i]) == int(th[i]) == want_h, i
        assert int(scv[i]) == int(ts[i]) == want_s, i
        assert int(pen[i]) == oracle_penalty(problem, slots[i], rooms[i]), i
