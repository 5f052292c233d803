"""The port's random-candidate local search — the delta-scored form
(timetabling_ga_tpu_torch/ops/delta.py `batch_local_search_delta`,
kernel K8's plain version on the CPU) and the full re-evaluation form
(ops/local_search.py `batch_local_search`, kernel K12's plain version on
the CPU) — against the JAX package's, exactly, under the draws of the JAX
key tree, and against each other."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moves import (  # noqa: F401  (fixtures)
    _population, arrays, jax_ls_draws, padded_problem, t32)
from timetabling_ga_tpu.ops import delta as jdelta
from timetabling_ga_tpu.ops import local_search as jls
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import delta as tdelta
from timetabling_ga_tpu_torch.ops import local_search as tls

torch.set_num_threads(1)

P, ROUNDS, K = 5, 6, 4
PROBS = (1.0, 1.0, 0.5)


def _anchored(problem, seed):
    rng = np.random.default_rng(seed)
    return dataclasses.replace(
        problem,
        anchor_slots=rng.integers(0, problem.n_slots,
                                  problem.n_events).astype(np.int32),
        anchor_w=rng.integers(0, 4, problem.n_events).astype(np.int32))


@pytest.fixture(scope="module", params=["small", "padded", "anchored"])
def case(request, small_problem, padded_problem):
    problem = {"small": small_problem, "padded": padded_problem,
               "anchored": _anchored(small_problem, 3)}[request.param]
    jpa, tpa = arrays(problem)
    slots, rooms = _population(problem, P, 11)
    key = jax.random.key(17)
    draws = jax_ls_draws(key, ROUNDS, K, P, problem.n_events,
                         problem.n_slots, *PROBS)
    return problem, jpa, tpa, slots, rooms, key, draws


@pytest.mark.parametrize("form", ["delta", "full"])
def test_random_local_search_matches_jax(case, form):
    problem, jpa, tpa, slots, rooms, key, draws = case
    jfn = (jdelta.jit_batch_local_search_delta if form == "delta"
           else jls.jit_batch_local_search)
    want = jfn(jpa, key, jnp.asarray(slots), jnp.asarray(rooms),
               n_rounds=ROUNDS, n_candidates=K, p1=PROBS[0], p2=PROBS[1],
               p3=PROBS[2])
    tfn = (tdelta.batch_local_search_delta if form == "delta"
           else tls.batch_local_search)
    got = tfn(tpa, draws, t32(slots), t32(rooms))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert not np.array_equal(np.asarray(want[0]), slots)


def test_delta_and_full_eval_agree_on_torch_draws(medium_problem):
    """The two forms on the port's own draws (torch generators), with
    Move3s: the same search, so the same result."""
    _, tpa = arrays(medium_problem)
    slots, rooms = _population(medium_problem, 4, 12)
    draws = tdelta.make_ls_draws(
        [torch.Generator().manual_seed(i) for i in range(2)], 2, 5, 6,
        medium_problem.n_events, medium_problem.n_slots, 1.0, 1.0, 1.0,
        "cpu")
    assert tuple(draws.u.shape) == (5, 6, 4, medium_problem.n_events)
    a = tdelta.batch_local_search_delta(tpa, draws, t32(slots), t32(rooms))
    b = tls.batch_local_search(tpa, draws, t32(slots), t32(rooms))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_random_local_search_on_cpu_is_the_plain_version(case):
    _, _, tpa, slots, rooms, _, draws = case
    st = tdelta.init_rows(tpa, t32(slots), t32(rooms))
    kernels.reset_launches()
    got = tdelta.random_local_search(tpa, draws, st)
    assert sum(kernels.LAUNCHES.values()) == 0
    want = tdelta.random_local_search_plain(tpa, draws, st)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    # the delta-tracked penalty terms are the truth of the final genotypes
    again = tdelta.init_rows(tpa, got.slots, got.rooms)
    for w, g in zip(again, got):
        assert torch.equal(w, g)


def test_random_local_search_terms_match_jax_batch_penalty(case):
    """The penalty terms the delta search returns with its rows (K8's
    epilogue on the card, the plain version's full evaluation here)
    equal JAX batch_penalty of those rows; starting it from the rows'
    scores (as the generation does with K6's) gives the same result."""
    from timetabling_ga_tpu.ops import fitness as jfit
    _, jpa, tpa, slots, rooms, _, draws = case
    got = tdelta.batch_local_search_delta(tpa, draws, t32(slots),
                                          t32(rooms))
    want = jfit.batch_penalty(jpa, jnp.asarray(got.slots.numpy()),
                              jnp.asarray(got.rooms.numpy()))
    for w, g in zip(want, got[2:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    scores = tuple(torch.tensor(np.asarray(x)) for x in jfit.batch_penalty(
        jpa, jnp.asarray(slots), jnp.asarray(rooms)))
    again = tdelta.batch_local_search_delta(tpa, draws, t32(slots),
                                            t32(rooms), scores)
    for w, g in zip(got, again):
        assert torch.equal(w, g)


def test_full_eval_terms_match_jax_batch_penalty(case):
    """The penalty terms the full-evaluation search returns with its rows
    (K12's carried evaluations on the card, the plain version's here)
    equal JAX batch_penalty of those rows; starting it from the rows'
    scores gives the same result, and on the CPU it is the plain version
    (no launch)."""
    from timetabling_ga_tpu.ops import fitness as jfit
    _, jpa, tpa, slots, rooms, _, draws = case
    kernels.reset_launches()
    got = tls.batch_local_search(tpa, draws, t32(slots), t32(rooms))
    assert sum(kernels.LAUNCHES.values()) == 0
    want = jfit.batch_penalty(jpa, jnp.asarray(got.slots.numpy()),
                              jnp.asarray(got.rooms.numpy()))
    for w, g in zip(want, got[2:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    scores = tuple(torch.tensor(np.asarray(x)) for x in jfit.batch_penalty(
        jpa, jnp.asarray(slots), jnp.asarray(rooms)))
    again = tls.batch_local_search(tpa, draws, t32(slots), t32(rooms),
                                   scores)
    for w, g in zip(got, again):
        assert torch.equal(w, g)
