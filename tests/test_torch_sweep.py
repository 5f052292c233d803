"""The port's sweep local search (timetabling_ga_tpu_torch/ops/sweep.py:
the plain versions of kernels K3 and K5 and the hot pivot pick) against
the JAX sweep, exactly, under draws mirrored from the JAX key tree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moves import (  # noqa: F401  (fixtures)
    _population, arrays, jax_sweep_draws, jax_sweep_draws_fn,
    padded_problem, t32, wide_problem)
from timetabling_ga_tpu.ops import delta as jdelta
from timetabling_ga_tpu.ops import sweep as jsweep
from timetabling_ga_tpu.ops.ga import GAConfig as JGAConfig
from timetabling_ga_tpu.ops.rooms import capacity_rank
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.convert import ls_state_from_numpy
from timetabling_ga_tpu_torch.ops import delta as tdelta
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.ops import sweep as tsweep

torch.set_num_threads(1)

P = 4


def _state(problem, seed):
    jpa, tpa = arrays(problem)
    slots, rooms = _population(problem, P, seed)
    jst = jdelta.init_state(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    return jpa, tpa, jst, ls_state_from_numpy(jst)


@pytest.mark.parametrize("which", ["medium", "padded"])
def test_move1_sweep_and_heat_match_jax(which, medium_problem,
                                        padded_problem):
    problem = medium_problem if which == "medium" else padded_problem
    jpa, tpa, jst, st = _state(problem, 2)
    piv = np.stack([np.random.default_rng(i).choice(problem.n_events, 3,
                                                    replace=False)
                    for i in range(P)]).astype(np.int32)
    cap = capacity_rank(jpa)
    want = jax.jit(jax.vmap(lambda s, r, a, o, es: jax.vmap(
        lambda e: jsweep._move1_sweep(jpa, s, r, a, o, e, cap))(es)))(
        jst.slots, jst.rooms, jst.att, jst.occ, jnp.asarray(piv))
    got = tsweep.move1_sweep(tpa, st.slots, st.rooms, st.att, st.occ,
                             t32(piv))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    heat_fn = jax.jit(jax.vmap(lambda s, r, a, o, h: jsweep.event_heat(
        jpa, s, r, a, o, h)))
    heat = heat_fn(jst.slots, jst.rooms, jst.att, jst.occ,
                   jnp.zeros_like(jst.hcv))                 # scv heat
    np.testing.assert_array_equal(
        np.asarray(heat), tsweep.event_heat(
            tpa, st.slots, st.rooms, st.att, st.occ,
            torch.zeros_like(st.hcv)).numpy())
    heat = heat_fn(jst.slots, jst.rooms, jst.att, jst.occ, jst.hcv)
    np.testing.assert_array_equal(
        np.asarray(heat), tsweep.event_heat(
            tpa, st.slots, st.rooms, st.att, st.occ, st.hcv).numpy())


@pytest.mark.parametrize("which", ["noise", "zero_noise", "padded"])
def test_hot_pivots_match_jax_top_k(which, medium_problem, padded_problem):
    """hot_pivots against lax.top_k(event_heat + noise, K): with all-zero
    noise the integer heat ties everywhere and the index order decides
    (lower first); the padded instance's masked events are all cold."""
    problem = padded_problem if which == "padded" else medium_problem
    jpa, tpa, jst, st = _state(problem, 3)
    E, K = problem.n_events, 17
    noise = np.random.default_rng(4).uniform(0.0, 0.9, (P, E)).astype(
        np.float32)
    if which == "zero_noise":
        noise[:] = 0.0
    for hcv in (jst.hcv, jnp.zeros_like(jst.hcv)):      # hcv / scv heat
        heat = jax.vmap(lambda s, r, a, o, h: jsweep.event_heat(
            jpa, s, r, a, o, h))(jst.slots, jst.rooms, jst.att, jst.occ, hcv)
        want = jax.lax.top_k(heat + jnp.asarray(noise), K)[1]
        got = tsweep.hot_pivots(tpa, st._replace(hcv=t32(hcv)),
                                torch.from_numpy(noise), K)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


# (swap_block, block_events, sideways, hot_k, p3): hot-K with sideways
# and 3-cycles; full-permutation blocked descent with a padded instance;
# an anchored objective
PASS_CASES = [(4, 1, 0.5, 12, 0.3, "medium"), (3, 2, 0.0, 0, 0.0, "padded"),
              (3, 1, 0.25, 10, 0.0, "anchored"),
              (4, 1, 0.25, 12, 0.3, "r80")]


def _anchored(problem):
    rng = np.random.default_rng(6)
    return dataclasses.replace(
        problem,
        anchor_slots=rng.integers(0, problem.n_slots,
                                  problem.n_events).astype(np.int32),
        anchor_w=rng.integers(0, 3, problem.n_events).astype(np.int32))


@pytest.mark.parametrize("case", PASS_CASES)
def test_sweep_pass_matches_jax(case, medium_problem, padded_problem):
    sb, be, side, hot, p3, which = case
    problem = {"medium": medium_problem, "padded": padded_problem,
               "anchored": _anchored(medium_problem)}.get(which) \
        or wide_problem(which)
    jpa, tpa, jst, st = _state(problem, 5)
    key = jax.random.key(11)
    want, improved = jax.jit(jsweep.sweep_pass, static_argnums=range(3, 8))(
        jpa, key, jst, sb, be, side, hot, p3)
    draws = jax_sweep_draws(key, P, problem.n_events, problem.n_slots, sb,
                            be, side, hot, p3)
    got, rows = tsweep.sweep_pass(tpa, draws, st, sb, be, side, hot, p3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert bool(improved) == bool(rows.any())


def test_sweep_pass_on_cpu_is_the_plain_version(medium_problem):
    _, tpa, _, st = _state(medium_problem, 6)
    cfg = tga.GAConfig(ls_swap_block=3, ls_sideways=0.25, ls_hot_k=10)
    draws = tga.sweep_draws_fn([torch.Generator().manual_seed(2)], P, tpa,
                               cfg)(0)
    kernels.reset_launches()
    got, rows = tsweep.sweep_pass(tpa, draws, st, 3, 1, 0.25, 10)
    assert sum(kernels.LAUNCHES.values()) == 0
    want, want_rows = tsweep.sweep_pass_plain(tpa, draws, st, 3, 1, 0.25,
                                              10)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert torch.equal(want_rows, rows)
    assert not torch.equal(got.slots, st.slots)


def test_converge_sweep_local_search_matches_jax(medium_problem):
    jpa, tpa, jst, st = _state(medium_problem, 8)
    cfg = JGAConfig(ls_swap_block=3, ls_sideways=0.25, ls_hot_k=10, p3=0.0)
    key = jax.random.key(4)
    want = jsweep.sweep_local_search(
        jpa, key, jst.slots, jst.rooms, n_sweeps=6, swap_block=3,
        converge=True, sideways=0.25, hot_k=10, return_passes=True)
    got = tsweep.sweep_local_search(
        tpa, jax_sweep_draws_fn(key, P, medium_problem.n_events,
                                medium_problem.n_slots, cfg),
        st.slots, st.rooms, n_sweeps=6, swap_block=3, converge=True,
        sideways=0.25, hot_k=10, return_passes=True)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    assert int(want[2]) == got[2]


def test_converge_groups_freeze_independently(small_problem):
    _, tpa = arrays(small_problem)
    slots, rooms = _population(small_problem, 4, 3)
    cfg = tga.GAConfig(ls_swap_block=2, ls_hot_k=0)
    g = [torch.Generator().manual_seed(i) for i in range(2)]
    s, r, passes = tsweep.sweep_local_search(
        tpa, tga.sweep_draws_fn(g, 2, tpa, cfg), t32(slots), t32(rooms),
        n_sweeps=50, swap_block=2, converge=True, groups=2,
        return_passes=True)
    # without sideways a converged group is a fixed point: one more pass
    # leaves both groups unchanged
    st = tdelta.init_state(tpa, s, r)
    again, rows = tsweep.sweep_pass(
        tpa, tga.sweep_draws_fn(g, 2, tpa, cfg)(0), st, 2)
    assert passes < 50 and not bool(rows.any())
    assert torch.equal(again.slots, s)
