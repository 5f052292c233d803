"""The port's GA (timetabling_ga_tpu_torch/ops/ga.py) and single-GPU
island layer against the JAX package: one generation reproduces the JAX
population bit for bit under draws mirrored from the JAX key tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moves import (  # noqa: F401  (fixtures)
    _population, arrays, jax_breed_draws, jax_sweep_draws_fn,
    padded_problem, t32)
from timetabling_ga_tpu.ops import ga as jga
from timetabling_ga_tpu_torch.convert import pop_state_from_numpy
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.parallel import islands as tisl

torch.set_num_threads(1)

POP = 6


def _cfgs(**kw):
    base = dict(pop_size=POP, ls_sweeps=2, ls_converge=True,
                ls_swap_block=3, ls_hot_k=8, ls_sideways=0.25, p3=0.2)
    base.update(kw)
    return jga.GAConfig(ls_mode="sweep", **base), tga.GAConfig(**base)


def test_init_population_matches_jax(small_problem):
    jpa, tpa = arrays(small_problem)
    jcfg, tcfg = _cfgs()
    key = jax.random.key(5)
    want = jga.init_population(jpa, key, POP, jcfg)   # init_sweeps = 0
    slots0 = jax.random.randint(key, (POP, small_problem.n_events), 0,
                                small_problem.n_slots, dtype=jnp.int32)
    got = tga.init_population(tpa, t32(slots0), tcfg)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("which", ["small", "padded"])
def test_generation_matches_jax_bit_for_bit(which, small_problem,
                                            padded_problem):
    problem = small_problem if which == "small" else padded_problem
    jpa, tpa = arrays(problem)
    jcfg, tcfg = _cfgs()
    slots, rooms = _population(problem, POP, 7)
    jstate = jga.evaluate(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    key = jax.random.key(21)
    want = jax.jit(jga.generation, static_argnums=(3,))(jpa, key, jstate,
                                                        jcfg)
    draws = jax_breed_draws(key, POP, problem.n_events, problem.n_slots,
                            jcfg)
    sweep_fn = jax_sweep_draws_fn(jax.random.fold_in(key, 0x15), POP,
                                  problem.n_events, problem.n_slots, jcfg)
    got = tga.generation(tpa, draws, sweep_fn, pop_state_from_numpy(jstate),
                         tcfg)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_tournament_matches_jax():
    rng = np.random.default_rng(1)
    pen = rng.integers(0, 4, 10).astype(np.int32)
    scv = rng.integers(0, 4, 10).astype(np.int32)
    keys = jax.random.split(jax.random.key(2), 16)
    want = jax.vmap(lambda k: jga.tournament(k, jnp.asarray(pen),
                                             jnp.asarray(scv), 5))(keys)
    draws = jax.vmap(lambda k: jax.random.randint(k, (5,), 0, 10))(keys)
    got = tga.tournament(torch.tensor(np.asarray(draws)).long(),
                         torch.from_numpy(pen), torch.from_numpy(scv))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _ranked_state(L, pop):
    """L islands whose row j has penalty 100 * island + j (sorted)."""
    pen = (100 * np.arange(L)[:, None] + np.arange(pop)[None, :]).reshape(-1)
    slots = np.tile(pen[:, None], (1, 5))
    return tga.PopState(t32(slots), t32(slots), t32(pen), t32(pen),
                        t32(np.zeros_like(pen)))


def test_migrate_ring():
    L, pop = 3, 4
    out = tisl.migrate(_ranked_state(L, pop), L)
    pen = out.penalty.reshape(L, pop).numpy()
    for i in range(L):
        # island i keeps rows 0-1, gains island i-1's best and island
        # i+1's second-best, re-sorted
        want = sorted([100 * i, 100 * i + 1, 100 * ((i - 1) % L),
                       100 * ((i + 1) % L) + 1])
        assert pen[i].tolist() == want
    small = _ranked_state(2, 2)
    assert all(torch.equal(a, b)
               for a, b in zip(tisl.migrate(small, 2), small))


def test_kick_and_shrink_keep_the_elite(small_problem):
    _, tpa = arrays(small_problem)
    _, tcfg = _cfgs()
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    st = tisl.init_island_population(tpa, gens, POP)
    kicked = tisl.kick(tpa, gens, st, tcfg, 3)
    for i in range(2):
        rows = slice(i * POP, (i + 1) * POP)
        assert int(kicked.penalty[rows][0]) <= int(st.penalty[rows][0])
        pen = kicked.penalty[rows].tolist()
        assert pen == sorted(pen)
    sh = tisl.shrink(st, 2, 2)
    assert sh.slots.shape[0] == 4
    assert torch.equal(sh.penalty, st.penalty.reshape(2, POP)[:, :2]
                       .reshape(-1))


def test_run_epochs_traces_each_generation(small_problem):
    _, tpa = arrays(small_problem)
    _, tcfg = _cfgs(ls_sweeps=1)
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    st = tisl.init_island_population(tpa, gens, POP)
    st2, trace = tisl.run_epochs(tpa, gens, st, tcfg, 2, 2)
    assert trace.shape == (2, 4, 2)
    tr = trace.numpy().astype(np.int64)
    np.testing.assert_array_equal(
        tr[:, -1, 0], st2.hcv.reshape(2, POP)[:, 0].numpy())
    # elitist within an epoch: an island's best never gets worse
    # between generations (migration only replaces the worst rows)
    rep = np.where(tr[..., 0] == 0, tr[..., 1],
                   tr[..., 0] * 1_000_000 + tr[..., 1])
    assert (np.diff(rep, axis=1) <= 0).all()
