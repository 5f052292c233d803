"""The port's GA (timetabling_ga_tpu_torch/ops/ga.py) and single-GPU
island layer against the JAX package: one generation — with the sweep
or the random-candidate local search — reproduces the JAX population bit
for bit under draws mirrored from the JAX key tree, as do the breeding
(K6's plain version), the truncation and the migration (K7's)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moves import (  # noqa: F401  (fixtures)
    _population, arrays, jax_breed_draws, jax_ls_draws, jax_sweep_draws_fn,
    padded_problem, t32)
from timetabling_ga_tpu.ops import fitness as jfit
from timetabling_ga_tpu.ops import ga as jga
from timetabling_ga_tpu.parallel import islands as jisl
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.convert import pop_state_from_numpy
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.parallel import islands as tisl

torch.set_num_threads(1)

POP = 6


def _cfgs(**kw):
    base = dict(pop_size=POP, ls_mode="sweep", ls_sweeps=2,
                ls_converge=True, ls_swap_block=3, ls_hot_k=8,
                ls_sideways=0.25, p3=0.2)
    base.update(kw)
    return jga.GAConfig(**base), tga.GAConfig(**base)


def _anchored(problem, seed):
    rng = np.random.default_rng(seed)
    return dataclasses.replace(
        problem,
        anchor_slots=rng.integers(0, problem.n_slots,
                                  problem.n_events).astype(np.int32),
        anchor_w=rng.integers(0, 4, problem.n_events).astype(np.int32))


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


def check_generation(problem, seed=7, key_seed=21, **kw):
    """One generation of the port (`kw`: GAConfig fields over _cfgs's)
    from a population of `seed` against JAX's under key `key_seed`, bit
    for bit, on mirrored draws."""
    jpa, tpa = arrays(problem)
    jcfg, tcfg = _cfgs(**kw)
    slots, rooms = _population(problem, POP, seed)
    jstate = jga.evaluate(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    key = jax.random.key(key_seed)
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


# the cases past one warp of rooms (WIDE_ROOMS) are in
# test_torch_ga_wide.py, so that under `--dist loadfile` another worker
# takes them
@pytest.mark.parametrize("which", ["small", "padded"])
def test_generation_matches_jax_bit_for_bit(which, small_problem,
                                            padded_problem):
    check_generation(small_problem if which == "small" else padded_problem)


@pytest.mark.parametrize("which", ["small", "padded", "anchored"])
def test_make_children_matches_jax(which, small_problem, padded_problem):
    """K6's plain version against a vmapped `_make_child`: crossover and
    mutation each on some children and off on others, parents with
    random rooms (a child without crossover keeps parent A's, which a
    rematch would not give), and penalties in {0, 1} x scv in {0, 1}, so
    most tournaments end in full ties."""
    problem = {"small": small_problem, "padded": padded_problem,
               "anchored": _anchored(small_problem, 5)}[which]
    jpa, tpa = arrays(problem)
    n = 12
    jcfg = jga.GAConfig(pop_size=n, p_crossover=0.5, p_mutation=0.5,
                        p3=0.4)
    tcfg = tga.GAConfig(pop_size=n, p_crossover=0.5, p_mutation=0.5,
                        p3=0.4)
    slots, _ = _population(problem, n, 3)
    rng = np.random.default_rng(4)
    rooms = rng.integers(0, problem.n_rooms, slots.shape).astype(np.int32)
    tie = rng.integers(0, 2, (2, n)).astype(np.int32)
    jstate = jga.PopState(jnp.asarray(slots), jnp.asarray(rooms),
                          jnp.asarray(tie[0]), jnp.asarray(tie[0]),
                          jnp.asarray(tie[1]))
    key = jax.random.key(31)
    keys = jax.random.split(key, n)
    want = jax.jit(jax.vmap(lambda k: jga._make_child(jpa, k, jstate,
                                                      jcfg)))(keys)
    draws = jax_breed_draws(key, n, problem.n_events, problem.n_slots,
                            jcfg)
    for flag in (draws.do_x, draws.do_m):
        assert 0 < int(flag.sum()) < n
    got = tga.make_children(tpa, draws, pop_state_from_numpy(jstate), tcfg)
    for w, g in zip(want[:2], got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    np.testing.assert_array_equal(np.asarray(want[2]), draws.do_x.numpy())


@pytest.mark.parametrize("delta", [True, False])
def test_generation_random_ls_matches_jax(delta, small_problem):
    jpa, tpa = arrays(small_problem)
    jcfg, tcfg = _cfgs(ls_mode="random", ls_steps=4, ls_candidates=3,
                       ls_delta=delta, p3=0.3)
    slots, rooms = _population(small_problem, POP, 8)
    jstate = jga.evaluate(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    key = jax.random.key(23)
    want = jax.jit(jga.generation, static_argnums=(3,))(jpa, key, jstate,
                                                        jcfg)
    draws = jax_breed_draws(key, POP, small_problem.n_events,
                            small_problem.n_slots, jcfg)
    ls = jax_ls_draws(jax.random.fold_in(key, 0x15), 4, 3, POP,
                      small_problem.n_events, small_problem.n_slots, 1.0,
                      1.0, 0.3)
    got = tga.generation(tpa, draws, lambda _i: ls,
                         pop_state_from_numpy(jstate), tcfg)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _island_state(L, pop, seed, E=7):
    """L islands of `pop` rows: (penalty, scv) in a small range so ties
    are common, each island sorted as truncation leaves it."""
    rng = np.random.default_rng(seed)
    pen = rng.integers(0, 3, (L, pop)).astype(np.int32)
    scv = rng.integers(0, 3, (L, pop)).astype(np.int32)
    order = np.lexsort((scv, pen), axis=-1)
    pen = np.take_along_axis(pen, order, 1).reshape(-1)
    scv = np.take_along_axis(scv, order, 1).reshape(-1)
    rows = np.arange(L * pop, dtype=np.int32)
    slots = (rows[:, None] * 10 + np.arange(E)[None, :]).astype(np.int32)
    return jga.PopState(jnp.asarray(slots), jnp.asarray(slots + 1),
                        jnp.asarray(pen), jnp.asarray(pen * 2 + seed),
                        jnp.asarray(scv))


@pytest.mark.parametrize("L", [1, 2, 4])
@pytest.mark.parametrize("pop", [2, 3, 16])
def test_truncation_and_migration_match_jax(L, pop):
    """K7's plain versions: the (mu+lambda) truncation against the
    generation's lexsort per island, and migration against `_migrate`
    under shard_map with L local islands on one device."""
    par = _island_state(L, pop, 1)
    ch = _island_state(L, pop, 2)

    def trunc(a, b):
        both = [jnp.concatenate([x, y]) for x, y in zip(a, b)]
        order = jfit.lex_order(both[2], both[4])[:pop]
        return [x[order] for x in both]

    blocks = [jax.tree.map(lambda x: x.reshape((L, pop) + x.shape[1:]), s)
              for s in (par, ch)]
    want = jax.vmap(trunc)(*blocks)
    got = tga.survivors(pop_state_from_numpy(par), pop_state_from_numpy(ch),
                        groups=L, keep=pop)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(
            np.asarray(w).reshape((L * pop,) + w.shape[2:]), g.numpy())

    from jax.sharding import PartitionSpec as Pspec
    from timetabling_ga_tpu.compat import shard_map
    spec = jga.PopState(*(Pspec(jisl.AXIS),) * 5)
    mig = jax.jit(functools.partial(
        shard_map, mesh=jisl.make_mesh(1), in_specs=(spec,),
        out_specs=spec)(lambda st: jisl._migrate(st, L, L=L)))
    state = jga.PopState(*(jnp.asarray(np.asarray(w).reshape(
        (L * pop,) + w.shape[2:])) for w in want))
    want_m = mig(state)
    got_m = tisl.migrate(got, L)
    for w, g in zip(want_m, got_m):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_survivors_and_migrate_on_cpu_take_the_plain_versions():
    st = pop_state_from_numpy(_island_state(2, 5, 3))
    kernels.reset_launches()
    a = tga.survivors(st, st, groups=2, keep=4)
    b = tisl.migrate(st, 2)
    assert sum(kernels.LAUNCHES.values()) == 0
    for x, y in zip(a, tga.survivors_plain(st, st, groups=2, keep=4)):
        assert torch.equal(x, y)
    for x, y in zip(b, tisl.migrate_plain(st, 2)):
        assert torch.equal(x, y)


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


def check_generation_mode(mode, problem):
    """One generation under multi_objective ("nsga2") or
    rooms_mode="parallel" against JAX's (check_generation)."""
    check_generation(problem, 9, 25, ls_sweeps=1,
                     multi_objective=mode == "nsga2",
                     rooms_mode="parallel" if mode == "parallel" else "scan")


@pytest.mark.parametrize("mode", ["nsga2", "parallel"])
def test_generation_nsga2_and_parallel_rooms_match_jax(mode, small_problem,
                                                       padded_problem):
    """One generation under multi_objective (crowded tournaments on the
    parents' ranks and crowding, NSGA-II replacement) and under
    rooms_mode="parallel" (the crossover rematch), against JAX's (past
    one warp of rooms: test_torch_ga_wide_parallel.py)."""
    check_generation_mode(mode, padded_problem if mode == "parallel"
                          else small_problem)


@pytest.mark.parametrize("which", ["small", "padded"])
def test_make_children_crowded_and_parallel_match_jax(which, small_problem,
                                                      padded_problem):
    """K6's plain version in both new modes against a vmapped
    `_make_child` with mo_stats, parents with tied (hcv, scv) so ranks
    and crowding tie too."""
    from timetabling_ga_tpu.ops import nsga as jnsga
    problem = small_problem if which == "small" else padded_problem
    jpa, tpa = arrays(problem)
    n = 12
    kw = dict(pop_size=n, p_crossover=0.6, p_mutation=0.5, p3=0.4,
              rooms_mode="parallel", multi_objective=True)
    jcfg, tcfg = jga.GAConfig(**kw), tga.GAConfig(**kw)
    slots, _ = _population(problem, n, 4)
    rng = np.random.default_rng(6)
    rooms = rng.integers(0, problem.n_rooms, slots.shape).astype(np.int32)
    obj = rng.integers(0, 3, (2, n)).astype(np.int32)
    jstate = jga.PopState(jnp.asarray(slots), jnp.asarray(rooms),
                          jnp.asarray(obj[0] * 7), jnp.asarray(obj[0]),
                          jnp.asarray(obj[1]))
    ranks = jnsga.nondominated_ranks(jstate.hcv, jstate.scv)
    crowd = jnsga.crowding_distance(jstate.hcv, jstate.scv, ranks)
    key = jax.random.key(33)
    keys = jax.random.split(key, n)
    want = jax.jit(jax.vmap(lambda k: jga._make_child(
        jpa, k, jstate, jcfg, (ranks, crowd))))(keys)
    draws = jax_breed_draws(key, n, problem.n_events, problem.n_slots, jcfg)
    mo = (torch.tensor(np.asarray(ranks)), torch.tensor(np.asarray(crowd)))
    got = tga.make_children(tpa, draws, pop_state_from_numpy(jstate), tcfg,
                            mo_stats=mo)
    for w, g in zip(want[:2], got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("mode", ["scan", "parallel", "crowded"])
@pytest.mark.parametrize("which", ["small", "padded", "anchored"])
def test_make_children_scores_match_jax_batch_penalty(which, mode,
                                                      small_problem,
                                                      padded_problem):
    """The (penalty, hcv, scv) make_children returns with its children
    (K6's epilogue on the card, its plain version here) equal JAX
    fitness.batch_penalty of the same children, in both matching modes
    and under the crowded tournament."""
    from timetabling_ga_tpu_torch.ops import nsga as tnsga
    problem = {"small": small_problem, "padded": padded_problem,
               "anchored": _anchored(small_problem, 8)}[which]
    jpa, tpa = arrays(problem)
    n = 10
    kw = dict(pop_size=n, p_crossover=0.6, p_mutation=0.6, p3=0.4,
              rooms_mode="parallel" if mode == "parallel" else "scan",
              multi_objective=mode == "crowded")
    tcfg = tga.GAConfig(**kw)
    slots, _ = _population(problem, n, 14)
    rng = np.random.default_rng(15)
    rooms = rng.integers(0, problem.n_rooms, slots.shape).astype(np.int32)
    obj = rng.integers(0, 3, (2, n)).astype(np.int32)
    jstate = jga.PopState(jnp.asarray(slots), jnp.asarray(rooms),
                          jnp.asarray(obj[0] * 3), jnp.asarray(obj[0]),
                          jnp.asarray(obj[1]))
    state = pop_state_from_numpy(jstate)
    mo = tnsga.rank_crowd(state.hcv, state.scv) if mode == "crowded" \
        else None
    draws = jax_breed_draws(jax.random.key(41), n, problem.n_events,
                            problem.n_slots, jga.GAConfig(**kw))
    got = tga.make_children(tpa, draws, state, tcfg, mo_stats=mo)
    want = jfit.batch_penalty(jpa, jnp.asarray(got.slots.numpy()),
                              jnp.asarray(got.rooms.numpy()))
    for w, g in zip(want, got[2:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("which", ["small", "anchored"])
def test_generation_carries_the_children_scores_like_jax(which,
                                                         small_problem):
    """A generation with no local search (random mode, ls_steps 0) keeps
    the children's scores from make_children through to the truncation;
    the survivors equal the JAX generation's, which evaluates them
    anew."""
    problem = small_problem if which == "small" else _anchored(
        small_problem, 9)
    jpa, tpa = arrays(problem)
    jcfg, tcfg = _cfgs(ls_mode="random", ls_steps=0, p3=0.3)
    slots, rooms = _population(problem, POP, 16)
    jstate = jga.evaluate(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    key = jax.random.key(43)
    want = jax.jit(jga.generation, static_argnums=(3,))(jpa, key, jstate,
                                                        jcfg)
    draws = jax_breed_draws(key, POP, problem.n_events, problem.n_slots,
                            jcfg)
    got = tga.generation(tpa, draws, None, pop_state_from_numpy(jstate),
                         tcfg)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
