"""The port's NSGA-II selection (timetabling_ga_tpu_torch/ops/nsga.py, the
plain versions of kernel K11) against the JAX package's ops/nsga.py on
the CPU, exactly: ranks, crowding distances compared bit for bit as
float32, survivor indices, the crowded tournament and the replacement
of a generation, on random (hcv, scv) with duplicates and many fronts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timetabling_ga_tpu.ops import fitness as jfit
from timetabling_ga_tpu.ops import nsga as jnsga
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.ops import nsga as tnsga

torch.set_num_threads(1)


def _objectives(n, seed, spread):
    """(hcv, scv) int32 of n individuals: `spread` small keeps duplicate
    pairs common, a large one makes many fronts; a few feasible rows."""
    rng = np.random.default_rng(seed)
    hcv = rng.integers(0, spread, n).astype(np.int32)
    scv = rng.integers(0, 3 * spread, n).astype(np.int32)
    hcv[rng.random(n) < 0.2] = 0
    return hcv, scv


CASES = [(n, seed, spread) for n, seed, spread in (
    (1, 0, 3), (2, 1, 2), (5, 2, 2), (8, 3, 3), (13, 4, 50), (20, 5, 4),
    (32, 6, 1000), (33, 7, 6), (64, 8, 5), (64, 9, 100000))]


@pytest.mark.parametrize("n,seed,spread", CASES)
def test_ranks_crowding_and_survivors_match_jax(n, seed, spread):
    hcv, scv = _objectives(n, seed, spread)
    jh, js = jnp.asarray(hcv), jnp.asarray(scv)
    th, ts = torch.from_numpy(hcv), torch.from_numpy(scv)
    want_r = np.asarray(jnsga.nondominated_ranks(jh, js))
    got_r = tnsga.nondominated_ranks(th, ts)
    np.testing.assert_array_equal(want_r, got_r.numpy())
    want_c = np.asarray(jnsga.crowding_distance(jh, js, jnp.asarray(want_r)))
    got_c = tnsga.crowding_distance(th, ts, got_r)
    assert got_c.dtype == torch.float32
    np.testing.assert_array_equal(want_c.view(np.int32),
                                  got_c.numpy().view(np.int32))
    np.testing.assert_array_equal(
        np.asarray(jnsga.domination_matrix(jh, js)),
        tnsga.domination_matrix(th, ts).numpy())
    for k in {1, max(1, n // 2), n}:
        np.testing.assert_array_equal(
            np.asarray(jnsga.nsga_survivor_indices(jh, js, k)),
            tnsga.nsga_survivor_indices(th, ts, k).numpy())


def test_many_fronts_are_peeled_completely():
    """A chain of n mutually dominating rows has n fronts."""
    n = 40
    hcv = np.arange(n, dtype=np.int32)[::-1].copy()
    got = tnsga.nondominated_ranks(torch.from_numpy(hcv),
                                   torch.from_numpy(hcv))
    np.testing.assert_array_equal(
        np.asarray(jnsga.nondominated_ranks(jnp.asarray(hcv),
                                            jnp.asarray(hcv))), got.numpy())
    assert int(got.max()) == n - 1


def test_duplicates_share_a_front_and_infinite_crowds_tie():
    hcv = np.array([1, 1, 1, 0, 2, 2], np.int32)
    scv = np.array([3, 3, 3, 9, 0, 0], np.int32)
    th, ts = torch.from_numpy(hcv), torch.from_numpy(scv)
    ranks = tnsga.nondominated_ranks(th, ts)
    assert ranks.tolist() == [0, 0, 0, 0, 0, 0]
    crowd = tnsga.crowding_distance(th, ts, ranks)
    want = jnsga.crowding_distance(jnp.asarray(hcv), jnp.asarray(scv),
                                   jnp.asarray(ranks.numpy()))
    np.testing.assert_array_equal(np.asarray(want), crowd.numpy())
    assert float(crowd.min()) == 0.0 and np.isinf(crowd.numpy()).sum() >= 2
    np.testing.assert_array_equal(
        np.asarray(jnsga.nsga_survivor_indices(jnp.asarray(hcv),
                                               jnp.asarray(scv), 6)),
        tnsga.nsga_survivor_indices(th, ts, 6).numpy())


@pytest.mark.parametrize("n,seed,spread", [(10, 1, 2), (16, 2, 30),
                                           (25, 3, 3)])
def test_crowded_tournament_matches_jax(n, seed, spread):
    hcv, scv = _objectives(n, seed, spread)
    ranks = jnsga.nondominated_ranks(jnp.asarray(hcv), jnp.asarray(scv))
    crowd = jnsga.crowding_distance(jnp.asarray(hcv), jnp.asarray(scv),
                                    ranks)
    keys = jax.random.split(jax.random.key(seed), 24)
    want = jax.vmap(lambda k: jnsga.crowded_tournament(k, ranks, crowd,
                                                       5))(keys)
    draws = jax.vmap(lambda k: jax.random.randint(k, (5,), 0, n))(keys)
    got = tnsga.crowded_tournament(torch.tensor(np.asarray(draws)).long(),
                                   torch.tensor(np.asarray(ranks)),
                                   torch.tensor(np.asarray(crowd)))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _islands(L, pop, seed, spread):
    rng = np.random.default_rng(seed)
    hcv = rng.integers(0, spread, L * pop).astype(np.int32)
    scv = rng.integers(0, 2 * spread, L * pop).astype(np.int32)
    pen = np.where(hcv == 0, scv, 1_000_000 + hcv).astype(np.int32)
    pen += rng.integers(0, 2, L * pop).astype(np.int32)   # anchor terms
    rows = np.arange(L * pop, dtype=np.int32)
    slots = (rows[:, None] * 10 + seed + np.arange(6)).astype(np.int32)
    return tga.PopState(*(torch.from_numpy(x) for x in (
        slots, slots + 1, pen, hcv, scv)))


@pytest.mark.parametrize("L,pop,spread", [(1, 4, 2), (2, 5, 3), (3, 8, 40),
                                          (1, 16, 4)])
def test_replacement_matches_jax_generation(L, pop, spread):
    """The NSGA-II replacement of JAX ga.generation (ga.py:282-293) on
    each island: nsga_survivor_indices of parents + children, re-sorted
    by lex_order of the kept rows, rows gathered."""
    par, ch = _islands(L, pop, 1, spread), _islands(L, pop, 2, spread)
    got = tnsga.survivors(par, ch, groups=L, keep=pop)
    for i in range(L):
        rows = slice(i * pop, (i + 1) * pop)
        both = [np.concatenate([x[rows].numpy(), y[rows].numpy()])
                for x, y in zip(par, ch)]
        keep = jnsga.nsga_survivor_indices(jnp.asarray(both[3]),
                                           jnp.asarray(both[4]), pop)
        order = np.asarray(keep[jfit.lex_order(jnp.asarray(both[2])[keep],
                                               jnp.asarray(both[4])[keep])])
        for w, g in zip(both, got):
            np.testing.assert_array_equal(w[order], g[rows].numpy())


def test_rank_crowd_per_island_and_cpu_takes_the_plain_version():
    st = _islands(3, 7, 4, 5)
    kernels.reset_launches()
    ranks, crowd = tnsga.rank_crowd(st.hcv, st.scv, groups=3)
    assert sum(kernels.LAUNCHES.values()) == 0
    for i in range(3):
        rows = slice(i * 7, (i + 1) * 7)
        jr = jnsga.nondominated_ranks(jnp.asarray(st.hcv[rows].numpy()),
                                      jnp.asarray(st.scv[rows].numpy()))
        jc = jnsga.crowding_distance(jnp.asarray(st.hcv[rows].numpy()),
                                     jnp.asarray(st.scv[rows].numpy()), jr)
        np.testing.assert_array_equal(np.asarray(jr), ranks[rows].numpy())
        np.testing.assert_array_equal(np.asarray(jc), crowd[rows].numpy())
