"""The port's moves (timetabling_ga_tpu_torch/ops/moves.py) against the
JAX package's, on the CPU, exactly.

This module also holds the shared JAX-draw mirroring: functions that
walk the JAX package's key tree with live `jax.random` calls and return
the draws the port takes as tensors (sample_move, the sweep pass, the
random-candidate local search and the generation). The other tests/test_torch_*.py files import them, and
`test_mirrored_draws_reproduce_sample_move` below checks the mirror
against the JAX op it mirrors.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from timetabling_ga_tpu.ops import moves as jmoves
from timetabling_ga_tpu_torch.convert import problem_arrays_from_numpy
from timetabling_ga_tpu_torch.ops import delta as tdelta
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.ops import moves as tmoves
from timetabling_ga_tpu_torch.ops.sweep import SweepDraws, sweep_shape

torch.set_num_threads(1)


# ---------------------------------------------------------------- mirrors

def _t(x):
    """A JAX array as a (writable) torch tensor."""
    return torch.tensor(np.asarray(x))


def jax_move_draws(keys, n_events, n_slots, p1=1.0, p2=1.0, p3=0.0):
    """MoveDraws of moves.sample_move (moves.py:118-130) for a batch of
    keys: split(key, 3) -> categorical type, (E,) uniforms, target."""
    def one(key):
        k_type, k_ev, k_slot = jax.random.split(key, 3)
        probs = jnp.array([p1, p2, p3], dtype=jnp.float32)
        mtype = jax.random.categorical(k_type, jnp.log(probs))
        u = jax.random.uniform(k_ev, (n_events,))
        t = jax.random.randint(k_slot, (), 0, n_slots, dtype=jnp.int32)
        return mtype, u, t
    mtype, u, t = jax.vmap(one)(keys)
    return tmoves.MoveDraws(_t((mtype)),
                            _t((u)),
                            _t((t)))


def jax_ls_draws(key, n_rounds, K, P, n_events, n_slots, p1=1.0, p2=1.0,
                 p3=0.0):
    """LSDraws of the random-candidate local search (delta.py:240-280,
    local_search.py:59-80): split(key, n_rounds) -> split(K) -> split(P)
    -> sample_move's split(3)."""
    keys = jax.vmap(lambda k: jax.vmap(lambda kk: jax.random.split(kk, P))(
        jax.random.split(k, K)))(jax.random.split(key, n_rounds))
    d = jax_move_draws(keys.reshape(-1), n_events, n_slots, p1, p2, p3)
    shape = (n_rounds, K, P)
    return tdelta.LSDraws(d.mtype.reshape(shape),
                          d.u.reshape(shape + (n_events,)),
                          d.t.reshape(shape))


def jax_sweep_draws(key, P, n_events, n_slots, swap_block, block_events,
                    sideways, hot_k, p3):
    """SweepDraws of one sweep_pass (sweep.py:289-322, 530-537)."""
    sh = sweep_shape(n_events, n_slots, swap_block, block_events, hot_k, p3)
    k_perm, k_tie, k_side, k_hot = jax.random.split(key, 4)
    cop = jnp.asarray([a for a in range(1, max(n_events, 2))
                       if math.gcd(a, n_events) == 1], dtype=jnp.int32)
    k_pa, k_pb = jax.random.split(k_perm)
    a = cop[jax.random.randint(k_pa, (P, 1), 0, cop.shape[0])][:, 0]
    b = jax.random.randint(k_pb, (P, 1), 0, n_events)[:, 0]
    hot = tie = allow = None
    if sh.use_hot:
        hot = _t((jax.random.uniform(
            k_hot, (P, n_events), maxval=0.9)))
    if sideways > 0.0:
        tie = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(k_tie, pos), (P, sh.n_cand)))
            for pos in range(sh.n_steps)]))
        allow = torch.from_numpy(np.stack([np.asarray(jax.random.bernoulli(
            jax.random.fold_in(k_side, pos), sideways, (P,)))
            for pos in range(sh.n_steps)]))
    return SweepDraws(_t((a)),
                      _t((b)), hot, tie, allow)


def jax_sweep_draws_fn(key, P, n_events, n_slots, cfg):
    """Pass i of sweep_local_search draws from fold_in(key, i)."""
    def draws(i):
        return jax_sweep_draws(
            jax.random.fold_in(key, i), P, n_events, n_slots,
            cfg.ls_swap_block, cfg.ls_block_events, cfg.ls_sideways,
            cfg.ls_hot_k, cfg.p3)
    return draws


def jax_breed_draws(key, P, n_events, n_slots, cfg):
    """BreedDraws of ga.generation's children (ga.py:183, 237)."""
    keys = jax.random.split(key, P)

    def one(k):
        k_a, k_b, k_x, k_mask, k_m, k_mv = jax.random.split(k, 6)
        return (jax.random.randint(k_a, (cfg.tournament_k,), 0, P),
                jax.random.randint(k_b, (cfg.tournament_k,), 0, P),
                jax.random.bernoulli(k_mask, 0.5, (n_events,)),
                jax.random.bernoulli(k_x, cfg.p_crossover),
                jax.random.bernoulli(k_m, cfg.p_mutation), k_mv)
    ta, tb, mask, do_x, do_m, k_mv = jax.vmap(one)(keys)
    move = jax_move_draws(k_mv, n_events, n_slots, cfg.p1, cfg.p2, cfg.p3)
    t = [_t(x).to(torch.int64)
         for x in (ta, tb)]
    b = [_t(x) for x in (mask, do_x, do_m)]
    return tga.BreedDraws(*t, *b, move=move)


# ---------------------------------------------------------------- fixtures

@pytest.fixture
def cuda():
    """The CUDA device; skips the test on a machine without one (the
    kernel-vs-plain tests, marked `cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def arrays(problem):
    """(JAX ProblemArrays, the port's ProblemArrays) of one Problem."""
    jpa = problem.device_arrays()
    return jpa, problem_arrays_from_numpy(jpa)


@pytest.fixture(scope="module")
def padded_problem(small_problem):
    from timetabling_ga_tpu.serve.bucket import pad_problem
    return pad_problem(small_problem)


# instances past one warp of rooms (wide_problem): 33, 64 and 80 rooms,
# and 40 rooms padded to serve's 64-room bucket (dead rooms and events)
WIDE_ROOMS = ("r33", "r64", "r80", "r40pad64")


@functools.lru_cache(maxsize=None)
def wide_problem(which):
    """A JAX Problem of WIDE_ROOMS at 48 events (40 padded), with room
    sizes drawn so that events of many students fit only the larger
    rooms: the rooms a matching takes reach ranks 32 and beyond."""
    from timetabling_ga_tpu.problem import random_instance
    from timetabling_ga_tpu.serve.bucket import pad_problem
    if which == "r40pad64":
        return pad_problem(random_instance(13, n_events=40, n_rooms=40,
                                           n_features=3, n_students=30,
                                           attend_prob=0.1))
    R = int(which[1:])
    return random_instance(10 + R, n_events=48, n_rooms=R, n_features=3,
                           n_students=30, attend_prob=0.1)


def _population(problem, n, seed):
    from timetabling_ga_tpu.ops.rooms import batch_assign_rooms
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, problem.n_slots,
                         size=(n, problem.n_events)).astype(np.int32)
    rooms = np.asarray(batch_assign_rooms(problem.device_arrays(),
                                          jnp.asarray(slots)))
    return slots, rooms


def t32(x):
    return torch.tensor(np.asarray(x), dtype=torch.int32)


# ---------------------------------------------------------------- tests

def test_mirrored_draws_reproduce_sample_move(small_problem):
    jpa, tpa = arrays(small_problem)
    slots, _ = _population(small_problem, 6, 0)
    keys = jax.random.split(jax.random.key(7), 6)
    want = jax.vmap(lambda k, s: jmoves.sample_move(jpa, k, s, 1.0, 1.0,
                                                    0.5))(
        keys, jnp.asarray(slots))
    draws = jax_move_draws(keys, small_problem.n_events,
                           small_problem.n_slots, 1.0, 1.0, 0.5)
    got = tmoves.sample_move(tpa, draws, t32(slots))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("which", ["small", "padded"])
def test_random_move_matches_jax(which, small_problem, padded_problem):
    problem = small_problem if which == "small" else padded_problem
    jpa, tpa = arrays(problem)
    slots, rooms = _population(problem, 8, 1)
    keys = jax.random.split(jax.random.key(3), 8)
    ws, wr = jax.vmap(lambda k, s, r: jmoves.random_move(
        jpa, k, s, r, 1.0, 1.0, 1.0))(keys, jnp.asarray(slots),
                                       jnp.asarray(rooms))
    draws = jax_move_draws(keys, problem.n_events, problem.n_slots,
                           1.0, 1.0, 1.0)
    gs, gr = tmoves.random_move_plain(tpa, draws, t32(slots), t32(rooms))
    np.testing.assert_array_equal(np.asarray(ws), gs.numpy())
    np.testing.assert_array_equal(np.asarray(wr), gr.numpy())


def test_move1_move2_move3_match_jax(medium_problem):
    jpa, tpa = arrays(medium_problem)
    slots, rooms = _population(medium_problem, 4, 2)
    rng = np.random.default_rng(5)
    ev = np.stack([rng.choice(medium_problem.n_events, 3, replace=False)
                   for _ in range(4)]).astype(np.int32)
    tt = rng.integers(0, medium_problem.n_slots, 4).astype(np.int32)
    js, jr = jnp.asarray(slots), jnp.asarray(rooms)
    cases = [
        (jax.vmap(lambda s, r, e, t: jmoves.move1(jpa, s, r, e[0], t))(
            js, jr, jnp.asarray(ev), jnp.asarray(tt)),
         tmoves.move1(tpa, t32(slots), t32(rooms), t32(ev[:, 0]),
                      t32(tt))),
        (jax.vmap(lambda s, r, e: jmoves.move2(jpa, s, r, e[0], e[1]))(
            js, jr, jnp.asarray(ev)),
         tmoves.move2(tpa, t32(slots), t32(rooms), t32(ev[:, 0]),
                      t32(ev[:, 1]))),
        (jax.vmap(lambda s, r, e: jmoves.move3(jpa, s, r, e[0], e[1],
                                               e[2]))(
            js, jr, jnp.asarray(ev)),
         tmoves.move3(tpa, t32(slots), t32(rooms), t32(ev[:, 0]),
                      t32(ev[:, 1]), t32(ev[:, 2]))),
    ]
    for (ws, wr), (gs, gr) in cases:
        np.testing.assert_array_equal(np.asarray(ws), gs.numpy())
        np.testing.assert_array_equal(np.asarray(wr), gr.numpy())


@pytest.mark.parametrize("which", ["small", "padded"])
def test_relocation_chain_matches_jax_kick_scan(which, small_problem,
                                                padded_problem):
    """The JAX kick's per-clone scan (islands.py:823-849): max_moves
    random moves, those at i >= n_moves masked off."""
    problem = small_problem if which == "small" else padded_problem
    jpa, tpa = arrays(problem)
    N, max_moves, n_moves = 5, 4, 3
    slots, rooms = _population(problem, N, 6)
    keys = jax.random.split(jax.random.key(8), N * max_moves).reshape(
        N, max_moves)

    def clone(ks, s, r):
        def body(carry, xs):
            i, k = xs
            s2, r2 = jmoves.random_move(jpa, k, carry[0], carry[1], 1.0,
                                        1.0, 0.5)
            keep = i < n_moves
            return (jnp.where(keep, s2, carry[0]),
                    jnp.where(keep, r2, carry[1])), None
        (s, r), _ = lax.scan(body, (s, r), (jnp.arange(max_moves), ks))
        return s, r

    ws, wr = jax.jit(jax.vmap(clone))(keys, jnp.asarray(slots),
                                      jnp.asarray(rooms))
    d = jax_move_draws(keys.T.reshape(-1), problem.n_events,
                       problem.n_slots, 1.0, 1.0, 0.5)
    draws = tmoves.MoveDraws(d.mtype.reshape(max_moves, N),
                             d.u.reshape(max_moves, N, -1),
                             d.t.reshape(max_moves, N))
    gs, gr = tmoves.relocation_chain(tpa, draws, t32(slots), t32(rooms),
                                     n_moves)
    np.testing.assert_array_equal(np.asarray(ws), gs.numpy())
    np.testing.assert_array_equal(np.asarray(wr), gr.numpy())


def test_make_move_draws_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    d = tmoves.make_move_draws([g, g], 5, 30, 45, 1.0, 1.0, 0.0, "cpu")
    assert d.mtype.shape == (10,) and d.u.shape == (10, 30)
    assert int(d.mtype.max()) <= 1          # p3 = 0: no Move3
    assert 0 <= int(d.t.min()) and int(d.t.max()) < 45
