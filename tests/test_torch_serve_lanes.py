"""The serve path's lane generation (timetabling_ga_tpu_torch/ops/ga.py
with a problem.LaneProblems) against the JAX package, and the port's
lane runner (parallel/islands.py lane_run) on its own.

Three lanes, each a different instance of one (32, 4, 4, 32) bucket (a
full-size lane, a lane padded in events and rooms, an ITC-like lane
padded in events), each with draws mirrored from JAX's lane keys
fold_in(fold_in(key(seed), chunk), i) (JAX islands.py:1162-1176): the
port's generation over the three lanes equals `jga.generation` run on
each lane's padded problem, bit for bit — slots, rooms and all three
scores. K6 and K8's chain read those lanes through the lane table on
the card; here their lane-looped plain versions run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moves import jax_breed_draws, jax_ls_draws
from timetabling_ga_tpu.ops import ga as jga
from timetabling_ga_tpu.ops.rooms import batch_assign_rooms
from timetabling_ga_tpu.problem import itc_like_instance, random_instance
from timetabling_ga_tpu.serve.bucket import pad_problem
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.convert import (
    pop_state_from_numpy, problem_arrays_from_numpy)
from timetabling_ga_tpu_torch.ops import delta
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.ops.moves import MoveDraws
from timetabling_ga_tpu_torch.parallel import islands as tisl
from timetabling_ga_tpu_torch.problem import LaneProblems

torch.set_num_threads(1)

POP = 5
MAX_STEPS, K = 12, 4          # the serve config's -m and candidates
ROUNDS = max(1, MAX_STEPS // K)
CHUNK = 3


def _bucket_lanes():
    """The three lanes' padded JAX problems (one bucket)."""
    full = random_instance(21, n_events=32, n_rooms=4, n_features=4,
                           n_students=32, attend_prob=0.25)
    small = random_instance(22, n_events=18, n_rooms=3, n_features=2,
                            n_students=14, attend_prob=0.12)
    itc = itc_like_instance(23, n_events=26, n_rooms=4, n_features=4,
                            n_students=28)
    lanes = [pad_problem(p) for p in (full, small, itc)]
    assert len({(p.n_events, p.n_rooms, p.n_features, p.n_students)
                for p in lanes}) == 1
    return lanes


@pytest.fixture(scope="module")
def lanes():
    padded = _bucket_lanes()
    jpas = [p.device_arrays() for p in padded]
    return padded, jpas, LaneProblems(
        [problem_arrays_from_numpy(j) for j in jpas])


def _jax_state(problem, jpa, seed):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, problem.n_slots,
                         (POP, problem.n_events)).astype(np.int32)
    rooms = np.asarray(batch_assign_rooms(jpa, jnp.asarray(slots)))
    return jga.evaluate(jpa, jnp.asarray(slots), jnp.asarray(rooms))


def _cat_breed(parts):
    return tga.BreedDraws(
        *(torch.cat([p[i] for p in parts]) for i in range(5)),
        move=MoveDraws(*(torch.cat([p.move[i] for p in parts])
                         for i in range(3))))


def test_lane_generation_matches_jax_bit_for_bit(lanes):
    padded, jpas, lp = lanes
    jcfg = jga.GAConfig(pop_size=POP, ls_steps=ROUNDS, ls_candidates=K)
    tcfg = tga.GAConfig(pop_size=POP, ls_steps=ROUNDS, ls_candidates=K)
    E, T = padded[0].n_events, padded[0].n_slots
    gen = jax.jit(jga.generation, static_argnums=(3,))
    want, states, breed, ls = [], [], [], []
    for lane, (p, jpa) in enumerate(zip(padded, jpas)):
        st = _jax_state(p, jpa, 40 + lane)
        states.append(st)
        k = jax.random.fold_in(jax.random.fold_in(
            jax.random.key(7 + lane), CHUNK), 2)
        want.append(gen(jpa, k, st, jcfg))
        breed.append(jax_breed_draws(k, POP, E, T, jcfg))
        ls.append(jax_ls_draws(jax.random.fold_in(k, 0x15), ROUNDS, K, POP,
                               E, T))
    # every lane's own draws, in lane order: rows, and the search's P axis
    draws = _cat_breed(breed)
    ls_draws = delta.LSDraws(*(torch.cat([d[i] for d in ls], 2)
                               for i in range(3)))
    state = tga.PopState(*(torch.cat(x) for x in zip(
        *(pop_state_from_numpy(st) for st in states))))
    kernels.reset_launches()
    got = tga.generation(lp, draws, lambda _i: ls_draws, state, tcfg,
                         groups=len(lp))
    assert sum(kernels.LAUNCHES.values()) == 0
    for f, name in enumerate(tga.PopState._fields):
        w = np.concatenate([np.asarray(x[f]) for x in want])
        np.testing.assert_array_equal(w, got[f].numpy(), err_msg=name)
    # one lane is padded in events and rooms, one in events only
    assert padded[1].n_live_events < E and padded[1].n_live_rooms < 4
    assert padded[2].n_live_events < E


def _lane_state(lp, seed):
    return tga.PopState(*(torch.cat(x) for x in zip(*(
        tisl.lane_init(pa, seed + i, POP) for i, pa in enumerate(lp.pas)))))


@pytest.mark.parametrize("counts", [[3, 1, 0], [1, 3, 2]])
def test_lane_run_lanes_are_independent(lanes, counts):
    """Each lane of lane_run equals that lane run alone, and its trace is
    its own best after each of its generations, sentinels past its
    count: a lane that drops out after one generation, an idle lane
    whose rows stay bit for bit ([3, 1, 0]), and running lanes that are
    not the first ones after a drop ([1, 3, 2])."""
    _, _, lp = lanes
    cfg = tga.GAConfig(pop_size=POP, ls_steps=ROUNDS, ls_candidates=K)
    state = _lane_state(lp, 60)
    seeds = [5, 6, 7]

    def rngs(which):
        return [tisl.lane_generator("cpu", seeds[i], CHUNK)
                if counts[i] else None for i in which]

    out, trace = tisl.lane_run(lp, rngs(range(3)), state, counts, cfg, 4)
    trace = trace.numpy()
    assert trace.shape == (3, 4, 2)
    for lane in range(3):
        rows = slice(lane * POP, (lane + 1) * POP)
        one = lp.select([lane])
        alone, tr = tisl.lane_run(
            one, rngs([lane]), tga.PopState(*(x[rows] for x in state)),
            [counts[lane]], cfg, 4)
        for x, y in zip(out, alone):
            assert torch.equal(x[rows], y)
        np.testing.assert_array_equal(trace[lane], tr.numpy()[0])
        assert (trace[lane, counts[lane]:] == tisl.SENTINEL).all()
        assert (trace[lane, :counts[lane]] != tisl.SENTINEL).all()
    for lane in range(3):
        rows = slice(lane * POP, (lane + 1) * POP)
        if counts[lane] == 0:
            for x, y in zip(out, state):
                assert torch.equal(x[rows], y[rows])
        else:
            # the lane's last trace row is its best row after the run
            np.testing.assert_array_equal(
                trace[lane, counts[lane] - 1],
                [int(out.hcv[rows][0]), int(out.scv[rows][0])])


def test_lane_generators_are_pure_in_seed_and_chunk():
    a = tisl.lane_generator("cpu", 9, 2)
    b = tisl.lane_generator("cpu", 9, 2)
    assert torch.equal(torch.rand(5, generator=a),
                       torch.rand(5, generator=b))
    draws = {tuple(torch.rand(4, generator=g).tolist()) for g in (
        tisl.lane_generator("cpu", 9, 0), tisl.lane_generator("cpu", 9, 1),
        tisl.lane_generator("cpu", 10, 0), tisl.lane_generator("cpu", 9))}
    assert len(draws) == 4
