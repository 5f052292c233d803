"""The port's delta evaluation (timetabling_ga_tpu_torch/ops/delta.py,
kernel K4 and its plain version): every delta equals a full
re-evaluation, and equals the JAX `_delta_one`, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moves import (  # noqa: F401  (fixtures)
    _population, arrays, jax_move_draws, padded_problem, t32)
from timetabling_ga_tpu.ops import delta as jdelta
from timetabling_ga_tpu.ops import moves as jmoves
from timetabling_ga_tpu.ops.rooms import capacity_rank
from timetabling_ga_tpu_torch.convert import ls_state_from_numpy
from timetabling_ga_tpu_torch.ops import delta as tdelta
from timetabling_ga_tpu_torch.ops import fitness as tfit
from timetabling_ga_tpu_torch.ops import moves as tmoves

torch.set_num_threads(1)

P, C = 4, 6


def _candidates(problem, slots, seed, p3=1.0):
    """C sampled padded 3-relocations per individual, (P, C, 3)."""
    keys = jax.random.split(jax.random.key(seed), P * C)
    d = jax_move_draws(keys, problem.n_events, problem.n_slots, 1.0, 1.0,
                       p3)
    rep = t32(np.repeat(slots, C, axis=0))
    _, tpa = arrays(problem)
    evs, ns, act = tmoves.sample_move(tpa, d, rep)
    return (evs.reshape(P, C, 3), ns.reshape(P, C, 3),
            act.reshape(P, C, 3))


@pytest.mark.parametrize("which", ["medium", "padded"])
def test_delta_one_matches_jax_and_full_reevaluation(which, medium_problem,
                                                     padded_problem):
    problem = medium_problem if which == "medium" else padded_problem
    jpa, tpa = arrays(problem)
    slots, rooms = _population(problem, P, 4)
    jst = jdelta.init_state(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    st = ls_state_from_numpy(jst)
    tst = tdelta.init_state(tpa, t32(slots), t32(rooms))
    for a, b in zip(st, tst):
        assert torch.equal(a, b)
    evs, ns, act = _candidates(problem, slots, 9)
    dh, ds, nr = tdelta.delta_one(tpa, st.slots, st.rooms, st.att, st.occ,
                                  evs, ns, act)
    cap = capacity_rank(jpa)
    want = jax.jit(jax.vmap(lambda s, r, a, o, e3, n3, a3: jax.vmap(
        lambda e, n, ac: jdelta._delta_one(jpa, s, r, a, o, e, n, ac,
                                           cap))(e3, n3, a3)))(
        jst.slots, jst.rooms, jst.att, jst.occ, jnp.asarray(evs.numpy()),
        jnp.asarray(ns.numpy()), jnp.asarray(act.numpy()))
    for w, g in zip(want, (dh, ds, nr)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    # every delta is exact against a full re-evaluation of the move
    flat = lambda x: x.reshape((P * C,) + tuple(x.shape[2:]))  # noqa: E731
    s_rep, r_rep = (torch.repeat_interleave(x, C, 0)
                    for x in (st.slots, st.rooms))
    ms, mr = tmoves.apply_relocation(tpa, s_rep, r_rep, flat(evs),
                                     flat(ns), flat(act))
    np.testing.assert_array_equal(
        mr.numpy(), np.asarray(jax.jit(jax.vmap(
            lambda s, r, e, n, a: jmoves.apply_relocation(jpa, s, r, e, n,
                                                          a)))(
            jnp.asarray(s_rep.numpy()), jnp.asarray(r_rep.numpy()),
            jnp.asarray(flat(evs).numpy()), jnp.asarray(flat(ns).numpy()),
            jnp.asarray(flat(act).numpy()))[1]))
    _, h1, s1 = tfit.batch_penalty(tpa, ms, mr)
    h0 = torch.repeat_interleave(st.hcv, C)
    s0 = torch.repeat_interleave(st.scv, C)
    assert torch.equal(h1 - h0, flat(dh))
    assert torch.equal(s1 - s0, flat(ds))
    assert torch.equal(mr.gather(1, flat(evs).long()), flat(nr))


def test_apply_moves_matches_jax(medium_problem):
    jpa, tpa = arrays(medium_problem)
    slots, rooms = _population(medium_problem, P, 6)
    jst = jdelta.init_state(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    st = ls_state_from_numpy(jst)
    evs, ns, act = _candidates(medium_problem, slots, 2)
    _, _, nr = tdelta.delta_one(tpa, st.slots, st.rooms, st.att, st.occ,
                                evs, ns, act)
    accept = torch.tensor([True, False, True, True])
    got = tdelta.apply_moves(tpa, st.slots, st.rooms, st.att, st.occ,
                             evs[:, 0], ns[:, 0], nr[:, 0], accept)
    for i in range(P):
        base = (jst.slots[i], jst.rooms[i], jst.att[i], jst.occ[i])
        want = (jdelta._apply_move(
            jpa, base, jnp.asarray(evs[i, 0].numpy()),
            jnp.asarray(ns[i, 0].numpy()), jnp.asarray(nr[i, 0].numpy()))
            if bool(accept[i]) else base)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g[i].numpy())
