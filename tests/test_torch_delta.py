"""The port's delta evaluation (timetabling_ga_tpu_torch/ops/delta.py,
kernel K4 and its plain version): every delta equals a full
re-evaluation, and equals the JAX `_delta_one`, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moves import (  # noqa: F401  (fixtures)
    _population, arrays, jax_move_draws, padded_problem, t32, wide_problem)
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


# past one warp: 33 and 80 rooms (the padded 64-room bucket and 64 rooms
# are held by the room-matching and generation tests)
@pytest.mark.parametrize("which", ["medium", "padded", "r33", "r80"])
def test_delta_one_matches_jax_and_full_reevaluation(which, medium_problem,
                                                     padded_problem):
    problem = {"medium": medium_problem,
               "padded": padded_problem}.get(which) or wide_problem(which)
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


def np_bitsets(slots, att, n_words):
    """amask (P, S) int64 and slot_ev (P, T, W) int32 packed with numpy
    from a state's slots (P, E) and attendance (P, S, T)."""
    att = np.asarray(att)
    slots = np.asarray(slots)
    P, S, T = att.shape
    amask = ((att > 0).astype(np.uint64)
             << np.arange(T, dtype=np.uint64)).sum(-1, dtype=np.uint64)
    slot_ev = np.zeros((P, T, n_words), np.uint32)
    for p in range(P):
        for f, t in enumerate(slots[p]):
            slot_ev[p, t, f // 32] |= np.uint32(1 << (f % 32))
    return amask.view(np.int64), slot_ev.view(np.int32)


@pytest.mark.parametrize("which", ["medium", "padded"])
def test_slot_bitsets_match_jax_state(which, medium_problem,
                                      padded_problem):
    """slot_bitsets of the port's state equals the bits packed from JAX
    init_state's att > 0 and slots."""
    problem = medium_problem if which == "medium" else padded_problem
    jpa, tpa = arrays(problem)
    slots, rooms = _population(problem, P, 12)
    jst = jdelta.init_state(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    st = tdelta.init_state(tpa, t32(slots), t32(rooms))
    W = tpa.conflict_bits.shape[1]
    want = np_bitsets(jst.slots, jst.att, W)
    got = tdelta.slot_bitsets(tpa, st.slots, st.att)
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.int32
    assert tuple(got[1].shape) == (P, problem.n_slots, W)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy())


@pytest.mark.parametrize("which", ["medium", "padded"])
def test_apply_bitsets_equal_a_rebuild(which, medium_problem,
                                       padded_problem):
    """After the port's plain apply of each sampled move (Move1, Move2
    and 3-cycles, some rows refused), the bitsets kept by apply_bitsets
    equal a rebuild from the new state, and that state equals JAX's
    _apply_move."""
    problem = medium_problem if which == "medium" else padded_problem
    jpa, tpa = arrays(problem)
    slots, rooms = _population(problem, P, 13)
    jst = jdelta.init_state(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    st = ls_state_from_numpy(jst)
    evs, ns, act = _candidates(problem, slots, 14)
    _, _, nr = tdelta.delta_one(tpa, st.slots, st.rooms, st.att, st.occ,
                                evs, ns, act)
    bits = tdelta.slot_bitsets(tpa, st.slots, st.att)
    W = tpa.conflict_bits.shape[1]
    for c in range(C):
        accept = torch.tensor([True, c % 2 == 0, True, c % 3 != 0])
        new = tdelta.apply_moves(tpa, st.slots, st.rooms, st.att, st.occ,
                                 evs[:, c], ns[:, c], nr[:, c], accept)
        kept = tdelta.apply_bitsets(tpa, *bits, new[2], st.slots,
                                    evs[:, c], ns[:, c], accept)
        for i in range(P):
            base = (jst.slots[i], jst.rooms[i], jst.att[i], jst.occ[i])
            want = (jdelta._apply_move(
                jpa, base, jnp.asarray(evs[i, c].numpy()),
                jnp.asarray(ns[i, c].numpy()),
                jnp.asarray(nr[i, c].numpy()))
                if bool(accept[i]) else base)
            np.testing.assert_array_equal(np.asarray(want[0]),
                                          new[0][i].numpy())
            np.testing.assert_array_equal(np.asarray(want[2]),
                                          new[2][i].numpy())
        for w, g in zip(np_bitsets(new[0].numpy(), new[2].numpy(), W),
                        kept):
            np.testing.assert_array_equal(w, g.numpy())
        # chain the next move from this state
        st = tdelta.LSState(*new, st.pen, st.hcv, st.scv)
        jst = jst._replace(slots=jnp.asarray(new[0].numpy()),
                           rooms=jnp.asarray(new[1].numpy()),
                           att=jnp.asarray(new[2].numpy()),
                           occ=jnp.asarray(new[3].numpy()))
        bits = kept
        evs, ns, act = _candidates(problem, new[0].numpy(), 20 + c)
        _, _, nr = tdelta.delta_one(tpa, st.slots, st.rooms, st.att,
                                    st.occ, evs, ns, act)
