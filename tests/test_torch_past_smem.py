"""The port's plain versions on an instance past both shared-memory
thresholds (24 events, 400 rooms, 2,500 students: an individual's
attendance is 225,000 bytes, its int32 occupancy 72,000), where the
kernels take their global-memory branches, against the JAX package's
functions under injected draws, exactly: the fitness, a sweep pass and
a relocation chain (the kernels' plain versions the emulated and card
tests hold the global branches against)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import lax

from tests.test_torch_moves import (
    _population, arrays, jax_move_draws, jax_sweep_draws, t32)
from timetabling_ga_tpu.ops import delta as jdelta
from timetabling_ga_tpu.ops import fitness as jfit
from timetabling_ga_tpu.ops import moves as jmoves
from timetabling_ga_tpu.ops import sweep as jsweep
from timetabling_ga_tpu.problem import random_instance
from timetabling_ga_tpu_torch.convert import ls_state_from_numpy
from timetabling_ga_tpu_torch.ops import fitness as tfit
from timetabling_ga_tpu_torch.ops import moves as tmoves
from timetabling_ga_tpu_torch.ops import sweep as tsweep

torch.set_num_threads(1)


def test_plain_versions_past_shared_memory_match_jax():
    problem = random_instance(23, n_events=24, n_rooms=400, n_features=3,
                              n_students=2500, attend_prob=0.03)
    jpa, tpa = arrays(problem)
    # the sizes take the global branches: K5's attendance, K6's
    # relocation rows (two a block, not four)
    sb, be, side, hot, p3 = 3, 1, 0.25, 8, 0.3
    sh = tsweep.sweep_shape(24, tpa.n_slots, sb, be, hot, p3)
    assert not tsweep.sweep_pass_layout(tpa, sh)[2] & 4
    assert tmoves.relocate_stage(tpa)[1] == 2
    P = 3
    slots, rooms = _population(problem, P, 3)
    # the fitness
    want = jfit.batch_penalty(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    got = tfit.batch_penalty(tpa, t32(slots), t32(rooms))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    # a sweep pass (hot pivots, sideways, 3-cycles)
    jst = jdelta.init_state(jpa, jnp.asarray(slots), jnp.asarray(rooms))
    key = jax.random.key(5)
    want, improved = jax.jit(jsweep.sweep_pass, static_argnums=range(3, 8))(
        jpa, key, jst, sb, be, side, hot, p3)
    draws = jax_sweep_draws(key, P, 24, tpa.n_slots, sb, be, side, hot, p3)
    got, rows = tsweep.sweep_pass(tpa, draws, ls_state_from_numpy(jst), sb,
                                  be, side, hot, p3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert bool(improved) == bool(rows.any())
    # a relocation chain of three moves (the kick's scan)
    keys = jax.random.split(jax.random.key(8), P * 3).reshape(P, 3)

    def clone(ks, s, r):
        def body(carry, k):
            return jmoves.random_move(jpa, k, carry[0], carry[1], 1.0, 1.0,
                                      0.5), None
        return lax.scan(body, (s, r), ks)[0]

    ws, wr = jax.jit(jax.vmap(clone))(keys, jnp.asarray(slots),
                                      jnp.asarray(rooms))
    d = jax_move_draws(keys.T.reshape(-1), 24, tpa.n_slots, 1.0, 1.0, 0.5)
    md = tmoves.MoveDraws(d.mtype.reshape(3, P), d.u.reshape(3, P, -1),
                          d.t.reshape(3, P))
    gs, gr = tmoves.relocation_chain(tpa, md, t32(slots), t32(rooms), 3)
    np.testing.assert_array_equal(np.asarray(ws), gs.numpy())
    np.testing.assert_array_equal(np.asarray(wr), gr.numpy())
