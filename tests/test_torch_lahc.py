"""The port's LAHC walkers (timetabling_ga_tpu_torch/ops/lahc.py, the plain
version of kernel K10) against the JAX package's ops/lahc.py on the CPU,
exactly: every LahcState field after init and after n steps, with one
and with several candidates a step and a history short enough to wrap,
on plain, anchored and padded instances; and a `--post-lahc` run of the
port's CLI on the CPU.

The draws are mirrored from the JAX key tree: step i splits
fold_in(key, i) into one key per walker, each split into k_cands
candidate keys when k_cands > 1 (one candidate takes the walker key
itself), and each candidate key feeds sample_move's split(3)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moves import (  # noqa: F401  (fixtures)
    _population, arrays, jax_move_draws, padded_problem)
from timetabling_ga_tpu.ops import lahc as jlahc
from timetabling_ga_tpu_torch import cli as tcli
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.convert import ls_state_from_numpy
from timetabling_ga_tpu_torch.ops import lahc as tlahc

torch.set_num_threads(1)


def jax_lahc_draws(key, n_steps, W, K, n_events, n_slots, p1=1.0, p2=1.0,
                   p3=0.0):
    """LahcDraws of lahc_steps (lahc.py:246-277) for n_steps steps."""
    fields = []
    for i in range(n_steps):
        keys = jax.random.split(jax.random.fold_in(key, i), W)
        if K > 1:
            keys = jax.vmap(lambda k: jax.random.split(k, K))(keys)
        d = jax_move_draws(keys.reshape(-1), n_events, n_slots, p1, p2, p3)
        fields.append((d.mtype.reshape(W, K), d.u.reshape(W, K, -1),
                       d.t.reshape(W, K)))
    return tlahc.LahcDraws(*(torch.stack([f[j] for f in fields])
                             for j in range(3)))


def _anchored(problem, seed):
    rng = np.random.default_rng(seed)
    return dataclasses.replace(
        problem,
        anchor_slots=rng.integers(0, problem.n_slots,
                                  problem.n_events).astype(np.int32),
        anchor_w=rng.integers(0, 4, problem.n_events).astype(np.int32))


def _state_from_jax(st):
    return tlahc.LahcState(
        ls_state_from_numpy(st.ls),
        *(torch.tensor(np.asarray(x), dtype=torch.int32) for x in st[1:]))


def _assert_state_equal(want, got):
    for name, w, g in zip(jlahc.LSState._fields, want.ls, got.ls):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)
    for name, w, g in zip(jlahc.LahcState._fields[1:], want[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)


@pytest.mark.parametrize("which", ["small", "anchored", "padded"])
@pytest.mark.parametrize("k_cands", [1, 4])
def test_lahc_steps_match_jax(which, k_cands, small_problem,
                              padded_problem):
    problem = {"small": small_problem, "padded": padded_problem,
               "anchored": _anchored(small_problem, 3)}[which]
    jpa, tpa = arrays(problem)
    W, Lh, n_steps = 4, 3, 8
    p = (1.0, 1.0, 0.5)
    slots, rooms = _population(problem, W, 10 + k_cands)
    jst = jax.jit(jlahc.init_lahc, static_argnums=(3,))(
        jpa, jnp.asarray(slots), jnp.asarray(rooms), Lh)
    tst = tlahc.init_lahc(tpa, torch.tensor(slots), torch.tensor(rooms),
                          Lh)
    _assert_state_equal(jst, tst)
    key = jax.random.key(40 + k_cands)
    want = jax.jit(jlahc.lahc_steps, static_argnums=(4, 5, 6, 7))(
        jpa, key, jst, n_steps, *p, k_cands)
    draws = jax_lahc_draws(key, n_steps, W, k_cands, problem.n_events,
                           problem.n_slots, *p)
    kernels.reset_launches()
    got = tlahc.lahc_steps(tpa, draws, _state_from_jax(jst))
    assert sum(kernels.LAUNCHES.values()) == 0
    _assert_state_equal(want, got)
    # the walkers moved, and the ring wrapped: every entry was rewritten
    assert not torch.equal(got.ls.slots, tst.ls.slots)
    assert int(got.step[0]) == n_steps > Lh


def test_draw_budget_and_shapes():
    g = torch.Generator().manual_seed(0)
    d = tlahc.make_lahc_draws([g, g], 3, 5, 4, 30, 45, 1.0, 1.0, 0.0,
                              "cpu")
    assert d.mtype.shape == (5, 6, 4) and d.u.shape == (5, 6, 4, 30)
    assert d.mtype.dtype == torch.int32 and int(d.mtype.max()) <= 1
    # comp01s, 4 walkers of 16 candidates: 102,912 bytes a step
    assert tlahc.draw_bytes_per_step(4, 16, 400) == 102_912


@pytest.mark.parametrize("tied", [False, True])
def test_lahc_events_are_the_pre_pass_on_one_individual(tied):
    """K10's events come from K8's pre-pass run on the LAHC uniforms as
    one individual's n rounds of W x K candidates: that view of the
    pre-pass's plain form is sample_move's top 3 of every candidate's
    uniforms, in (n, W, K) order, ties included."""
    from timetabling_ga_tpu_torch.ops import delta, moves
    g = torch.Generator().manual_seed(5)
    n, W, K, E = 3, 2, 5, 37
    d = tlahc.make_lahc_draws([g], W, n, K, E, 45, 1.0, 1.0, 0.5, "cpu")
    u = d.u
    if tied:
        u = (u * 4).floor() / 4
        u[..., [E - 1, 9, 2]] = 2.0
    ev = delta.random_ls_events_plain(
        delta.LSDraws(None, u.view(n, W * K, 1, E), None))
    assert ev.shape == (1, n, W * K, 3) and ev.dtype == torch.int16
    want = moves.top3(u.reshape(-1, E)).view(n, W, K, 3)
    assert torch.equal(ev.view(n, W, K, 3).to(torch.int32), want)


def test_post_lahc_cli_on_cpu(small_problem, tmp_path, capsys):
    """`--post-lahc` on the CPU: after the phase switch the LAHC loop
    takes the rest of the budget in chunks (a `lahc` phase record each,
    with its steps), the per-island bests never rise, and the final
    records come from the walkers' best snapshots (JAX
    tests/test_lahc.py:151)."""
    from timetabling_ga_tpu.problem import dump_tim
    tim = tmp_path / "small.tim"
    tim.write_text(dump_tim(small_problem))
    assert tcli.main([
        "-i", str(tim), "-s", "1", "--backend", "cpu", "-t", "6",
        "--no-auto-tune", "--ls-mode", "sweep", "--ls-sweeps", "1",
        "--ls-converge", "--init-sweeps", "2", "--pop-size", "4",
        "--islands", "2", "--generations", "50", "--migration-period", "2",
        "--post-lahc", "64", "--post-lahc-k", "4", "--post-pop-size", "2",
        "--trace"]) == 0
    records = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    phases = [r["phase"] for r in records if "phase" in r]
    names = [p["name"] for p in phases]
    assert "phase-switch" in names and "lahc" in names, names
    assert all(p["steps"] >= 1 for p in phases if p["name"] == "lahc")
    assert names.index("lahc") > names.index("phase-switch")
    per_island = {}
    for r in records:
        if "logEntry" in r:
            per_island.setdefault(r["logEntry"]["procID"], []).append(
                r["logEntry"]["best"])
    for bests in per_island.values():
        assert bests == sorted(bests, reverse=True)
    sols = [r["solution"] for r in records if "solution" in r]
    runs = [r["runEntry"] for r in records if "runEntry" in r]
    assert len(sols) == 2 and runs[0]["totalBest"] == min(
        s["totalBest"] for s in sols)
    assert runs[0]["feasible"] and runs[0]["totalBest"] == min(
        min(b) for b in per_island.values())


@pytest.mark.parametrize("which", ["small", "padded"])
def test_bitsets_kept_through_jax_lahc_steps(which, small_problem,
                                             padded_problem):
    """K10's bookkeeping, in plain form: the bitsets kept by
    delta.apply_bitsets through each step of a JAX LAHC walk (the moved
    events read off the step's slots) equal, after every step, the bits
    packed from JAX's att and slots; and slot_bitsets of the port's init
    state equals them at the start."""
    from tests.test_torch_delta import np_bitsets
    from timetabling_ga_tpu_torch.ops import delta as tdelta
    problem = small_problem if which == "small" else padded_problem
    jpa, tpa = arrays(problem)
    W, Lh = 4, 3
    slots, rooms = _population(problem, W, 31)
    jst = jax.jit(jlahc.init_lahc, static_argnums=(3,))(
        jpa, jnp.asarray(slots), jnp.asarray(rooms), Lh)
    n_words = tpa.conflict_bits.shape[1]
    tst = tlahc.init_lahc(tpa, torch.tensor(slots), torch.tensor(rooms), Lh)
    bits = tdelta.slot_bitsets(tpa, tst.ls.slots, tst.ls.att)
    for w, g in zip(np_bitsets(jst.ls.slots, jst.ls.att, n_words), bits):
        np.testing.assert_array_equal(w, g.numpy())
    step = jax.jit(jlahc.lahc_steps, static_argnums=(3, 4, 5, 6, 7))
    moved_rows = 0
    for i in range(6):
        nxt = step(jpa, jax.random.key(50 + i), jst, 1, 1.0, 1.0, 0.5, 4)
        old = np.asarray(jst.ls.slots)
        new = np.asarray(nxt.ls.slots)
        evs = np.zeros((W, 3), np.int32)
        ns = np.zeros((W, 3), np.int32)
        for w in range(W):
            ch = np.nonzero(old[w] != new[w])[0]
            assert len(ch) <= 3
            # pad with unmoved events (new slot = old slot)
            pad = [e for e in range(problem.n_events) if e not in ch]
            evs[w] = np.concatenate([ch, pad[:3 - len(ch)]])
            ns[w] = new[w][evs[w]]
            moved_rows += len(ch) > 0
        bits = tdelta.apply_bitsets(
            tpa, *bits, torch.tensor(np.asarray(nxt.ls.att)),
            torch.tensor(old), torch.tensor(evs), torch.tensor(ns),
            torch.tensor((old != new).any(1)))
        for w, g in zip(np_bitsets(new, nxt.ls.att, n_words), bits):
            np.testing.assert_array_equal(w, g.numpy())
        jst = nxt
    assert moved_rows > 0
