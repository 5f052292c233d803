"""The port's problem model (timetabling_ga_tpu_torch/problem.py,
convert.py) against the JAX package's: the same loaded and derived
arrays, the same device-array fields and masks, `dump_tim` round trips
and the same seeded instance generators."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_torch_moves import padded_problem  # noqa: F401  (fixture)
from timetabling_ga_tpu import problem as jprob
from timetabling_ga_tpu_torch import problem as tprob
from timetabling_ga_tpu_torch.convert import problem_arrays_from_numpy

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMP01S = os.path.join(_REPO, "fixtures", "comp01s.tim")

_HOST_FIELDS = ("room_size", "attends", "room_features", "event_features",
                "student_count", "conflict", "possible")
_DEVICE_FIELDS = ("attends", "conflict", "possible", "student_count",
                  "room_size", "event_mask", "room_mask", "anchor_slots",
                  "anchor_w")


def _same_host(a, b):
    for f in _HOST_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("n_events", "n_rooms", "n_features", "n_students", "n_days",
              "slots_per_day"):
        assert getattr(a, f) == getattr(b, f), f


def test_comp01s_load_matches_jax():
    j = jprob.load_tim_file(COMP01S)
    t = tprob.load_tim_file(COMP01S)
    _same_host(j, t)
    assert (t.n_events, t.n_rooms, t.n_features, t.n_students,
            t.n_slots) == (400, 10, 10, 200, 45)


@pytest.mark.parametrize("which", ["small", "medium", "padded", "comp01s"])
def test_device_arrays_match_jax(which, small_problem, medium_problem,
                                 padded_problem):
    problem = {"small": small_problem, "medium": medium_problem,
               "padded": padded_problem,
               "comp01s": jprob.load_tim_file(COMP01S)}[which]
    jpa = problem.device_arrays()
    tpa = problem_arrays_from_numpy(jpa)
    for f in _DEVICE_FIELDS:
        j = np.asarray(getattr(jpa, f))
        t = getattr(tpa, f).numpy()
        assert j.dtype == t.dtype and np.array_equal(j, t), f
    assert (tpa.n_days, tpa.slots_per_day) == (jpa.n_days, jpa.slots_per_day)
    # the port's own loader gives the same device arrays for an
    # unpadded instance
    if which != "padded":
        own = tprob.load_tim(jprob.dump_tim(problem)).device_arrays()
        for f in _DEVICE_FIELDS:
            assert np.array_equal(getattr(own, f).numpy(),
                                  getattr(tpa, f).numpy()), f


def test_convert_gives_the_ports_own_arrays_past_one_warp():
    """convert.problem_arrays_from_numpy of a JAX 80-room problem equals
    the port's own ProblemArrays of the same instance in every field, the
    derived ones too: the three suitability words an event, the conflict
    words, the capacity ranks and the CSR."""
    kw = dict(n_events=60, n_rooms=80, n_features=4, n_students=40,
              attend_prob=0.08)
    jpa = jprob.random_instance(5, **kw).device_arrays()
    got = problem_arrays_from_numpy(jpa)
    own = tprob.random_instance(5, **kw).device_arrays()
    assert got.suit_rank.shape == (60, 3)
    for f in dataclasses.fields(own):
        a, b = getattr(got, f.name), getattr(own, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_dump_tim_round_trips(medium_problem):
    text = tprob.dump_tim(tprob.load_tim(jprob.dump_tim(medium_problem)))
    assert text == jprob.dump_tim(medium_problem)
    again = tprob.load_tim(text)
    _same_host(again, jprob.load_tim(text))


@pytest.mark.parametrize("gen,kw", [
    ("random_instance", dict(n_events=40, n_rooms=5, n_features=4,
                             n_students=30)),
    ("itc_like_instance", dict(n_events=60, n_rooms=4, n_features=5,
                               n_students=40, return_planted=True))])
def test_generators_match_jax(gen, kw):
    j = getattr(jprob, gen)(9, **kw)
    t = getattr(tprob, gen)(9, **kw)
    if kw.get("return_planted"):
        for a, b in zip(j[1:], t[1:]):
            np.testing.assert_array_equal(a, b)
        j, t = j[0], t[0]
    _same_host(j, t)


@pytest.mark.parametrize("seed,kw", [
    (0, dict(n_events=40, n_rooms=5, n_features=4, n_students=30)),
    (3, dict(n_events=60, n_rooms=3, n_features=6, n_students=50,
             attend_prob=0.08, feature_prob=0.6)),
    (11, dict(n_events=25, n_rooms=2, n_features=8, n_students=20))])
def test_room_tight_instance_matches_jax(seed, kw):
    """room_tight_instance (JAX problem.py:443), field by field; each
    case needs the orphan repair (its rooms' features differ from the
    raw draw)."""
    j = jprob.room_tight_instance(seed, **kw)
    t = tprob.room_tight_instance(seed, **kw)
    _same_host(j, t)
    assert t.possible.any(axis=1).all()
    rng = np.random.default_rng(seed)
    rng.random((kw["n_students"], kw["n_events"]))
    rng.random((kw["n_events"], kw["n_features"]))
    raw = (rng.random((kw["n_rooms"], kw["n_features"])) < 0.4)
    assert not np.array_equal(raw, t.room_features.astype(bool))


def test_loader_errors_match_jax():
    for bad in ("3 2 1 2\n10 5\n1 1 0\n", "3 2 1 2\n10 5\n1 1 0\n0 1 1\n"
                "1\n0\n0\n0\n1\n7\n"):
        with pytest.raises(ValueError):
            jprob.load_tim(bad)
        with pytest.raises(ValueError):
            tprob.load_tim(bad)
