"""Edit jobs in the port's serve path (serve/editsolve.py, a submit's
`edit`, the scheduler's `prepare_edit`) against the JAX package on the
CPU, mirroring tests/test_edit.py:

  - the spec checks, apply_ops, diff_problems, resolve_edit,
    anchor_from_wire, attach_anchor, classify and edit_distance equal
    JAX's on parametrised op lists (arrays, maps and messages);
  - Problem.to_tim and the problem JSON codec equal JAX's;
  - the transplant equals JAX's bit for bit (its numpy draws for new
    events included): the unpacked arrays and meta;
  - the demotions: no wire, a cross-bucket edit, a population mismatch
    and an undecodable wire, each one faultEntry (edit / demote) and
    serve.jobs_edit_demoted, the job run cold;
  - an edit job end to end: warm from its base's wire, anchored K6 and
    K8 lane forms on the card (their plain versions here), the result
    and jobEntry keys of JAX's;
  - a w_anchor 0 edit with no wire: its stream equals a plain solve of
    the edited instance.
"""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from timetabling_ga_tpu.fleet import replicas as jreplicas
from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.problem import load_tim as jload_tim
from timetabling_ga_tpu.runtime.config import ServeConfig as JServeConfig
from timetabling_ga_tpu.serve import bucket as jbucket
from timetabling_ga_tpu.serve import editsolve as jedit
from timetabling_ga_tpu.serve import snapshot as jsnap
from timetabling_ga_tpu.serve.service import SolveService as JSolveService
from timetabling_ga_tpu_torch import problem as tproblem
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime.config import ServeConfig
from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
from timetabling_ga_tpu_torch.serve import bucket as tbucket
from timetabling_ga_tpu_torch.serve import editsolve as tedit
from timetabling_ga_tpu_torch.serve import snapshot as tsnap
from timetabling_ga_tpu_torch.serve.service import SolveService, serve_stream

torch.set_num_threads(1)

SPEC = tbucket.BucketSpec()


def _cfg(**kw):
    """JAX tests/test_edit.py's serve config, on the CPU."""
    kw.setdefault("backend", "cpu")
    kw.setdefault("lanes", 2)
    kw.setdefault("quantum", 10)
    kw.setdefault("pop_size", 6)
    kw.setdefault("max_steps", 8)
    return ServeConfig(**kw)


def _records(buf):
    return [json.loads(x) for x in buf.getvalue().splitlines()]


def _jbase(seed=11, n_events=10):
    return random_instance(seed, n_events=n_events, n_rooms=3,
                           n_features=2, n_students=8, attend_prob=0.2)


def _tbase(seed=11, n_events=10):
    return load_tim(dump_tim(_jbase(seed, n_events)))


_PROBLEM_FIELDS = ("n_events", "n_rooms", "n_features", "n_students",
                   "room_size", "attends", "room_features",
                   "event_features", "student_count", "conflict",
                   "possible", "n_days", "slots_per_day", "anchor_slots",
                   "anchor_w")


def _same_problem(got, want):
    for f in _PROBLEM_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)


def _call(fn_t, fn_j, *args, **kw):
    """(port result, JAX result), or the two errors' (class, message)."""
    out = []
    for fn in (fn_t, fn_j):
        try:
            out.append(fn(*args, **kw))
        except (ValueError, RuntimeError) as e:
            out.append((type(e).__name__, str(e)))
    return out


# ---------------------------------------------------------- spec + differ

_BAD_SPECS = ["nope", {"ops": []}, {"base": {}, "ops": [], "edited": {}},
              {"base": {}}, {"base": {}, "ops": [{"op": "explode"}]},
              {"base": {}, "ops": "add"},
              {"base": {}, "ops": [], "w_anchor": -1},
              {"base": {}, "ops": [], "w_anchor": "z"}]


@pytest.mark.parametrize("spec", _BAD_SPECS)
def test_parse_edit_spec_rejections_match_jax(spec):
    got, want = _call(tedit.parse_edit_spec, jedit.parse_edit_spec, spec)
    assert got == want and got[0] == "EditError"


_OPS = {
    "mixed": [{"op": "add_event", "students": [0, 3], "features": [1]},
              {"op": "remove_event", "event": 2},
              {"op": "set_attendance", "event": 0, "student": 5,
               "value": 1},
              {"op": "set_room_size", "room": 1, "size": 1},
              {"op": "set_room_features", "room": 0, "features": [0, 1]},
              {"op": "set_event_features", "event": 1, "features": []}],
    "adds": [{"op": "add_event", "students": [1], "features": []},
             {"op": "add_event", "students": [], "features": [0]},
             {"op": "set_attendance", "event": 10, "student": 2,
              "value": 1}],
    "removes": [{"op": "remove_event", "event": 9},
                {"op": "remove_event", "event": 0}],
    "none": [],
    "bad_event": [{"op": "remove_event", "event": 10}],
    "bad_student": [{"op": "set_attendance", "event": 0, "student": 99,
                     "value": 1}],
    "bad_index": [{"op": "set_room_size", "room": "x", "size": 1}],
    "negative_size": [{"op": "set_room_size", "room": 0, "size": -2}],
    "empties": [{"op": "remove_event", "event": 0}] * 10,
}


@pytest.mark.parametrize("name", sorted(_OPS))
def test_apply_ops_and_diff_match_jax(name):
    ops = _OPS[name]
    got, want = _call(tedit.apply_ops, jedit.apply_ops, _tbase(), ops)
    if isinstance(want, tuple) and isinstance(want[0], str):
        assert got == want and want[0] == "EditError"
        return
    _same_problem(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the differ recovers the map, and its ops rebuild the instance
    ops_t, map_t = tedit.diff_problems(_tbase(), got[0])
    ops_j, map_j = jedit.diff_problems(_jbase(), want[0])
    assert ops_t == ops_j
    np.testing.assert_array_equal(map_t, map_j)
    spec = {"base": {"tim": dump_tim(_jbase())}, "ops": ops}
    for edited in (tedit.resolve_edit(spec)[1],
                   tedit.resolve_edit({"base": spec["base"],
                                       "edited": {"tim": got[0].to_tim()}}
                                      )[1]):
        _same_problem(edited, want[0])


def test_diff_refuses_other_axes_as_jax_does():
    other = random_instance(5, n_events=10, n_rooms=4, n_features=2,
                            n_students=8, attend_prob=0.2)
    with pytest.raises(tedit.EditError) as got:
        tedit.diff_problems(_tbase(), load_tim(dump_tim(other)))
    with pytest.raises(jedit.EditError) as want:
        jedit.diff_problems(_jbase(), other)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("base", [{"tim": "x"}, "job-1", {}, {"problem": {}}])
def test_load_base_problem_refusals_match_jax(base):
    got, want = _call(tedit.load_base_problem, jedit.load_base_problem,
                      base)
    assert got == want


def test_problem_codec_and_to_tim_match_jax():
    jp = _jbase(seed=3, n_events=14)
    tp = load_tim(dump_tim(jp))
    assert tp.to_tim() == jp.to_tim()
    obj = tproblem.problem_to_json(tp)
    assert obj == jreplicas.problem_to_json(jp)
    _same_problem(tproblem.problem_from_json(obj),
                  jreplicas.problem_from_json(obj))
    _same_problem(tedit.load_base_problem({"problem": obj}), tp)
    bad = dict(obj, attends="x")
    got, want = _call(tproblem.problem_from_json,
                      jreplicas.problem_from_json, bad)
    assert got == want and got[0] == "ValueError"


def test_anchor_attach_classify_and_distance_match_jax():
    st = tga.PopState(*(np.asarray(x) for x in (
        np.arange(60).reshape(6, 10) % 45, np.zeros((6, 10)),
        [9, 3, 3, 7, 5, 3], [0] * 6, [4, 2, 1, 0, 8, 9])))
    st = tga.PopState(*(np.asarray(x, np.int32) for x in st))
    wire = tsnap.pack_state(st, bucket=(32, 4, 4, 32, 5, 9), pop_size=6,
                            seed=1, gens_done=0, chunks=0, emitted=0,
                            best=0)
    a_t, a_j = tedit.anchor_from_wire(wire), jedit.anchor_from_wire(wire)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(a_t, st.slots[2])   # (3, 1) is best
    assert tedit.anchor_from_wire(None) is None
    assert tedit.anchor_from_wire({"v": 1}) is None
    edited, emap = tedit.apply_ops(_tbase(), _OPS["mixed"])
    jedited, _ = jedit.apply_ops(_jbase(), _OPS["mixed"])
    for w in (0, 1, 3):
        _same_problem(tedit.attach_anchor(edited, emap, a_t, w),
                      jedit.attach_anchor(jedited, emap, a_j, w))
    assert tedit.attach_anchor(edited, emap, None, 1) is edited
    for key in ((32, 4, 4, 32, 5, 9), (64, 4, 4, 32, 5, 9)):
        assert tedit.classify(key, wire) == jedit.classify(key, wire)
    assert not tedit.classify((32, 4, 4, 32, 5, 9), None)
    final = np.array([1, 9, 9, 4], np.int32)
    anchor = np.array([1, 2, 3, 4], np.int32)
    emap4 = np.array([0, -1, 2, 3], np.int32)
    for args in ((final, anchor, emap4), (final, None, emap4),
                 (final, anchor, None), (final[None], anchor, emap4)):
        assert tedit.edit_distance(*args) == jedit.edit_distance(*args)
    assert tedit.DEFAULT_ANCHOR_W == jedit.DEFAULT_ANCHOR_W


# ------------------------------------------------------------ transplant

def _wire_for(padded, bucket, pop=6, seed=3):
    """A base wire of random rows on `padded` (sorted as a park leaves
    them: the scores are whatever the base problem gave)."""
    g = np.random.default_rng(seed)
    E = padded.n_events
    st = tga.PopState(
        g.integers(0, padded.n_slots, (pop, E)).astype(np.int32),
        g.integers(0, padded.n_rooms, (pop, E)).astype(np.int32),
        *(np.sort(g.integers(0, 10 ** 6, pop)).astype(np.int32)
          for _ in range(3)))
    return st, tsnap.pack_state(st, bucket=bucket, pop_size=pop, seed=seed,
                                gens_done=9, chunks=3, emitted=123,
                                best=123)


@pytest.mark.parametrize("name,w", [("mixed", 1), ("adds", 0), ("adds", 2),
                                    ("removes", 1), ("none", 1)])
def test_transplant_equals_jax_bit_for_bit(name, w):
    """Carried genes, the new events' seeded slots, the re-scoring under
    the edited (anchored) problem and the lex order: the two wires
    unpack to equal arrays and meta."""
    tp = _tbase(seed=71)
    bucket = tbucket.bucket_key(tp, SPEC)
    _st, wire = _wire_for(tbucket.pad_problem(tp, SPEC), bucket)
    wire = json.loads(json.dumps(wire))
    ops = _OPS[name]
    edited, emap = tedit.apply_ops(tp, ops)
    jedited, _ = jedit.apply_ops(_jbase(seed=71), ops)
    a_t, a_j = tedit.anchor_from_wire(wire), jedit.anchor_from_wire(wire)
    t_pad = tbucket.pad_problem(tedit.attach_anchor(edited, emap, a_t, w),
                                SPEC)
    j_pad = jbucket.pad_problem(jedit.attach_anchor(jedited, emap, a_j, w))
    assert tbucket.bucket_key(edited, SPEC) == bucket
    got = tedit.transplant(t_pad, emap, wire, bucket=bucket, pop_size=6,
                           seed=77)
    want = jedit.transplant(j_pad, emap, wire, bucket=bucket, pop_size=6,
                            seed=77)
    (gs, gm), (ws, wm) = tsnap.unpack_state(got), jsnap.unpack_state(want)
    assert gm == wm == {"gens_done": 0, "chunks": 0,
                        "emitted": 2 ** 31 - 1, "best": 2 ** 31 - 1}
    for f, name_f in enumerate(tga.PopState._fields):
        np.testing.assert_array_equal(gs[f], np.asarray(ws[f]),
                                      err_msg=name_f)
    assert got["fingerprint"] == want["fingerprint"]
    if (emap < 0).any():
        fresh = np.flatnonzero(emap < 0)
        assert (gs.rooms[:, fresh] == 0).all()


def test_transplant_demotions_match_jax():
    tp = _tbase(seed=81)
    bucket = tbucket.bucket_key(tp, SPEC)
    _st, wire = _wire_for(tbucket.pad_problem(tp, SPEC), bucket)
    edited, emap = tedit.apply_ops(
        tp, [{"op": "set_room_size", "room": 0, "size": 1}])
    t_pad = tbucket.pad_problem(edited, SPEC)
    j_pad = jbucket.pad_problem(jedit.apply_ops(
        _jbase(seed=81), [{"op": "set_room_size", "room": 0,
                           "size": 1}])[0])
    other = tuple(list(bucket[:-1]) + [bucket[-1] + 1])
    cut = dict(wire, npz=wire["npz"][:len(wire["npz"]) // 2])
    for w, key, pop in ((None, bucket, 6), (wire, other, 6),
                        (wire, bucket, 12), (cut, bucket, 6)):
        errs = []
        for mod, pad in ((tedit, t_pad), (jedit, j_pad)):
            with pytest.raises(mod.EditDemoted) as ei:
                mod.transplant(pad, emap, w, bucket=key, pop_size=pop,
                               seed=1)
            errs.append(str(ei.value))
        if w is not cut:
            assert errs[0] == errs[1]
        else:
            assert errs[0].startswith("base snapshot undecodable")


# ------------------------------------------------------------ service e2e

def _base_wire(tim, pop=6):
    """A finished base job's wire, from the port's service."""
    buf = io.StringIO()
    svc = SolveService(_cfg(pop_size=pop), out=buf,
                       registry=MetricsRegistry())
    svc.submit(load_tim(tim), job_id="base", seed=5, generations=20)
    svc.drive()
    svc.close()
    assert svc.state("base") == "done"
    return json.loads(json.dumps(svc.queue.get("base").ship.pack()))


def _edit_spec(tim, wire, ops, w=1):
    spec = {"base": {"tim": tim}, "base_id": "base", "ops": ops,
            "w_anchor": w}
    if wire is not None:
        spec["snapshot"] = wire
    return spec


_EDIT_OPS = [{"op": "add_event", "students": [2], "features": []},
             {"op": "remove_event", "event": 4},
             {"op": "set_attendance", "event": 1, "student": 3,
              "value": 1}]


def _job_entries(recs, jid):
    return {r["jobEntry"]["event"]: r["jobEntry"] for r in recs
            if "jobEntry" in r and r["jobEntry"]["job"] == jid}


def test_edit_job_end_to_end_matches_jax_keys():
    """An edit job warm from its finished base's wire, through the
    protocol: admitted and done carry mode and edit_of, done the
    edit_distance; the result has JAX's keys (both metered: its tenant
    and usage too, the usage's generations JAX's); nothing demotes."""
    tim = dump_tim(_jbase(seed=91))
    wire = _base_wire(tim)
    spec = _edit_spec(tim, wire, _EDIT_OPS)
    reg = MetricsRegistry()
    out = io.StringIO()
    svc = serve_stream(
        ServeConfig(backend="cpu", lanes=2, quantum=10, pop_size=6,
                    max_steps=8),
        io.StringIO(json.dumps({"submit": {"id": "ed", "seed": 6,
                                           "generations": 10,
                                           "edit": spec}})), out,
        registry=reg)
    jsvc = JSolveService(JServeConfig(backend="cpu", lanes=2, quantum=10,
                                      pop_size=6, max_steps=8,
                                      mesh_devices=1),
                         out=(jout := io.StringIO()))
    jsvc.submit(None, job_id="ed", seed=6, generations=10, edit=spec)
    jsvc.drive()
    jsvc.close()
    res, jres = svc.result("ed"), jsvc.result("ed")
    assert set(res) == set(jres)
    for k in ("mode", "edit_of", "edit_demoted", "gens", "resumed_at",
              "tenant"):
        assert res[k] == jres[k], k
    assert set(res["usage"]) == set(jres["usage"])
    assert res["usage"]["gens"] == jres["usage"]["gens"]
    assert res["usage"]["dispatches"] == jres["usage"]["dispatches"]
    assert res["mode"] == "edit" and res["edit_of"] == "base"
    assert res["edit_demoted"] is False
    assert isinstance(res["edit_distance"], int)
    got, want = _job_entries(_records(out), "ed"), _job_entries(
        _records(jout), "ed")
    assert sorted(got) == sorted(want) == ["admitted", "done"]
    for ev in got:
        assert set(got[ev]) == set(want[ev]), ev
    assert got["done"]["edit_distance"] == res["edit_distance"]
    c = reg.snapshot()["counters"]
    assert c["serve.jobs_edit"] == 1 and c["serve.jobs_resumed"] == 1
    assert c.get("serve.jobs_edit_demoted", 0) == 0
    faults = [r["faultEntry"] for r in _records(out) if "faultEntry" in r]
    assert [(f["site"], f["action"]) for f in faults] == [
        ("fleet", "resume")]


@pytest.mark.parametrize("case", ["no_wire", "cross_bucket", "population",
                                  "undecodable"])
def test_edit_demotions(case):
    """Each valid edit that cannot warm-start runs cold: exactly one
    faultEntry (edit / demote), serve.jobs_edit_demoted, demoted on the
    admitted and done records and in the result."""
    tim = dump_tim(_jbase(seed=93))
    wire = _base_wire(tim, pop=8 if case == "population" else 6)
    ops = _EDIT_OPS
    if case == "no_wire":
        wire = None
    elif case == "cross_bucket":
        # 10 events + 23 more cross the 32-event bucket
        ops = [{"op": "add_event", "students": [i % 8], "features": []}
               for i in range(23)]
    elif case == "undecodable":
        wire = dict(wire, crc=wire["crc"] ^ 1)
    reg = MetricsRegistry()
    out = io.StringIO()
    svc = SolveService(_cfg(), out=out, registry=reg)
    svc.submit(None, job_id="ed", seed=6, generations=10,
               edit=_edit_spec(tim, wire, ops))
    svc.drive()
    svc.close()
    recs = _records(out)
    faults = [r["faultEntry"] for r in recs if "faultEntry" in r]
    assert [(f["site"], f["action"], f["job"]) for f in faults] == [
        ("edit", "demote", "ed")]
    assert reg.snapshot()["counters"]["serve.jobs_edit_demoted"] == 1
    ev = _job_entries(recs, "ed")
    assert ev["admitted"]["demoted"] is True
    assert ev["done"]["demoted"] is True
    assert svc.result("ed")["edit_demoted"] is True
    # anchored where the wire decodes: the distance is reported
    assert (svc.result("ed")["edit_distance"] is None) == (
        case in ("no_wire", "undecodable"))


def test_edit_w_zero_cold_stream_identical_to_plain_solve():
    """A w_anchor 0 edit with no base wire (the cold leg): its solver
    records equal a plain solve of the edited instance."""
    tp = _tbase(seed=101)
    ops = [{"op": "set_attendance", "event": 0, "student": 1, "value": 1},
           {"op": "set_room_size", "room": 2, "size": 3}]
    edited, _ = tedit.apply_ops(tp, ops)

    def solver_stream(buf):
        keep = ("logEntry", "solution", "runEntry")
        return strip_timing([r for r in _records(buf)
                             if next(iter(r)) in keep])

    buf_a = io.StringIO()
    svc_a = SolveService(_cfg(), out=buf_a, registry=MetricsRegistry())
    svc_a.submit(edited, job_id="j", seed=9, generations=12)
    svc_a.drive()
    svc_a.close()
    buf_b = io.StringIO()
    svc_b = SolveService(_cfg(), out=buf_b, registry=MetricsRegistry())
    svc_b.submit(None, job_id="j", seed=9, generations=12,
                 edit={"base": {"tim": tp.to_tim()}, "ops": ops,
                       "w_anchor": 0})
    svc_b.drive()
    svc_b.close()
    assert svc_b.result("j")["edit_demoted"] is True
    assert solver_stream(buf_a) == solver_stream(buf_b)


def test_a_warm_anchored_edit_differs_from_its_unanchored_twin():
    """The anchor reaches the lane kernels: the same warm edit at
    w_anchor 0 and at a large weight ends at different timetables (the
    anchored one no farther from the base's), both warm."""
    tim = dump_tim(_jbase(seed=95))
    wire = _base_wire(tim)
    dist = {}
    for w in (0, 50):
        svc = SolveService(_cfg(), out=io.StringIO(),
                           registry=MetricsRegistry())
        svc.submit(None, job_id="ed", seed=6, generations=20,
                   edit=_edit_spec(tim, wire, _EDIT_OPS, w))
        job = svc.queue.get("ed")
        assert bool(job.padded.anchor_w.any()) == (w > 0)
        svc.drive()
        svc.close()
        res = svc.result("ed")
        assert res["edit_demoted"] is False
        dist[w] = res["edit_distance"]
    assert dist[50] <= dist[0]


def test_malformed_edit_is_rejected():
    out = io.StringIO()
    serve_stream(_cfg(), io.StringIO("\n".join(json.dumps(r) for r in [
        {"submit": {"id": "e1", "edit": {"base": {"tim": "x"}}}},
        {"submit": {"id": "e2", "edit": {"base": "job-7", "ops": []}}},
        {"submit": {"id": "e3", "edit": {"base": {"tim": dump_tim(
            _jbase())}, "ops": [{"op": "remove_event", "event": 99}]}}},
    ])), out, registry=MetricsRegistry())
    rej = [r["jobEntry"] for r in _records(out) if "jobEntry" in r]
    assert [(r["job"], r["event"]) for r in rej] == [
        ("e1", "rejected"), ("e2", "rejected"), ("e3", "rejected")]
    assert "exactly one of 'ops' or 'edited'" in rej[0]["reason"]
    assert "gateway-only form" in rej[1]["reason"]
    assert "out of range" in rej[2]["reason"]


def test_jax_load_tim_roundtrip_of_the_edited_instance():
    """The edited instance's `.tim` text loads in JAX to the same arrays
    (the form a gateway forwards)."""
    edited, _ = tedit.apply_ops(_tbase(), _OPS["mixed"])
    back = jload_tim(edited.to_tim())
    for f in ("attends", "room_size", "room_features", "event_features",
              "possible"):
        np.testing.assert_array_equal(getattr(back, f), getattr(edited, f))
    assert dataclasses.replace(edited).n_events == back.n_events
