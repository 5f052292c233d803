"""Warm starts in the port's serve path (serve/snapshot.py, a submit's
`snapshot`, ship units, `_admit_resumed`) against the JAX package on the
CPU, mirroring tests/test_resume.py:

  - the wire round-trips both ways between the packages (arrays, meta
    and fingerprint equal; wires compared unpacked, never by their npz
    strings, which carry a time stamp);
  - JAX's `test_wire_roundtrip_and_rejections` cases, one parametrised
    test: each damaged or foreign wire raises the same class with the
    same message in both packages;
  - a resumed job's stream: the shipped prefix plus the continuation
    equals the uninterrupted stream under strip_timing, `resumed_at` is
    10, and the resumed group stays resident from its first quantum;
  - a bad wire demotes to a fresh solve (faultEntry resume / replay,
    serve.jobs_resume_rejected) whose stream is the plain one;
  - a wire shipped by the JAX service warm-starts the port's.
"""

import io
import json

import numpy as np
import pytest
import torch

from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.runtime.config import ServeConfig as JServeConfig
from timetabling_ga_tpu.serve import snapshot as jsnap
from timetabling_ga_tpu.serve.service import SolveService as JSolveService
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime.config import ServeConfig
from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
from timetabling_ga_tpu_torch.serve import snapshot as tsnap
from timetabling_ga_tpu_torch.serve.service import SolveService

torch.set_num_threads(1)

_TIM_A = dump_tim(random_instance(71, n_events=12, n_rooms=3, n_features=2,
                                  n_students=8, attend_prob=0.2))
_TIM_B = dump_tim(random_instance(72, n_events=40, n_rooms=4, n_features=2,
                                  n_students=30, attend_prob=0.1))


def _cfg(**kw):
    """JAX tests/test_resume.py's serve config, on the CPU."""
    kw.setdefault("backend", "cpu")
    kw.setdefault("lanes", 2)
    kw.setdefault("quantum", 5)
    kw.setdefault("pop_size", 4)
    kw.setdefault("max_steps", 8)
    return ServeConfig(**kw)


def _service(out, **kw):
    return SolveService(_cfg(**kw), out=out, registry=MetricsRegistry())


def _job_records(text, job_id):
    out = []
    for line in text.splitlines():
        rec = json.loads(line)
        body = rec[next(iter(rec))]
        if isinstance(body, dict) and body.get("job") == str(job_id):
            out.append(rec)
    return out


def _baseline(jobs):
    buf = io.StringIO()
    svc = _service(buf)
    for jid, tim, seed, gens in jobs:
        svc.submit(load_tim(tim), job_id=jid, seed=seed, generations=gens)
    svc.drive()
    svc.close()
    return {jid: strip_timing(_job_records(buf.getvalue(), jid))
            for jid, *_ in jobs}


def _state(seed, pop=4, E=32):
    g = np.random.default_rng(seed)
    return tga.PopState(
        g.integers(0, 45, (pop, E)).astype(np.int32),
        g.integers(0, 4, (pop, E)).astype(np.int32),
        *(g.integers(0, 10 ** 6, pop).astype(np.int32) for _ in range(3)))


_META = dict(bucket=(32, 4, 4, 32, 5, 9), pop_size=4, seed=5,
             gens_done=15, chunks=3, emitted=873, best=870)


# ---------------------------------------------------------- wire format

@pytest.mark.parametrize("packer", ["port", "jax"])
def test_wire_round_trips_between_the_packages(packer):
    st = _state(1)
    pack = tsnap.pack_state if packer == "port" else jsnap.pack_state
    wire = json.loads(json.dumps(pack(st, **_META)))
    assert wire["fingerprint"] == tsnap.wire_fingerprint(
        _META["bucket"], 4, 5) == jsnap.wire_fingerprint(
        _META["bucket"], 4, 5)
    for unpack in (tsnap.unpack_state, jsnap.unpack_state):
        got, meta = unpack(wire, expect_fingerprint=wire["fingerprint"])
        for f, x in enumerate(st):
            np.testing.assert_array_equal(np.asarray(got[f]), x)
            assert np.asarray(got[f]).dtype == np.int32
        assert meta == {k: _META[k] for k in ("gens_done", "chunks",
                                              "emitted", "best")}
    assert tsnap.verify_wire(wire) == jsnap.verify_wire(wire)
    assert (tsnap.WIRE_VERSION, tsnap.SHIP_RECORDS_CAP, tsnap._FIELDS,
            tsnap._REQUIRED) == (jsnap.WIRE_VERSION, jsnap.SHIP_RECORDS_CAP,
                                 jsnap._FIELDS, jsnap._REQUIRED)


def _damaged(wire, case):
    return {
        "mismatch": (wire, tsnap.wire_fingerprint(_META["bucket"], 8, 5)),
        "truncated": (dict(wire, npz=wire["npz"][:len(wire["npz"]) // 2]),
                      None),
        "crc": (dict(wire, crc=wire["crc"] ^ 1), None),
        "missing": ({k: v for k, v in wire.items() if k != "gens_done"},
                    None),
        "version": (dict(wire, v=99), None),
        "not_an_object": ("wire", None),
        "bad_base64": (dict(wire, npz="!!" + wire["npz"][2:]), None),
        "torn_npz": (_torn(wire), None),
    }[case]


def _torn(wire):
    """A wire whose npz bytes pass the CRC but are no zip."""
    import base64
    import zlib
    raw = b"not a zip archive at all"
    return dict(wire, npz=base64.b64encode(raw).decode("ascii"),
                bytes=len(raw), crc=zlib.crc32(raw) & 0xFFFFFFFF)


@pytest.mark.parametrize("case", ["mismatch", "truncated", "crc", "missing",
                                  "version", "not_an_object", "bad_base64",
                                  "torn_npz"])
def test_wire_rejections_match_jax(case):
    """JAX's rejection cases (and the torn payload): the same class and
    message from both packages; the mismatch names both fingerprints,
    the damage its field."""
    wire = tsnap.pack_state(_state(2), **_META)
    bad, expect = _damaged(wire, case)
    errors = []
    for mod in (tsnap, jsnap):
        with pytest.raises((mod.SnapshotCorrupt, mod.SnapshotMismatch)) \
                as ei:
            mod.unpack_state(bad, expect_fingerprint=expect)
        errors.append((type(ei.value).__name__, str(ei.value)))
    assert errors[0][0] == errors[1][0]
    if case == "torn_npz":
        assert errors[0][1].startswith("snapshot npz payload unreadable")
    else:
        assert errors[0][1] == errors[1][1]
    kind = "SnapshotMismatch" if case in ("mismatch", "version") \
        else "SnapshotCorrupt"
    assert errors[0][0] == kind
    if case == "mismatch":
        assert wire["fingerprint"] in errors[0][1] and expect in errors[0][1]


def test_ship_unit_packs_once():
    unit = tsnap.ShipUnit(state=_state(3), bucket=_META["bucket"],
                          pop_size=4, seed=5, gens_done=15, chunks=3,
                          emitted=873, best=870, records=[])
    wire = unit.pack()
    assert unit.pack() is wire
    assert "usage" not in wire
    # a wire with a meter cursor (JAX's, metered) validates and unpacks
    metered = jsnap.pack_state(_state(3), **_META, usage={"gens": 3})
    assert "usage" in metered
    np.testing.assert_array_equal(tsnap.unpack_state(metered)[0].slots,
                                  _state(3).slots)


# -------------------------------------------------------- resume (serve)

def test_resumed_stream_identity():
    """Prefix (the shipped records) plus continuation (a new service
    resumed from the wire) equals the uninterrupted stream, modulo
    timing and fault records; the resumed job reports resumed_at 10."""
    base = _baseline([("r", _TIM_A, 3, 20)])
    buf1 = io.StringIO()
    svc1 = _service(buf1)
    svc1.submit(load_tim(_TIM_A), job_id="r", seed=3, generations=20)
    svc1.step()
    svc1.step()
    # the group went resident after its first park: shipping the current
    # progress is a flush
    assert svc1.scheduler._resident
    assert svc1.scheduler.flush_resident() == 1
    ship = svc1.queue.get("r").ship
    wire = json.loads(json.dumps(ship.pack()))
    prefix = list(ship.records)
    assert ship.gens_done == 10 and not ship.truncated
    svc1.close()

    buf2 = io.StringIO()
    svc2 = _service(buf2)
    svc2.submit(load_tim(_TIM_A), job_id="r", seed=3, generations=20,
                snapshot=wire)
    job = svc2.queue.get("r")
    assert job.state == "parked" and job.gens_done == 10
    assert job.ship is not None and job.ship.records == []
    svc2.drive()
    svc2.close()
    cont = _job_records(buf2.getvalue(), "r")
    seams = [r["faultEntry"] for r in cont if "faultEntry" in r]
    assert [(f["site"], f["action"], f["gens"]) for f in seams] == [
        ("fleet", "resume", 10)]
    assert strip_timing(prefix + cont) == base["r"]
    assert svc2.result("r")["resumed_at"] == 10
    c = svc2.registry.snapshot()["counters"]
    assert c["serve.jobs_resumed"] == 1 and c["serve.jobs_admitted"] == 1
    # a warm-started job ships from admission: its group stays resident
    # from its first quantum (two quanta: one resident hit)
    assert c["serve.resident_hits"] == 1


@pytest.mark.parametrize("case", ["corrupt", "foreign", "not_an_object"])
def test_bad_snapshot_demotes_to_replay(case):
    """A damaged or foreign wire falls back to a fresh solve, never an
    error: one faultEntry resume / replay, serve.jobs_resume_rejected,
    and the plain stream."""
    base = _baseline([("d", _TIM_A, 3, 10)])
    buf1 = io.StringIO()
    svc1 = _service(buf1)
    svc1.submit(load_tim(_TIM_A), job_id="seed", seed=3, generations=10)
    svc1.step()
    wire = svc1.queue.get("seed").ship.pack()
    svc1.close()
    bad = {"corrupt": dict(wire, npz=wire["npz"][:40]),
           "foreign": dict(wire, fingerprint="j1|b9|p9|s9"),
           "not_an_object": []}[case]
    buf = io.StringIO()
    svc = _service(buf)
    svc.submit(load_tim(_TIM_A), job_id="d", seed=3, generations=10,
               snapshot=bad)
    assert svc.queue.get("d").state == "pending"
    svc.drive()
    svc.close()
    recs = _job_records(buf.getvalue(), "d")
    assert strip_timing(recs) == base["d"]
    faults = [(r["faultEntry"]["site"], r["faultEntry"]["action"])
              for r in recs if "faultEntry" in r]
    assert faults == [("resume", "replay")]
    c = svc.registry.snapshot()["counters"]
    assert c["serve.jobs_resume_rejected"] == 1
    assert svc.result("d")["resumed_at"] == 0


def test_a_jax_wire_warm_starts_the_port():
    """A wire the JAX service shipped (its job parked at generation 5)
    admits the port's job PARKED at that progress; the port runs the
    rest of the budget from those rows."""
    jsvc = JSolveService(JServeConfig(backend="cpu", lanes=2, quantum=5,
                                      pop_size=4, max_steps=8,
                                      mesh_devices=1, usage=False),
                         out=io.StringIO())
    from timetabling_ga_tpu.problem import load_tim as jload
    jsvc.submit(jload(_TIM_B), job_id="x", seed=4, generations=15)
    jsvc.step()
    wire = json.loads(json.dumps(jsvc.queue.get("x").ship.pack()))
    jsvc.close()
    assert wire["gens_done"] == 5
    buf = io.StringIO()
    svc = _service(buf)
    svc.submit(load_tim(_TIM_B), job_id="x", seed=4, generations=15,
               snapshot=wire)
    job = svc.queue.get("x")
    assert (job.state, job.gens_done, job.chunks) == ("parked", 5, 1)
    np.testing.assert_array_equal(job.snapshot.slots,
                                  jsnap.unpack_state(wire)[0].slots)
    svc.drive()
    svc.close()
    res = svc.result("x")
    assert res["resumed_at"] == 5 and res["gens"] == 15
    assert res["best"] <= wire["best"]
    events = [r["jobEntry"]["event"] for r in _job_records(buf.getvalue(),
                                                           "x")
              if "jobEntry" in r]
    assert events == ["done"]
