"""The port's serve path (timetabling_ga_tpu_torch/serve) against the
JAX package's, on the CPU.

  - bucketing: bucket_dims, bucket_key, pad_problem, embed_population
    and extract_solution equal JAX's exactly; padded and unpadded
    penalties (and live rooms) are equal in the port, as
    tests/test_serve.py shows for JAX;
  - the job queue: one scripted sequence of submits, cancels and
    admission errors gives JAX's ready() orders and messages;
  - the serve flags: ported flags give JAX's fields, bad values JAX's
    messages, and every flag the port does not serve is refused by name;
  - co-tenant independence in the port: a job's records are the same
    alone, packed with three others, with --no-resident, and across a
    repack;
  - the serving skeleton against JAX's serve_stream on one request
    file: each job's lifecycle records, the solution and runEntry
    records, and the schedule counters. Scores are compared by outcome:
    every done job ends feasible in both, and each feasible solution
    re-scores to its totalBest on the unpadded instance;
  - `python -m timetabling_ga_tpu_torch serve --backend cpu` through
    cli.main, with a bad snapshot, a malformed edit and the request
    that is not ported yet.
"""

import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from timetabling_ga_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
from timetabling_ga_tpu.problem import (
    dump_tim, itc_like_instance, load_tim_file, random_instance)
from timetabling_ga_tpu.runtime import config as jconfig
from timetabling_ga_tpu.serve import bucket as jbucket
from timetabling_ga_tpu.serve import queue as jqueue
from timetabling_ga_tpu.serve.service import serve_stream as jax_serve
from timetabling_ga_tpu_torch import cli
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
from timetabling_ga_tpu_torch.ops import fitness, rooms
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime import config as tconfig
from timetabling_ga_tpu_torch.runtime.jsonl import strip_timing
from timetabling_ga_tpu_torch.serve import bucket as tbucket
from timetabling_ga_tpu_torch.serve import queue as tqueue
from timetabling_ga_tpu_torch.serve.service import SolveService, serve_stream

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures")


def _port(problem):
    """The port's Problem of a JAX Problem (through its .tim text)."""
    return load_tim(dump_tim(problem))


def _anchored(problem, seed):
    rng = np.random.default_rng(seed)
    return dataclasses.replace(
        problem,
        anchor_slots=rng.integers(0, problem.n_slots,
                                  problem.n_events).astype(np.int32),
        anchor_w=rng.integers(0, 4, problem.n_events).astype(np.int32))


def _instances():
    return {
        "e10": random_instance(3, n_events=10, n_rooms=3, n_features=2,
                               n_students=8, attend_prob=0.2),
        "e33": random_instance(0, n_events=33, n_rooms=9, n_features=5,
                               n_students=70, attend_prob=0.05),
        "e64": random_instance(4, n_events=64, n_rooms=4, n_features=4,
                               n_students=32, attend_prob=0.1),
        "itc80": itc_like_instance(5, n_events=80, n_rooms=5,
                                   n_features=4, n_students=40),
        "comp01s": load_tim_file(os.path.join(FIXTURES, "comp01s.tim")),
        "comp05s": load_tim_file(os.path.join(FIXTURES, "comp05s.tim")),
    }


# ---------------------------------------------------------------- bucketing

_PROBLEM_ARRAYS = ("room_size", "attends", "room_features",
                   "event_features", "student_count", "conflict",
                   "possible")


@pytest.mark.parametrize("name", ["e10", "e33", "e64", "itc80", "comp01s",
                                  "comp05s"])
def test_bucketing_matches_jax(name):
    jp = _instances()[name]
    if name == "e33":
        jp = _anchored(jp, 1)
    tp = _port(jp)
    if jp.anchor_w is not None:
        tp = dataclasses.replace(tp, anchor_slots=jp.anchor_slots,
                                 anchor_w=jp.anchor_w)
    spec = tbucket.BucketSpec()
    assert tbucket.bucket_dims(tp, spec) == jbucket.bucket_dims(jp)
    assert tbucket.bucket_key(tp, spec) == jbucket.bucket_key(jp)
    assert tbucket.bucket_key_from_counts(
        jp.n_events, jp.n_rooms, jp.n_features, jp.n_students, 5, 9,
        tbucket.BucketSpec(event_floor=16, ratio=1.5)) == \
        jbucket.bucket_key_from_counts(
            jp.n_events, jp.n_rooms, jp.n_features, jp.n_students, 5, 9,
            jbucket.BucketSpec(event_floor=16, ratio=1.5))
    jpad, tpad = jbucket.pad_problem(jp), tbucket.pad_problem(tp)
    for f in _PROBLEM_ARRAYS + ("anchor_slots", "anchor_w"):
        w, g = getattr(jpad, f), getattr(tpad, f)
        if w is None:
            assert g is None, f
        else:
            np.testing.assert_array_equal(w, g, err_msg=f)
    for f in ("n_events", "n_rooms", "n_features", "n_students",
              "n_live_events", "n_live_rooms"):
        assert getattr(jpad, f) == getattr(tpad, f), f
    rng = np.random.default_rng(2)
    slots = rng.integers(0, 45, (3, jp.n_events)).astype(np.int32)
    rms = rng.integers(0, jp.n_rooms, (3, jp.n_events)).astype(np.int32)
    for w, g in zip(jbucket.embed_population(slots, rms, jpad),
                    tbucket.embed_population(slots, rms, tpad)):
        np.testing.assert_array_equal(w, g)
    s_pad, r_pad = tbucket.embed_population(slots, rms, tpad)
    for w, g in zip(jbucket.extract_solution(s_pad[0], r_pad[0], jpad),
                    tbucket.extract_solution(s_pad[0], r_pad[0], tpad)):
        np.testing.assert_array_equal(w, g)
        assert g.shape == (jp.n_events,)


def test_bucketing_refuses_oversized_instances_as_jax_does():
    jp = random_instance(0, n_events=2500, n_rooms=2, n_features=1,
                         n_students=4, attend_prob=0.0)
    with pytest.raises(ValueError) as want:
        jbucket.pad_problem(jp)
    with pytest.raises(ValueError) as got:
        tbucket.pad_problem(_port(jp))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["e33", "comp01s", "comp05s"])
def test_padded_penalty_and_rooms_equal_unpadded(name):
    """In the port, as tests/test_serve.py:103-150 for JAX: the padded
    instance scores any genotype as the unpadded one, bit for bit, and
    the greedy matcher gives the live events the same rooms."""
    tp = _port(_instances()[name])
    pa = tp.device_arrays()
    pad = tbucket.pad_problem(tp).device_arrays()
    assert pad.n_events > pa.n_events or pad.n_rooms > pa.n_rooms
    rng = np.random.default_rng(7)
    slots = rng.integers(0, tp.n_slots, (4, tp.n_events)).astype(np.int32)
    rms = rng.integers(0, tp.n_rooms, (4, tp.n_events)).astype(np.int32)
    s_pad, r_pad = (torch.from_numpy(x) for x in tbucket.embed_population(
        slots, rms, tbucket.pad_problem(tp)))
    s, r = torch.from_numpy(slots), torch.from_numpy(rms)
    for w, g in zip(fitness.batch_penalty_plain(pa, s, r),
                    fitness.batch_penalty_plain(pad, s_pad, r_pad)):
        assert torch.equal(w, g)
    live = rooms.assign_rooms_plain(pad, s_pad)[:, :tp.n_events]
    assert torch.equal(rooms.assign_rooms_plain(pa, s), live)
    assert int(live.max()) < tp.n_rooms


# ---------------------------------------------------------------- the queue

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _queue_script(mod):
    """One scripted sequence on a JobQueue of package `mod`: what each
    step returns or raises, and the ready() orders along the way."""
    q = mod.JobQueue(backlog=4, now=_Clock())
    log = []

    def submit(jid, bucket, priority=0):
        job = mod.Job(id=jid, problem=None, priority=priority)
        job.bucket = bucket
        try:
            log.append(("submit", q.submit(job)))
        except mod.AdmissionError as e:
            log.append(("rejected", str(e)))

    def ready():
        log.append(("ready", [j.id for j in q.ready()],
                    [j.id for j in q.ready((1,))]))

    submit("a", (1,))
    submit("b", (2,), priority=1)
    submit("c", (1,))
    submit("a", (1,))                      # duplicate id
    submit("d", (1,), priority=1)
    submit("e", (2,))                      # backlog full
    ready()
    q.get("b").gens_done = 10              # least-served first: d
    q.get("a").gens_done = 5               # overtakes b, c overtakes a
    ready()
    log.append(("cancel", q.cancel("c"), q.cancel("c"), q.cancel("zz")))
    submit("e", (2,))
    q.get("a").state = mod.JobState.DONE
    log.append(("cancel done", q.cancel("a")))
    ready()
    log.append(("states", sorted((j.id, j.state) for j in q.active()),
                len(q), "c" in q))
    q.forget("c")
    log.append(("forgot", len(q), "c" in q,
                [(j.id, j.seq, j.submitted_t, j.remaining())
                 for j in q.ready()]))
    return log


def test_job_queue_matches_jax():
    assert _queue_script(tqueue) == _queue_script(jqueue)


@pytest.mark.parametrize("tenant", [None, "", " acme ", "a.b c/d", "x" * 80])
def test_tenant_label_matches_jax(tenant):
    from timetabling_ga_tpu.obs.usage import tenant_label
    assert tqueue.tenant_label(tenant) == tenant_label(tenant)


# ---------------------------------------------------------------- the flags

_PORTED_ARGV = ["-i", "req.jsonl", "-o", "out.jsonl", "--lanes", "3",
                "--mesh-devices", "1", "--quantum", "7", "--backlog", "5",
                "--pop-size", "8", "--generations", "50", "-s", "9",
                "--bucket-events", "16", "--bucket-rooms", "2",
                "--bucket-features", "2", "--bucket-students", "16",
                "--bucket-ratio", "1.5", "-m", "16", "--ls-candidates", "4",
                "--trace-mode", "stats", "--quality", "--no-usage",
                "--no-resident"]


@pytest.mark.parametrize("argv", [[], _PORTED_ARGV])
def test_serve_flags_match_jax(argv):
    want = jconfig.parse_serve_args(argv)
    got = tconfig.parse_serve_args(argv)
    for f in dataclasses.fields(got):
        if f.name != "backend":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.backend, want.backend) == ("gpu", "tpu")
    assert tconfig.parse_serve_args(["--backend", "cpu"]).backend == "cpu"


@pytest.mark.parametrize("argv", [
    ["--lanes", "0"], ["--quantum", "0"], ["--backlog", "0"],
    ["--bucket-ratio", "1.0"], ["--mesh-devices", "-1"],
    ["--trace-mode", "bogus"], ["--bogus"], ["--lanes"]])
def test_bad_serve_flags_give_jax_messages(argv):
    with pytest.raises(SystemExit) as want:
        jconfig.parse_serve_args(argv)
    with pytest.raises(SystemExit) as got:
        tconfig.parse_serve_args(argv)
    assert str(got.value) == str(want.value)


# the fleet replica's flags, once refused by name: True = takes a value
_FLEET_SERVE_FLAGS = {"--http": "127.0.0.1:0", "--preempt-grace": "1",
                      "--preempt-on-term": None}


@pytest.mark.parametrize("flag", sorted(_FLEET_SERVE_FLAGS))
def test_unported_serve_flags_are_refused_by_name(flag):
    """The service flags that stopped the parse by name until the fleet
    replica came (`--http`, `--preempt-grace`, `--preempt-on-term`) now
    parse to JAX's values; the service has no flag left to refuse by
    name (--mesh-devices above 1 is refused by value, below)."""
    value = _FLEET_SERVE_FLAGS[flag]
    assert flag in (jconfig._SERVE_FLAG_MAP if value is not None
                    else jconfig._SERVE_BOOL_FLAGS)
    argv = [flag] + ([value] if value is not None else [])
    want = jconfig.parse_serve_args(argv)
    got = tconfig.parse_serve_args(argv)
    for f in ("http", "preempt_grace", "preempt_on_term"):
        assert getattr(got, f) == getattr(want, f), (flag, f)


@pytest.mark.parametrize("argv,what", [
    (["--mesh-devices", "2"], "--mesh-devices 2"),
    (["--mesh-devices", "4"], "--mesh-devices 4"),
    (["--quality", "--mesh-devices", "8"], "--mesh-devices 8")])
def test_unported_serve_values_are_refused_by_name(argv, what):
    jconfig.parse_serve_args(argv)
    with pytest.raises(SystemExit) as e:
        tconfig.parse_serve_args(argv)
    assert str(e.value).startswith(what) and "not yet ported" in str(e.value)


def test_every_jax_serve_flag_is_ported_or_refused():
    ported = (set(tconfig._SERVE_FLAG_MAP) | set(tconfig._SERVE_BOOL_FLAGS)
              | set(tconfig._SERVE_NEG_BOOL_FLAGS))
    for flag in (set(jconfig._SERVE_FLAG_MAP) | set(jconfig._SERVE_BOOL_FLAGS)
                 | set(jconfig._SERVE_NEG_BOOL_FLAGS)):
        assert flag in ported, flag


# --------------------------------------------- the port's co-tenancy

_SERVE_ARGV = ["--backend", "cpu", "--lanes", "4", "--quantum", "3",
               "--pop-size", "4", "-m", "8"]


def _bucket32():
    """Four different instances of the (32, 4, 4, 32) bucket."""
    return [dump_tim(random_instance(30 + i, n_events=n, n_rooms=r,
                                     n_features=3, n_students=s,
                                     attend_prob=0.12))
            for i, (n, r, s) in enumerate([(20, 3, 16), (28, 4, 24),
                                           (32, 4, 30), (17, 2, 12)])]


def _records(out):
    return [json.loads(x) for x in out.getvalue().splitlines()]


def _job(records, jid):
    return [r for r in records if next(iter(r.values())).get("job") == jid]


def _run_port(subs, extra=(), late=None, steps_before_late=2):
    """Submit `subs` ((id, tim, seed, generations, priority)) to a port
    service, then, with `late`, step `steps_before_late` dispatches,
    submit it and drive; returns the records."""
    out = io.StringIO()
    cfg = tconfig.parse_serve_args(_SERVE_ARGV + list(extra))
    svc = SolveService(cfg, out=out, registry=MetricsRegistry())
    for jid, tim, seed, gens, prio in subs:
        svc.submit(load_tim(tim), job_id=jid, seed=seed, generations=gens,
                   priority=prio)
    if late is not None:
        for _ in range(steps_before_late):
            svc.step()
        jid, tim, seed, gens, prio = late
        svc.submit(load_tim(tim), job_id=jid, seed=seed, generations=gens,
                   priority=prio)
    svc.drive()
    svc.close()
    return _records(out)


def test_co_tenant_independence():
    """Job A's records, under strip_timing, are the same alone, packed
    with three other jobs of its bucket, with --no-resident, and when a
    fifth job of higher priority arrives mid-run, takes a lane (parking
    one job and repacking) and finishes."""
    tims = _bucket32()
    a = ("A", tims[0], 11, 12, 0)
    others = [("B", tims[1], 12, 9, 0), ("C", tims[2], 13, 15, 0),
              ("D", tims[3], 14, 6, 0)]
    alone = strip_timing(_job(_run_port([a]), "A"))
    assert [r["jobEntry"]["event"] for r in alone if "jobEntry" in r] == \
        ["admitted", "started", "done"]
    assert alone[-1]["jobEntry"]["gens"] == 12
    runs = {
        "packed": _run_port([a] + others),
        "no-resident": _run_port([a] + others, ["--no-resident"]),
        "repack": _run_port([a] + others,
                            late=("E", tims[1], 15, 3, 5)),
    }
    for name, records in runs.items():
        assert strip_timing(_job(records, "A")) == alone, name
    # the repack run really parked someone for E and ran E to its end
    rep = runs["repack"]
    assert [r["jobEntry"]["event"] for r in _job(rep, "E")
            if "jobEntry" in r] == ["admitted", "started", "done"]
    for jid in "BCD":
        assert strip_timing(_job(rep, jid)) == strip_timing(
            _job(runs["packed"], jid)), jid


# ------------------------------------------- the skeleton against JAX

def _request_lines(tmp):
    """The skeleton's request file: four jobs of one bucket and one of
    another (round-robin), a fifth job of the first bucket at priority 5
    (it takes a lane for one quantum: a job waits, the pack changes
    twice, then settles and stays resident), a cancelled job, a job
    whose deadline passes before its first slice, a malformed line and
    a submit of a missing file."""
    tims = _bucket32()
    big = dump_tim(random_instance(40, n_events=45, n_rooms=4,
                                   n_features=3, n_students=30,
                                   attend_prob=0.08))
    path = os.path.join(tmp, "j2.tim")
    with open(path, "w") as f:
        f.write(tims[1])
    reqs = [
        {"submit": {"id": "j1", "tim": tims[0], "seed": 1,
                    "generations": 12}},
        {"submit": {"id": "j2", "instance": path, "seed": 2,
                    "generations": 12, "tenant": "acme"}},
        {"submit": {"id": "j3", "tim": tims[2], "seed": 3,
                    "generations": 12}},
        {"submit": {"id": "j4", "tim": tims[3], "seed": 4,
                    "generations": 11}},
        {"submit": {"id": "j5", "tim": big, "seed": 5, "generations": 9}},
        {"submit": {"id": "j6", "tim": tims[0], "seed": 6, "generations": 3,
                    "priority": 5}},
        {"submit": {"id": "j7", "tim": tims[1], "seed": 7}},
        {"cancel": "j7"},
        {"submit": {"id": "j8", "tim": tims[2], "seed": 8,
                    "deadline": 1e-6}},
        "{not json",
        {"submit": {"id": "j9", "instance": os.path.join(tmp, "no.tim")}},
        {"drain": True},
    ]
    return [r if isinstance(r, str) else json.dumps(r) for r in reqs]


SCHEDULE_COUNTERS = ("serve.dispatches", "serve.gens", "serve.resident_hits",
                     "serve.park_bytes", "serve.resume_bytes",
                     "serve.jobs_admitted", "serve.jobs_done",
                     "serve.jobs_failed")
_SKELETON_ARGV = ["--backend", "cpu", "--lanes", "4", "--quantum", "3",
                  "--pop-size", "4", "-m", "8", "--no-usage"]


@pytest.fixture(scope="module")
def skeleton(tmp_path_factory):
    """Both packages' record streams and schedule counters on one request
    file (one JAX run for the module: its lane programs compile once a
    bucket)."""
    tmp = str(tmp_path_factory.mktemp("serve"))
    lines = _request_lines(tmp)
    before = JAX_REGISTRY.snapshot().get("counters", {})
    jout = io.StringIO()
    jax_serve(jconfig.parse_serve_args(_SKELETON_ARGV
                                       + ["--mesh-devices", "1"]),
              io.StringIO("\n".join(lines)), jout)
    after = JAX_REGISTRY.snapshot().get("counters", {})
    jc = {k: after.get(k, 0) - before.get(k, 0) for k in SCHEDULE_COUNTERS}
    reg = MetricsRegistry()
    tout = io.StringIO()
    serve_stream(tconfig.parse_serve_args(_SKELETON_ARGV),
                 io.StringIO("\n".join(lines)), tout, registry=reg)
    tc = {k: reg.snapshot()["counters"].get(k, 0) for k in SCHEDULE_COUNTERS}
    return _records(jout), _records(tout), jc, tc, tmp


_LIFECYCLE_FIELDS = ("event", "bucket", "generations", "priority", "gens",
                     "deadline_hit", "reason", "tenant")


def _lifecycle(records):
    out = {}
    for r in records:
        if "jobEntry" in r:
            e = r["jobEntry"]
            out.setdefault(e["job"], []).append(
                {k: e[k] for k in _LIFECYCLE_FIELDS if k in e})
    return out


def test_serving_skeleton_matches_jax(skeleton):
    jrecs, trecs, _, _, _ = skeleton
    want, got = _lifecycle(jrecs), _lifecycle(trecs)
    assert got == want
    assert [e["event"] for e in got["j7"]] == ["admitted", "cancelled"]
    assert got["j8"][-1] == {"event": "failed", "reason": "deadline",
                             "gens": 0}
    assert got["j1"][-1]["event"] == "done"
    # the record kinds in stream order, per job
    for jid in want:
        kinds = [next(iter(r)) for r in _job(trecs, jid)
                 if "logEntry" not in r]
        assert kinds == [next(iter(r)) for r in _job(jrecs, jid)
                         if "logEntry" not in r], jid


def test_serve_schedule_counters_match_jax(skeleton):
    _, _, jc, tc, _ = skeleton
    assert tc == jc
    assert tc["serve.resident_hits"] > 0 and tc["serve.park_bytes"] > 0


def test_done_jobs_end_feasible_and_rescore(skeleton):
    """Outcomes, not streams: every done job ends feasible in both
    packages, one solution and two runEntry records a done job, and each
    feasible solution re-scores to its totalBest with the port's plain
    penalty on the unpadded instance."""
    jrecs, trecs, _, _, tmp = skeleton
    reqs = {}
    for line in _request_lines(tmp):
        try:
            sub = json.loads(line).get("submit")
        except ValueError:
            continue
        if sub and ("tim" in sub or os.path.exists(sub["instance"])):
            reqs[sub["id"]] = (load_tim(sub["tim"]) if "tim" in sub
                               else load_tim(open(sub["instance"]).read()))
    for records in (jrecs, trecs):
        done = [e["job"] for e in (r["jobEntry"] for r in records
                                   if "jobEntry" in r)
                if e["event"] == "done"]
        assert sorted(done) == ["j1", "j2", "j3", "j4", "j5", "j6"]
        for jid in done:
            recs = _job(records, jid)
            sols = [r["solution"] for r in recs if "solution" in r]
            runs = [r["runEntry"] for r in recs if "runEntry" in r]
            assert len(sols) == 1 and len(runs) == 2
            assert sols[0]["feasible"], jid
            pa = reqs[jid].device_arrays()
            sl = torch.tensor([sols[0]["timeslots"]], dtype=torch.int32)
            rm = torch.tensor([sols[0]["rooms"]], dtype=torch.int32)
            _, hcv, scv = fitness.batch_penalty_plain(pa, sl, rm)
            assert (int(hcv[0]), int(scv[0])) == (0, sols[0]["totalBest"])
            logs = [r["logEntry"]["best"] for r in recs if "logEntry" in r]
            assert logs == sorted(logs, reverse=True)
            assert logs[-1] == sols[0]["totalBest"] == runs[0]["totalBest"]


# ------------------------------------------------------------- the CLI

def test_serve_cli_on_cpu(tmp_path):
    """`python -m timetabling_ga_tpu_torch serve --backend cpu -i ...`
    through cli.main: submits run to their end; a submit whose snapshot
    is no wire falls back to a fresh solve (faultEntry resume / replay),
    a malformed edit and an unknown request get rejected jobEntry
    records, and the stream goes on; stats answers with a metricsEntry,
    a Prometheus stats request with one carrying the text exposition."""
    tims = _bucket32()
    reqs = [{"submit": {"id": "w", "tim": tims[0], "snapshot": {},
                        "generations": 3}},
            {"submit": {"id": "e", "edit": {"base": {"tim": tims[0]}}}},
            {"stats": "prometheus"},
            {"submit": {"id": "k", "tim": tims[1], "seed": 3,
                        "generations": 4}},
            {"bogus": 1},
            {"drain": True},
            {"stats": True}]
    inp, out = tmp_path / "req.jsonl", tmp_path / "out.jsonl"
    inp.write_text("\n".join(json.dumps(r) for r in reqs) + "\n")
    assert cli.main(["serve", "-i", str(inp), "-o", str(out)]
                    + _SERVE_ARGV) == 0
    records = [json.loads(x) for x in out.read_text().splitlines()]
    rejected = [r["jobEntry"] for r in records if "jobEntry" in r
                and r["jobEntry"]["event"] == "rejected"]
    assert [r["job"] for r in rejected] == ["e", "?"]
    assert "exactly one of 'ops' or 'edited'" in rejected[0]["reason"]
    assert "unknown request" in rejected[1]["reason"]
    for jid in "wk":
        events = [r["jobEntry"]["event"] for r in _job(records, jid)
                  if "jobEntry" in r]
        assert events == ["admitted", "started", "done"], jid
    assert [(r["faultEntry"]["site"], r["faultEntry"]["action"])
            for r in _job(records, "w") if "faultEntry" in r] == [
        ("resume", "replay")]
    stats = [r["metricsEntry"] for r in records if "metricsEntry" in r]
    assert len(stats) == 2
    assert "# TYPE tt_serve_backlog gauge" in stats[0]["prometheus"]
    assert "prometheus" not in stats[1]
    assert stats[1]["counters"]["serve.jobs_done"] >= 1
    assert stats[1]["histograms"]["serve.job_seconds"]["count"] >= 1


@pytest.mark.parametrize("sub", ["fleet", "submit"])
def test_other_subcommands_are_refused_by_name(sub, capsys):
    """The JAX CLI's other subcommands are ported now: without their
    input they end as JAX's do, and none is refused by name."""
    from timetabling_ga_tpu import cli as jcli

    def outcome(main):
        try:
            return "rc", main([sub])
        except SystemExit as e:
            return "exit", str(e)
    got, want = outcome(cli.main), outcome(jcli.main)
    assert got == want
    assert "not yet ported" not in str(got[1])
    assert "usage:" in capsys.readouterr().out or got[0] == "exit"


def test_deadline_flushes_a_resident_group():
    """A job whose deadline passes while its group is resident on the
    card finalizes from the generations it ran: the scheduler parks the
    group first, so the result's row 0 scores the best its trace
    reported (a stale snapshot would report an older row). The clock is
    the test's: the deadline passes after the third dispatch."""
    from timetabling_ga_tpu_torch.runtime.jsonl import reported_best
    tims = _bucket32()
    clock = {"t": 0.0}
    out = io.StringIO()
    cfg = tconfig.parse_serve_args(_SERVE_ARGV + ["--quantum", "2"])
    svc = SolveService(cfg, out=out, now=lambda: clock["t"],
                       registry=MetricsRegistry())
    svc.submit(load_tim(tims[0]), job_id="A", seed=3, generations=40,
               deadline_s=100.0)
    svc.submit(load_tim(tims[1]), job_id="B", seed=4, generations=40)
    for _ in range(3):
        svc.step()
    sched = svc.scheduler
    assert sched._resident, "the group should be resident by now"
    clock["t"] = 1000.0
    svc.drive()
    res = svc.result("A")
    assert res["deadline_hit"] and res["gens"] == 6
    assert reported_best(res["hcv"], res["scv"]) == res["best"]
    done = [r["jobEntry"] for r in _records(out)
            if "jobEntry" in r and r["jobEntry"]["event"] == "done"]
    assert [(d["job"], d["gens"], d["deadline_hit"]) for d in done] == [
        ("A", 6, True), ("B", 40, False)]


def test_serve_needs_a_card_unless_cpu():
    """The service runs on the card by default: without one it raises
    rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolveService(tconfig.parse_serve_args([]), out=io.StringIO(),
                     registry=MetricsRegistry())
