"""The accord control channel (runtime/control_channel.py) against JAX's.

Every loopback scenario of the JAX accord tests (tests/test_accord.py,
the verdict merge, the solo channel, the process-0-wins fence, the
guard rendezvous, fault consensus in its one-sees / both-see / abort
forms, heartbeat expiry and `--peer-timeout 0`) runs on the port's
channel and on JAX's with the same script; both give the same verdicts.
JAX's module imports no JAX at import, so both run in this process.
Then the port's store backend (`DistributedChannel` over a real
torch.distributed TCPStore on localhost): the same protocol between two
views of one store, and a silent peer classified PeerLost. The `@proc`
fault scoping and the one-process accord on/off stream identity close
the file.
"""

import datetime
import io
import json
import threading
import time

import pytest
import torch

from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu.runtime import control_channel as jcc
from timetabling_ga_tpu.runtime import faults as jfaults
from timetabling_ga_tpu_torch.runtime import control_channel as tcc
from timetabling_ga_tpu_torch.runtime import faults as tfaults
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl
from timetabling_ga_tpu_torch.runtime import retry as tretry

torch.set_num_threads(1)


def _spawn(fn, *args):
    """Run fn(*args) on a thread, capturing its result or exception."""
    box = [None]

    def run():
        try:
            box[0] = fn(*args)
        except BaseException as e:        # re-raised by _join
            box[0] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _join(threads, boxes, timeout=30.0):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "accord protocol thread hung"
    for b in boxes:
        if isinstance(b[0], BaseException):
            raise b[0]


def _close(*chs):
    for ch in chs:
        ch.close()


# --------------------------------------------------------------- scenarios
# each takes a control_channel module and returns what it observed; the
# test holds the port's observation equal to JAX's

def s_merge(cc):
    out = [cc.merge_verdicts([
        {"proc": 1, "site": "dispatch", "action": "recover", "gens": 10},
        {"proc": 0, "site": "accord", "action": "recover", "gens": 10}]),
        cc.merge_verdicts([
            {"proc": 0, "site": "dispatch", "action": "recover", "gens": 5},
            {"proc": 1, "site": "fetch", "action": "abort", "gens": 5}]),
        cc.merge_verdicts([
            {"proc": 1, "site": "fetch", "action": "recover", "gens": 5},
            {"proc": 0, "site": "dispatch", "action": "recover",
             "gens": 5}])]
    with pytest.raises(ValueError):
        cc.merge_verdicts([])
    return out


def s_solo(cc):
    ch = cc.LoopbackChannel.solo()
    try:
        assert ch._hb_thread is None
        ch.guard_collective()
        return [ch.agree("s", [3, 7]), ch.agree_on_fault(
            {"site": "dispatch", "action": "recover", "gens": 10})]
    finally:
        ch.close()


def s_registry(cc):
    assert cc.open_channel(accord=False) is None
    ch = cc.open_channel(accord=True)
    try:
        assert isinstance(ch, cc.LoopbackChannel)
        assert cc.active() is None
        assert cc.install(ch) is ch and cc.active() is ch
        return ch.nproc
    finally:
        cc.install(None)
        ch.close()


def s_agree(cc):
    ch0, ch1 = cc.LoopbackChannel.group(2)
    try:
        t, box = _spawn(ch1.agree, "s", [0, 0])
        first = ch0.agree("s", [5, 9])
        _join([t], [])
        t2, box2 = _spawn(ch1.agree, "s", None)
        second = ch0.agree("s", [1])
        _join([t2], [])
        return [first, box[0], second, box2[0]]
    finally:
        _close(ch0, ch1)


def s_guard(cc):
    ch0, ch1 = cc.LoopbackChannel.group(2)
    try:
        t, box = _spawn(ch1.guard_collective)
        ch0.guard_collective()
        _join([t], [box])
        return box[0]
    finally:
        _close(ch0, ch1)


def s_one_sees_fault(cc):
    ch0, ch1 = cc.LoopbackChannel.group(2)
    try:
        seen = [None]

        def p1_side():
            try:
                ch1.guard_collective()
            except cc.AccordPeerFault as e:
                seen[0] = (type(e).__name__, tretry.is_transient(e))
                return ch1.agree_on_fault(
                    {"site": "accord", "action": "recover", "gens": 10})
            raise AssertionError("the guard passed with a faulted peer")

        t1, box1 = _spawn(p1_side)
        time.sleep(0.1)
        agreed0 = ch0.agree_on_fault(
            {"site": "dispatch", "action": "recover", "gens": 10})
        _join([t1], [box1])
        epochs = (ch0.epoch, ch1.epoch)
        t2, box2 = _spawn(ch1.guard_collective)
        ch0.guard_collective()                 # fresh keys after the bump
        _join([t2], [box2])
        return [seen[0], agreed0, box1[0], epochs]
    finally:
        _close(ch0, ch1)


def s_both_see_fault(cc):
    ch0, ch1 = cc.LoopbackChannel.group(2)
    try:
        t1, box1 = _spawn(ch1.agree_on_fault,
                          {"site": "fetch", "action": "recover", "gens": 10})
        agreed0 = ch0.agree_on_fault(
            {"site": "dispatch", "action": "recover", "gens": 10})
        _join([t1], [box1])
        return [agreed0, box1[0]]
    finally:
        _close(ch0, ch1)


def s_abort_wins(cc):
    ch0, ch1 = cc.LoopbackChannel.group(2)
    try:
        t1, box1 = _spawn(ch1.agree_on_fault,
                          {"site": "dispatch", "action": "abort", "gens": 10})
        agreed0 = ch0.agree_on_fault(
            {"site": "dispatch", "action": "recover", "gens": 10})
        _join([t1], [box1])
        return [agreed0, box1[0]]
    finally:
        _close(ch0, ch1)


def s_dead_peer_at_guard(cc):
    ch0, ch1 = cc.LoopbackChannel.group(2, peer_timeout=0.5)
    try:
        ch1.kill()
        t0 = time.monotonic()
        with pytest.raises(cc.PeerLost) as ei:
            ch0.guard_collective()
        assert time.monotonic() - t0 < 10.0
        assert ei.value.silence_s > 0.5
        return [ei.value.proc, tretry.is_transient(ei.value),
                str(ei.value).split(":")[0]]
    finally:
        _close(ch0, ch1)


def s_lost_mid_agreement(cc):
    ch0, ch1 = cc.LoopbackChannel.group(2, peer_timeout=0.5)
    try:
        ch1.kill()
        agreed = ch0.agree_on_fault(
            {"site": "dispatch", "action": "recover", "gens": 10})
        agreed.pop("silence_s")
        return agreed
    finally:
        _close(ch0, ch1)


def s_timeout_zero(cc):
    ch0, ch1 = cc.LoopbackChannel.group(2, peer_timeout=0.0)
    try:
        ch1.kill()
        t0, box0 = _spawn(ch0.guard_collective)
        time.sleep(0.8)
        waiting = t0.is_alive()
        ch1.guard_collective()
        _join([t0], [box0])
        return waiting
    finally:
        _close(ch0, ch1)


SCENARIOS = {f.__name__[2:]: f for f in (
    s_merge, s_solo, s_registry, s_agree, s_guard, s_one_sees_fault,
    s_both_see_fault, s_abort_wins, s_dead_peer_at_guard,
    s_lost_mid_agreement, s_timeout_zero)}

WANT = {
    "agree": [[5, 9], [5, 9], [1], [1]],
    "guard": None,
    "one_sees_fault": None,       # checked field by field below
    "dead_peer_at_guard": [1, False, "lost contact with process 1"],
    "timeout_zero": True,
    "registry": 1,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_loopback_scenario_gives_jax_verdicts(name):
    got = SCENARIOS[name](tcc)
    want = SCENARIOS[name](jcc)
    assert got == want
    if name in WANT and WANT[name] is not None:
        assert got == WANT[name]
    if name == "one_sees_fault":
        seen, agreed0, agreed1, epochs = got
        assert seen == ("AccordPeerFault", True)
        assert agreed0 == agreed1 and agreed0["site"] == "dispatch"
        assert agreed0["decider"] == 0 and epochs == (1, 1)
    if name in ("both_see_fault", "abort_wins"):
        assert got[0] == got[1]
    if name == "abort_wins":
        assert got[0]["action"] == "abort" and got[0]["decider"] == 1
    if name == "lost_mid_agreement":
        assert got["action"] == "abort" and got["lost"] is True


# ------------------------------------------------- the store backend

def _store_pair(peer_timeout=60.0, hb=None):
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, 1, True,
                          timeout=datetime.timedelta(seconds=10))
    return store, [tcc.DistributedChannel(store, p, 2, peer_timeout,
                                          hb_interval=hb,
                                          namespace="tt-accord/t")
                   for p in range(2)]


def test_store_channel_runs_the_protocol():
    """Two views of one TCPStore: process 0 wins the fence, the guard
    meets, both adopt one fault verdict, and the fault flag stays its
    first writer's (compare_set)."""
    _, (ch0, ch1) = _store_pair()
    try:
        t, box = _spawn(ch1.agree, "s", [0])
        assert ch0.agree("s", [4, 2]) == [4, 2]
        _join([t], [box])
        assert box[0] == [4, 2]
        t, box = _spawn(ch1.guard_collective)
        ch0.guard_collective()
        _join([t], [box])
        t, box = _spawn(ch1.agree_on_fault,
                        {"site": "fetch", "action": "recover", "gens": 3})
        agreed = ch0.agree_on_fault(
            {"site": "dispatch", "action": "recover", "gens": 3})
        _join([t], [box])
        assert agreed == box[0]
        assert agreed["site"] == "dispatch" and agreed["decider"] == 0
        assert agreed["procs"] == [0, 1] and ch0.epoch == ch1.epoch == 1
        ch0._set("x", "first")
        ch1._set("x", "second")
        assert ch1._get("x", 0.0) == "first"
        assert ch0._get("missing", 0.05) is None
    finally:
        _close(ch0, ch1)


def test_store_channel_classifies_a_silent_peer():
    """A peer that stops beating is PeerLost at the guard within the
    timeout, as on the loopback."""
    _, (ch0, ch1) = _store_pair(peer_timeout=0.6, hb=0.05)
    try:
        time.sleep(0.2)
        ch1.close()
        t0 = time.monotonic()
        with pytest.raises(tcc.PeerLost) as ei:
            ch0.guard_collective()
        assert ei.value.proc == 1
        assert 0.6 < time.monotonic() - t0 + 0.2 < 10.0
    finally:
        ch0.close()


def test_channel_module_loads_no_torch():
    import subprocess
    import sys
    code = ("import sys; import timetabling_ga_tpu_torch.runtime."
            "control_channel as c; c.LoopbackChannel.solo().close(); "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "False"


# ------------------------------------------------ fault scoping, A/B

def test_fault_plan_process_scoping_as_jax():
    spec = "dispatch@1:2:die,dispatch@0:1:hang,fetch:1:error"
    try:
        for proc, n in ((1, 2), (0, 2), (0, 1)):
            seen = []
            for mod in (tfaults, jfaults):
                mod.set_process(proc, n)
                plan = mod.FaultPlan.parse(spec)
                seen.append([plan.pop_action(s) for s in
                             ("dispatch", "dispatch", "fetch")])
            assert seen[0] == seen[1], (proc, n)
    finally:
        tfaults.set_process(0, 1)
        jfaults.set_process(0, 1)


@pytest.fixture(scope="module")
def tim_file(tmp_path_factory):
    problem = random_instance(55, n_events=15, n_rooms=5, n_features=2,
                              n_students=10, attend_prob=0.1)
    path = tmp_path_factory.mktemp("accord") / "tiny.tim"
    path.write_text(dump_tim(problem))
    return str(path)


def _go(tim_file, *flags):
    from timetabling_ga_tpu_torch.runtime import config, engine
    cfg = config.parse_args(
        ["-i", tim_file, "-s", "3", "--pop-size", "8", "--islands", "1",
         "--generations", "30", "--migration-period", "10", "-m", "8",
         "-t", "300", "--backend", "cpu", "--no-auto-tune", "--trace",
         *flags])
    buf = io.StringIO()
    best = engine.run(cfg, out=buf)
    return best, [json.loads(x) for x in buf.getvalue().splitlines()]


def test_single_process_stream_identical_accord_on_off(tim_file):
    """One process: the same stream with the channel on (the solo
    loopback) or off, and a recovery through the solo channel adds no
    accord fields (JAX tests/test_accord.py:329-347)."""
    best_on, on = _go(tim_file)
    best_off, off = _go(tim_file, "--no-accord")
    assert best_on == best_off
    assert tjsonl.strip_timing(on) == tjsonl.strip_timing(off)
    best_f, lines = _go(tim_file, "--faults", "dispatch:2:unavailable")
    fe = [x["faultEntry"] for x in lines if "faultEntry" in x]
    assert [e["action"] for e in fe] == ["recover"]
    assert "agreed" not in fe[0] and "proc" not in fe[0]
    assert best_f == best_on
    assert tjsonl.strip_timing(lines) == tjsonl.strip_timing(on)
