"""tt-accord — the out-of-band multi-process control side channel (port
of timetabling_ga_tpu/runtime/control_channel.py, all of it).

Every cross-process decision the run loop makes (chunk sizes,
stop/continue, resume yes/no, whether to kick) is agreed here, on the
host, off the device path: a collective of the process group is part of
the very program whose death the supervisor recovers from, so after a
fault it cannot be trusted to agree on what to do about the fault. The
channel gives schedule agreement (`agree`), a rendezvous before every
collective (`guard_collective`), fault-recovery consensus
(`agree_on_fault`) and a liveness heartbeat that turns a dead peer's
endless collective hang into a classified `PeerLost` within
`--peer-timeout`.

Two backends, one protocol:

* `DistributedChannel` — the run's `torch.distributed.TCPStore` (the
  store process 0 hosts and the process group is built on;
  runtime/engine.py maybe_init_distributed), where JAX uses the
  coordination service's key-value store. Keys are written
  first-write-wins with `compare_set`; a wait polls with a timeout.
  No barrier: a timed-out barrier cannot be entered again (JAX's
  reason, its :22-25), so every wait here is a re-enterable
  first-write-wins rendezvous.
* `LoopbackChannel` — an in-process dict + condition variable sharing
  the exact protocol code (everything above the `_set`/`_get`/beat
  primitives), so every agreement path — heartbeat expiry and
  disagreeing-verdict merges included — tests in one CPU process.
  `kill()` simulates a peer's death by silencing its heartbeat.

Key discipline (what makes replay safe):

* every key is namespaced `e{epoch}/...`; `agree_on_fault` bumps the
  epoch on ALL processes at the same agreement and resets the fence
  counters, so control fences replayed after a recovery write fresh
  keys instead of colliding with their first-attempt values;
* per-run namespaces (`DistributedChannel` is opened once per
  engine.run on every process, in lockstep) keep repeated runs against
  one store from reusing keys;
* the fault flag (`e{epoch}/fault`) is the only key several processes
  write; first-write-wins makes a both-see-fault race benign.

Nothing here launches a collective: recovery rides this channel because
the collective program cannot be trusted after a fault. Import-time
stdlib-only; torch is reached lazily inside `open_channel`.
"""

from __future__ import annotations

import json
import threading
import time

# how often a waiting process re-checks the fault flag and peer
# liveness between key polls. Short enough that fault hand-off latency
# is negligible next to a dispatch chunk; long enough that a waiting
# peer costs a few store round trips a second.
POLL_S = 0.2


class PeerLost(RuntimeError):
    """A peer's heartbeat went silent past --peer-timeout while we
    waited for it at a control fence. NOT transient (the message
    carries no retry.TRANSIENT_MARKERS string): the peer's process is
    gone, no rehydrate brings it back, and the only correct move is
    the agreed clean abort with a final durable checkpoint — never a
    hang at the collective the peer will not join."""

    def __init__(self, proc: int, silence_s: float):
        super().__init__(
            f"lost contact with process {proc}: no heartbeat for "
            f"{silence_s:.1f}s (over --peer-timeout)")
        self.proc = proc
        self.silence_s = silence_s


class AccordPeerFault(RuntimeError):
    """Another process declared a fault on the side channel while this
    one waited at a control fence. The LOCAL program is healthy — the
    message carries the 'peer declared a fault' marker
    retry.TRANSIENT_MARKERS matches, so the supervisor classifies it
    transient and this process joins the recovery agreement instead of
    entering the collective its faulted peer will never reach."""

    tt_site = "accord"

    def __init__(self):
        super().__init__(
            "accord: a peer declared a fault on the control channel; "
            "joining the recovery agreement")


def merge_verdicts(verdicts: list) -> dict:
    """Deterministically merge per-process fault verdicts into THE
    agreed one — pure function of the verdict list, so every process
    computes the identical decision from the identical inputs with no
    second round trip. Rules: any `abort` wins (lowest-pid abort is
    the decider — a process out of recovery budget, or a lost peer's
    synthesized verdict, must never be outvoted into a retry its
    state cannot survive); otherwise the lowest-pid verdict naming a
    REAL fault site wins (a process that merely observed the fault
    flag carries site 'accord' and defers to the process that saw the
    actual error). The result gains `agreed`/`decider`/`procs`."""
    vs = sorted(verdicts, key=lambda v: int(v.get("proc", 0)))
    if not vs:
        raise ValueError("merge_verdicts: empty verdict list")
    aborts = [v for v in vs if v.get("action") == "abort"]
    if aborts:
        agreed = dict(aborts[0])
    else:
        real = [v for v in vs if v.get("site") not in (None, "accord")]
        agreed = dict(real[0] if real else vs[0])
    agreed["agreed"] = True
    agreed["decider"] = int(agreed.get("proc", 0))
    agreed["procs"] = [int(v.get("proc", 0)) for v in vs]
    return agreed


class ControlChannel:
    """Protocol base: agreement fences, collective guards, fault
    consensus and heartbeats over three backend primitives —
    `_set(key, value)` (first-write-wins), `_get(key, timeout_s)`
    (value or None) and `_beat_ages()` (seconds since each peer's last
    observed heartbeat). Single-process channels (`nproc == 1`) are
    complete no-ops on every path — the engine keeps one code path
    and the record stream stays bit-identical channel on or off."""

    def __init__(self, pid: int, nproc: int, peer_timeout: float = 60.0,
                 hb_interval: float | None = None):
        self.pid = int(pid)
        self.nproc = int(nproc)
        # 0 = wait forever (never classify a peer dead)
        self.peer_timeout = float(peer_timeout)
        if hb_interval is None:
            hb_interval = min(1.0, self.peer_timeout / 4) \
                if self.peer_timeout > 0 else 1.0
        self.hb_interval = max(0.02, float(hb_interval))
        self.epoch = 0
        self._fences: dict = {}        # tag -> fence count within epoch
        self._hb_stop = threading.Event()
        self._hb_thread = None
        if self.nproc > 1:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, name="tt-accord-hb", daemon=True)
            self._hb_thread.start()

    # ---- backend primitives ----------------------------------------
    def _set(self, key: str, value: str) -> None:
        raise NotImplementedError

    def _get(self, key: str, timeout_s: float):
        raise NotImplementedError

    def _post_beat(self, seq: int) -> None:
        raise NotImplementedError

    def _silence_s(self, proc: int) -> float:
        """Seconds since `proc`'s last observed heartbeat."""
        raise NotImplementedError

    # ---- heartbeat --------------------------------------------------
    def _hb_loop(self):
        seq = 0
        while not self._hb_stop.wait(self.hb_interval):
            seq += 1
            try:
                self._post_beat(seq)
            except Exception:
                return     # a dead backend ends the beat, silently:
                #            exactly what peers' liveness checks detect

    def close(self) -> None:
        """Stop the heartbeat. Idempotent; the channel must not be
        used afterwards (peers will classify this process lost)."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2 * self.hb_interval + 1.0)

    # ---- protocol helpers -------------------------------------------
    def _next(self, tag) -> int:
        n = self._fences.get(tag, 0) + 1
        self._fences[tag] = n
        return n

    def _fault_key(self) -> str:
        return f"e{self.epoch}/fault"

    def fault_flagged(self) -> bool:
        return self._get(self._fault_key(), 0.0) is not None

    def _await(self, key: str, peer: int, check_flag: bool = True) -> str:
        """Wait for `key` tolerant of everything but silence: returns
        its value; raises AccordPeerFault the moment any process posts
        the epoch's fault flag (unless already inside fault agreement),
        PeerLost when `peer`'s heartbeat has been quiet past
        --peer-timeout. Never waits on a barrier — re-enterable."""
        while True:
            v = self._get(key, POLL_S)
            if v is not None:
                return v
            if check_flag and self.fault_flagged():
                raise AccordPeerFault()
            if self.peer_timeout > 0:
                silence = self._silence_s(peer)
                if silence > self.peer_timeout:
                    raise PeerLost(peer, silence)

    # ---- the three agreement surfaces -------------------------------
    def agree(self, tag: str, payload):
        """Process-0-wins agreement at a named control fence: process 0
        posts its JSON-serializable `payload` and proceeds; every other
        process adopts it. The fence index is the per-tag call count
        within the epoch, so lockstep callers need no explicit ids.
        Single-process: identity."""
        if self.nproc == 1:
            return payload
        key = f"e{self.epoch}/a/{tag}/{self._next(('a', tag))}"
        if self.pid == 0:
            self._set(key, json.dumps(payload))
            return payload
        return json.loads(self._await(key, peer=0))

    def guard_collective(self) -> None:
        """Host-side rendezvous BEFORE entering a device collective:
        every process posts arrival and waits for all peers. A peer
        that faulted raises AccordPeerFault here (join its recovery
        agreement instead of hanging at its missing collective); a
        peer whose heartbeat died raises PeerLost within
        --peer-timeout. This is what converts 'infinite hang inside
        the collective' into a classified host-side fault.

        Instrumented: the whole-rendezvous wait
        lands in the `accord.fence_wait_s` histogram and each peer's
        individual wait in `accord.peer_wait_s.<p>` gauges — fence
        waits ARE the straggler diagnostic (a persistently-slow peer
        shows up as a skewed gauge long before it misses a timeout).
        Host-side and registry-only: the record stream is untouched."""
        if self.nproc == 1:
            return
        base = f"e{self.epoch}/g/{self._next('g')}"
        t0 = time.monotonic()
        self._set(f"{base}/{self.pid}", "1")
        for p in range(self.nproc):
            if p != self.pid:
                self._await(f"{base}/{p}", peer=p)
                self._observe_peer_wait(p, time.monotonic() - t0)
        self._observe_fence_wait(time.monotonic() - t0)

    # fence-wait instrumentation: the process-global registry unless
    # the channel was handed a private one (serve embeds its own).
    # Failure-swallowing — the channel must keep agreeing even when
    # the registry is frozen mid-snapshot or the obs package is
    # stripped from a deployment.
    _registry = None

    def _observe_fence_wait(self, wait_s: float) -> None:
        try:
            reg = self._registry
            if reg is None:
                from timetabling_ga_tpu_torch.obs import metrics as obs_metrics
                reg = obs_metrics.REGISTRY
            reg.histogram("accord.fence_wait_s").observe(wait_s)
        except Exception:
            pass

    def _observe_peer_wait(self, peer: int, wait_s: float) -> None:
        """Per-peer arrival gauge: wait from THIS process's fence entry
        until `peer`'s arrival was observed — the cross-peer spread of
        these gauges is the fence's straggler skew."""
        try:
            reg = self._registry
            if reg is None:
                from timetabling_ga_tpu_torch.obs import metrics as obs_metrics
                reg = obs_metrics.REGISTRY
            reg.gauge(f"accord.peer_wait_s.{peer}").set(wait_s)
        except Exception:
            pass

    def agree_on_fault(self, local_verdict: dict) -> dict:
        """Fault-recovery consensus: post this process's verdict
        ({'site', 'action': 'recover'|'abort', 'gens', ...}), collect
        every peer's (a peer lost mid-agreement contributes a
        synthesized abort verdict instead of raising — its death IS a
        vote), and return `merge_verdicts` of the full set — identical
        on every process. Bumps the epoch and resets the fence
        counters: all processes resume (or abort) in a fresh key
        namespace, so replayed fences cannot collide with their
        pre-fault writes. Single-process: the local verdict, agreed."""
        verdict = dict(local_verdict)
        verdict["proc"] = self.pid
        if self.nproc == 1:
            return merge_verdicts([verdict])
        try:
            self._set(self._fault_key(), "1")
        except Exception:
            pass       # both-see-fault: a peer flagged first — fine
        self._set(f"e{self.epoch}/v/{self.pid}", json.dumps(verdict))
        verdicts = [verdict]
        for p in range(self.nproc):
            if p == self.pid:
                continue
            try:
                verdicts.append(json.loads(
                    self._await(f"e{self.epoch}/v/{p}", peer=p,
                                check_flag=False)))
            except PeerLost as e:
                verdicts.append({"proc": p, "site": "accord",
                                 "action": "abort", "gens": -1,
                                 "lost": True,
                                 "silence_s": round(e.silence_s, 3)})
        agreed = merge_verdicts(verdicts)
        self.epoch += 1
        self._fences.clear()
        return agreed


class _LoopbackStore:
    """The shared in-process backend: one dict + condition variable and
    per-process heartbeat timestamps."""

    def __init__(self):
        self.cond = threading.Condition()
        self.data: dict = {}
        self.beats: dict = {}


class LoopbackChannel(ControlChannel):
    """In-process backend: N channel views over one `_LoopbackStore`
    run the full protocol (including real heartbeat threads) on one
    CPU process — the tier-1 test double for the distributed backend,
    and the single-process fast path (`solo()`)."""

    def __init__(self, pid: int, nproc: int,
                 store: _LoopbackStore | None = None,
                 peer_timeout: float = 60.0,
                 hb_interval: float | None = None):
        self._store = store if store is not None else _LoopbackStore()
        with self._store.cond:
            self._store.beats[pid] = time.monotonic()
        super().__init__(pid, nproc, peer_timeout, hb_interval)

    @classmethod
    def group(cls, n: int, peer_timeout: float = 60.0,
              hb_interval: float | None = None) -> list:
        """N views over one shared store — 'n processes' in one."""
        store = _LoopbackStore()
        return [cls(p, n, store, peer_timeout, hb_interval)
                for p in range(n)]

    @classmethod
    def solo(cls) -> "LoopbackChannel":
        """The single-process channel: every protocol surface is a
        no-op/identity and no heartbeat thread runs."""
        return cls(0, 1)

    def kill(self) -> None:
        """Simulate this view's process dying: its heartbeat stops,
        so peers' liveness checks see growing silence. (A dead process
        also stops writing keys — tests simply stop calling.)"""
        self._hb_stop.set()

    def _set(self, key, value):
        with self._store.cond:
            self._store.data.setdefault(key, value)
            self._store.cond.notify_all()

    def _get(self, key, timeout_s):
        with self._store.cond:
            if timeout_s > 0:
                self._store.cond.wait_for(
                    lambda: key in self._store.data, timeout_s)
            return self._store.data.get(key)

    def _post_beat(self, seq):
        with self._store.cond:
            self._store.beats[self.pid] = time.monotonic()

    def _silence_s(self, proc):
        with self._store.cond:
            t = self._store.beats.get(proc)
        return 0.0 if t is None else max(0.0, time.monotonic() - t)


class DistributedChannel(ControlChannel):
    """The real multi-process backend over a torch.distributed store
    (`TCPStore`, or any store with `compare_set`, `check`, `get` and
    `set`). Protocol keys are first-write-wins through `compare_set`;
    each process's heartbeat is one key it overwrites with a rising
    sequence number, and liveness is how long since an observer last
    saw that number change."""

    # the seconds between key polls inside a timed `_get`
    _POLL_STEP_S = 0.01

    def __init__(self, store, pid: int, nproc: int,
                 peer_timeout: float = 60.0,
                 hb_interval: float | None = None,
                 namespace: str = "tt-accord/0"):
        self._store = store
        self._ns = namespace
        # per-peer [last seen seq, monotonic time it was seen]
        self._hb_seen = {p: [None, time.monotonic()]
                         for p in range(nproc) if p != pid}
        super().__init__(pid, nproc, peer_timeout, hb_interval)

    def _k(self, key: str) -> str:
        return f"{self._ns}/{key}"

    def _set(self, key, value):
        # first-write-wins: the empty expected value sets only a key that
        # does not exist yet
        self._store.compare_set(self._k(key), "", value)

    def _get(self, key, timeout_s):
        k = self._k(key)
        deadline = time.monotonic() + max(0.0, timeout_s)
        try:
            while not self._store.check([k]):
                if time.monotonic() >= deadline:
                    return None
                time.sleep(self._POLL_STEP_S)
            return self._store.get(k).decode()
        except Exception:
            return None        # an unreachable store: the protocol loops
            #                    re-check the flag and liveness

    def _post_beat(self, seq):
        self._store.set(self._k(f"hb/{self.pid}"), str(seq))

    def _silence_s(self, proc):
        ent = self._hb_seen[proc]
        seq = self._get(f"hb/{proc}", 0.0)
        if seq is not None and seq != ent[0]:
            ent[0] = seq
            ent[1] = time.monotonic()
        return max(0.0, time.monotonic() - ent[1])


# ---- per-process channel registry -----------------------------------
# The active channel (None = accord off). dispatch_core.fetch and the
# island mesh's collectives guard through `active()`; engine.run
# installs at open and uninstalls in its finally. Per-run sequence
# numbers keep repeated runs in one process (against one store) from
# colliding in its key space — every process opens the channel once per
# run, in lockstep, so the counters agree.
_ACTIVE: ControlChannel | None = None
_RUN_SEQ = 0


def install(ch: ControlChannel | None):
    global _ACTIVE
    _ACTIVE = ch
    return ch


def active() -> ControlChannel | None:
    return _ACTIVE


def open_channel(accord: bool = True, peer_timeout: float = 60.0):
    """Build the channel for this process's topology: None when accord
    is disabled (--no-accord), a solo loopback single-process (all
    paths no-op), the store backend when a process group is live
    (parallel/comm.py). Multi-process without a store degrades to None
    rather than failing the run, as JAX's does without a coordination
    client."""
    if not accord:
        return None
    from timetabling_ga_tpu_torch.parallel import comm
    group = comm.active()
    if group.world == 1:
        return LoopbackChannel.solo()
    if group.store is None:
        return None
    global _RUN_SEQ
    _RUN_SEQ += 1
    return DistributedChannel(
        group.store, group.rank, group.world, peer_timeout=peer_timeout,
        namespace=f"tt-accord/{_RUN_SEQ}")
