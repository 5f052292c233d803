"""The per-job snapshot wire format: resume, don't replay (copy of
timetabling_ga_tpu/serve/snapshot.py, under the same names and with the
same messages, so a wire packed by either package loads in the other).

A parked serve job is a host (numpy) PopState (serve/scheduler.py parks
through dispatch_core.fetch_state). The wire carries one job's park
fence across a process boundary, JSON-safe:

    {"v": 1,
     "fingerprint": "j1|b512x16x16x256x5x9|p16|s42",
     "bucket": [512, 16, 16, 256, 5, 9],
     "gens_done": 150, "chunks": 6,            progress + generator cursor
     "emitted": 873, "best": 873,              logEntry floor
     "crc": 2839463521, "bytes": 51712,        integrity of the npz
     "npz": "<base64 of np.savez(PopState fields)>",
     "usage": {"gens": 150, ...}}              the job's meter cursor

The fingerprint pins what must agree for the resumed lane to continue
the uninterrupted stream: the wire version, the bucket key, the
population a lane and the job's seed (its generators are seeded from
(seed, chunk): islands.lane_generator). A wire of another bucket, pop
size or seed refuses to load (SnapshotMismatch, naming both
fingerprints); damaged bytes raise SnapshotCorrupt naming the failing
field. `np.savez` stamps the time into its zip: compare two wires by
their unpacked arrays and meta, never by their `npz` strings.

`usage` is the job's cumulative meter at the fence (obs/usage.py,
rounded), absent when metering is off or the meter is empty; a job
resumed from a wire of either package continues it
(serve/scheduler.py).
`verify_wire` needs only the standard library; nothing here touches the
device.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import os
import zlib
from typing import Optional

WIRE_VERSION = 1

# bound on the record prefix a ship unit mirrors: beyond it the oldest
# records drop and the unit is marked truncated (resume still works,
# stream identity cannot be claimed)
SHIP_RECORDS_CAP = int(os.environ.get("TT_SNAPSHOT_RECORDS_CAP", "4096"))

# the PopState fields, in serialization order (a new field is a wire
# version bump)
_FIELDS = ("slots", "rooms", "penalty", "hcv", "scv")

# wire keys every snapshot carries
_REQUIRED = ("v", "fingerprint", "bucket", "gens_done", "chunks",
             "emitted", "best", "crc", "bytes", "npz")


class SnapshotCorrupt(RuntimeError):
    """The wire is damaged (truncated base64, CRC mismatch, torn npz,
    missing fields); the message names the failing field."""


class SnapshotMismatch(ValueError):
    """The wire is intact but belongs to another (bucket, pop size,
    seed, wire version): resuming from it would not continue the
    uninterrupted stream. The message names both fingerprints."""


def wire_fingerprint(bucket, pop_size: int, seed: int) -> str:
    """The compatibility stamp: wire version, bucket key, population a
    lane and the job's seed."""
    dims = "x".join(str(int(d)) for d in bucket)
    return f"j{WIRE_VERSION}|b{dims}|p{int(pop_size)}|s{int(seed)}"


def pack_state(state, *, bucket, pop_size: int, seed: int,
               gens_done: int, chunks: int, emitted: int,
               best: int, usage: Optional[dict] = None) -> dict:
    """One job's host PopState and progress cursor as a wire object;
    `usage` (the job's cumulative meter) rides as the cursor when
    non-empty."""
    import numpy as np
    buf = io.BytesIO()
    np.savez(buf, **{f: np.asarray(getattr(state, f)) for f in _FIELDS})
    raw = buf.getvalue()
    wire = {"v": WIRE_VERSION,
            "fingerprint": wire_fingerprint(bucket, pop_size, seed),
            "bucket": [int(d) for d in bucket],
            "gens_done": int(gens_done), "chunks": int(chunks),
            "emitted": int(emitted), "best": int(best),
            "crc": zlib.crc32(raw) & 0xFFFFFFFF, "bytes": len(raw),
            "npz": base64.b64encode(raw).decode("ascii")}
    if usage:
        from timetabling_ga_tpu_torch.obs import usage as usage_mod
        wire["usage"] = usage_mod.rounded(usage)
    return wire


def verify_wire(wire, expect_fingerprint: Optional[str] = None) -> bytes:
    """Validate a wire without loading it; returns the raw npz bytes.
    Raises SnapshotCorrupt on damage (naming the field) and
    SnapshotMismatch when `expect_fingerprint` is given and differs."""
    if not isinstance(wire, dict):
        raise SnapshotCorrupt(
            f"snapshot wire is {type(wire).__name__}, not an object")
    for k in _REQUIRED:
        if k not in wire:
            raise SnapshotCorrupt(f"snapshot wire missing field {k!r}")
    if int(wire["v"]) != WIRE_VERSION:
        raise SnapshotMismatch(
            f"snapshot wire version {wire['v']!r} != {WIRE_VERSION} "
            f"(fingerprint {str(wire['fingerprint'])!r})")
    if expect_fingerprint is not None \
            and str(wire["fingerprint"]) != expect_fingerprint:
        raise SnapshotMismatch(
            f"snapshot fingerprint mismatch: "
            f"{str(wire['fingerprint'])!r} != {expect_fingerprint!r} "
            f"— different bucket, pop size, seed, or wire version")
    try:
        raw = base64.b64decode(str(wire["npz"]), validate=True)
    except (ValueError, TypeError) as e:
        raise SnapshotCorrupt(
            f"snapshot field 'npz' is not valid base64: {e}") from None
    if len(raw) != int(wire["bytes"]):
        raise SnapshotCorrupt(
            f"snapshot field 'npz' truncated: {len(raw)} bytes != "
            f"declared {int(wire['bytes'])}")
    crc = zlib.crc32(raw) & 0xFFFFFFFF
    if crc != int(wire["crc"]) & 0xFFFFFFFF:
        raise SnapshotCorrupt(
            f"snapshot field 'npz' CRC mismatch: {crc} != declared "
            f"{int(wire['crc'])}")
    return raw


def unpack_state(wire, expect_fingerprint: Optional[str] = None):
    """verify_wire, then the arrays: (PopState of numpy arrays, meta)
    with meta {'gens_done', 'chunks', 'emitted', 'best'}. A torn npz
    raises SnapshotCorrupt."""
    import numpy as np

    from timetabling_ga_tpu_torch.ops import ga
    from timetabling_ga_tpu_torch.runtime.checkpoint import CORRUPT_ERRORS
    raw = verify_wire(wire, expect_fingerprint)
    try:
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            state = ga.PopState(*(np.array(z[f]) for f in _FIELDS))
    except CORRUPT_ERRORS as e:
        raise SnapshotCorrupt(
            f"snapshot npz payload unreadable: {e!r}") from e
    meta = {k: int(wire[k])
            for k in ("gens_done", "chunks", "emitted", "best")}
    return state, meta


@dataclasses.dataclass
class ShipUnit:
    """One job's shippable park-fence unit: the host state and the
    record prefix emitted up to that fence, built on the drive loop and
    replaced whole at every park (serve/scheduler.py), so a handler
    thread reading `job.ship` sees one fence's pair or the next's.
    `pack` makes its wire once, on the handler thread that serves
    `?snapshot=1` (fleet/replicas.py): the state is host memory, so the
    pack makes no device call."""

    state: object               # host PopState at the fence
    bucket: tuple
    pop_size: int
    seed: int
    gens_done: int
    chunks: int
    emitted: int
    best: int
    records: list               # the job's records through this fence
    truncated: bool = False     # records hit SHIP_RECORDS_CAP
    usage: Optional[dict] = None  # the job's meter at this fence: the
    #                             wire's usage cursor
    wire: Optional[dict] = None  # pack's memo (handler threads may race
    #                             it: both compute the same wire)
    records_bytes: Optional[int] = None  # the serialized size of
    #                             `records`, measured once by the first
    #                             handler that serves the unit: a gateway
    #                             budgets its snapshot cache on it
    served: bool = False        # fetched at least once: the preempt
    #                             drain's "shipped" signal

    def pack(self) -> dict:
        if self.wire is None:
            self.wire = pack_state(
                self.state, bucket=self.bucket, pop_size=self.pop_size,
                seed=self.seed, gens_done=self.gens_done,
                chunks=self.chunks, emitted=self.emitted, best=self.best,
                usage=self.usage)
        return self.wire
