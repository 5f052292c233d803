"""Checkpoint / resume: population snapshots as npz (port of
timetabling_ga_tpu/runtime/checkpoint.py).

The file format is the JAX package's, so a run moves between the two
packages in both directions: int32 `slots`, `rooms`, `penalty`, `hcv`,
`scv`; a `(2,)` uint32 `key`; the `generation` counter; the config
`fingerprint` string; the per-island `best_seen` floor and the `seed`
(int64). `config_fingerprint` builds the same string as JAX's for the
same instance, flags and island count.

The RNG state is not portable between the frameworks. The port writes a
JAX-wrappable `key` derived from (seed, trial, generation) — any two
uint32 words are a valid threefry key, which is what a JAX resume reads —
and its island generators' states as the extra arrays `torch_generators`
(one uint8 row an island) and `torch_generator_device` (`cpu` or
`cuda`); JAX's loader reads arrays by name and ignores them. A port
resume restores the generators from them when they were written on the
same device type, and reseeds them otherwise (runtime/engine.py).

A run split over an island mesh or over processes saves the whole
population and every island's generator state (gathered; process 0
writes), so a file resumes on any layout — 2 processes to 1, 1 to 2, a
JAX file onto a 2-shard mesh — each shard taking its islands' rows
(dispatch_core.reshard_state) and, from a port file of the same device
type, its islands' generator states; a JAX file reseeds them from each
island's global index.

`save` is atomic and durable: temp file, fsync, rotation of the previous
file to `prev_path(path)`, rename, directory fsync. `load` falls back to
the rotated file when the newest one is damaged. The fault site `ckpt`
fires after the durable rename (JAX checkpoint.py:142): `ckpt:N:truncate`
tears the file just written, as a torn disk would, and the next load
falls back to the rotated one.
"""

from __future__ import annotations

import os
import sys
import tempfile
import zipfile
import zlib
from typing import NamedTuple, Optional

import numpy as np

from timetabling_ga_tpu_torch.ops import ga
from timetabling_ga_tpu_torch.runtime import faults

FORMAT_VERSION = 2


class FingerprintMismatch(ValueError):
    """The checkpoint is intact but belongs to a different instance,
    GA config or island layout."""


class CheckpointCorrupt(RuntimeError):
    """The checkpoint file exists but cannot be read, and no previous
    file could serve in its place; names both paths."""


class Loaded(NamedTuple):
    """What `load` restores: the host (numpy) population, the key words,
    the generation counter, the per-island best floor and the seed
    (None in files that lack them), and the island generators' states
    with the device type they were written on (None in a JAX file)."""
    state: ga.PopState
    key: np.ndarray
    generation: int
    best_seen: Optional[list]
    seed: Optional[int]
    generators: Optional[np.ndarray]
    generator_device: Optional[str]


def prev_path(path: str) -> str:
    """The rotation target `save` moves the previous checkpoint to."""
    return path + ".prev"


def config_fingerprint(problem, cfg, n_islands: int) -> str:
    """Compatibility stamp: instance shape, breeding params, island
    count. The seed is not part of it (it is metadata; the engine
    refuses only an explicit conflicting -s)."""
    return (f"v{FORMAT_VERSION}"
            f"|E{problem.n_events}R{problem.n_rooms}S{problem.n_students}"
            f"T{problem.n_days * problem.slots_per_day}"
            f"|P{cfg.pop_size}k{cfg.tournament_k}"
            f"x{cfg.p_crossover}m{cfg.p_mutation}"
            f"|ls{cfg.ls_steps}c{cfg.ls_candidates}o{cfg.ls_mode}"
            f"w{cfg.ls_sweeps}b{cfg.ls_swap_block}"
            f"e{cfg.ls_block_events}y{cfg.ls_sideways}"
            f"g{int(cfg.ls_converge)}i{cfg.init_sweeps}"
            f"r{cfg.rooms_mode}"
            f"|I{n_islands}")


def key_words(seed: int, trial: int, generation: int) -> np.ndarray:
    """The `(2,)` uint32 threefry key a port checkpoint carries for a
    JAX resume, drawn from (seed, trial, generation)."""
    return np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(seed) >> 32 & 0xFFFFFFFF, trial,
         generation]).generate_state(2, dtype=np.uint32)


def save(path: str, state: ga.PopState, key, generation: int,
         fingerprint: str, best_seen=None, seed: int = None,
         generators=None, generator_device: str = None) -> None:
    """Atomic durable snapshot: write temp, fsync, rotate the previous
    file to `prev_path(path)`, rename, fsync the directory. `state` holds
    numpy arrays (or anything np.asarray takes); `generators` is an
    (L, n) uint8 array of torch.Generator states written on
    `generator_device`."""
    arrays = {
        "slots": np.asarray(state.slots, np.int32),
        "rooms": np.asarray(state.rooms, np.int32),
        "penalty": np.asarray(state.penalty, np.int32),
        "hcv": np.asarray(state.hcv, np.int32),
        "scv": np.asarray(state.scv, np.int32),
        "key": np.asarray(key, np.uint32),
        "generation": np.asarray(generation),
        "fingerprint": np.asarray(fingerprint),
    }
    if best_seen is not None:
        arrays["best_seen"] = np.asarray(best_seen, dtype=np.int64)
    if seed is not None:
        arrays["seed"] = np.asarray(seed, dtype=np.int64)
    if generators is not None:
        arrays["torch_generators"] = np.asarray(generators, np.uint8)
        arrays["torch_generator_device"] = np.asarray(generator_device)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        if os.path.exists(path):
            os.replace(path, prev_path(path))
        os.replace(tmp, path)
        dirfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    faults.maybe_fail("ckpt", path=path)


# np.load failures that mean the file on disk is damaged (truncated zip,
# bad magic, member cut short, missing arrays); not OSError, so that a
# transient read error on an intact newest file propagates (serve/
# snapshot.py classifies a torn npz of a job's wire by the same errors)
CORRUPT_ERRORS = (zipfile.BadZipFile, zlib.error, ValueError, EOFError,
                  KeyError)


def _load_one(path: str, fingerprint: str) -> Loaded:
    with np.load(path, allow_pickle=False) as z:
        found = str(z["fingerprint"])
        if found != fingerprint:
            raise FingerprintMismatch(
                f"checkpoint fingerprint mismatch: {found!r} != "
                f"{fingerprint!r} — different instance, GA config, "
                f"island count, or seed")
        state = ga.PopState(
            slots=np.array(z["slots"]), rooms=np.array(z["rooms"]),
            penalty=np.array(z["penalty"]), hcv=np.array(z["hcv"]),
            scv=np.array(z["scv"]))
        gens = dev = None
        if "torch_generators" in z:
            gens = np.array(z["torch_generators"])
            dev = str(z["torch_generator_device"])
        return Loaded(
            state, np.array(z["key"]), int(z["generation"]),
            np.array(z["best_seen"]).tolist() if "best_seen" in z else None,
            int(z["seed"]) if "seed" in z else None, gens, dev)


def load(path: str, fingerprint: str) -> Loaded:
    """Restore a checkpoint; raises FingerprintMismatch (a ValueError)
    on a config mismatch. A damaged `path`, or a missing one beside a
    rotated file, falls back to `prev_path(path)` with a warning; when
    neither is readable the error is a CheckpointCorrupt naming both."""
    prev = prev_path(path)
    try:
        return _load_one(path, fingerprint)
    except FingerprintMismatch:
        raise
    except FileNotFoundError:
        if not os.path.exists(prev):
            raise
        first_err: BaseException = FileNotFoundError(path)
    except CORRUPT_ERRORS as e:
        first_err = e
    if not os.path.exists(prev):
        raise CheckpointCorrupt(
            f"checkpoint {path!r} is unreadable ({first_err!r}) and no "
            f"previous checkpoint {prev!r} exists") from first_err
    try:
        result = _load_one(prev, fingerprint)
    except (FingerprintMismatch, FileNotFoundError,
            *CORRUPT_ERRORS) as e2:
        raise CheckpointCorrupt(
            f"checkpoint {path!r} is unreadable ({first_err!r}) and the "
            f"previous checkpoint {prev!r} failed too ({e2!r})"
        ) from first_err
    print(f"warning: checkpoint {path!r} is unreadable "
          f"({str(first_err)[:120]}); resuming from the previous "
          f"checkpoint {prev!r}", file=sys.stderr)
    return result
