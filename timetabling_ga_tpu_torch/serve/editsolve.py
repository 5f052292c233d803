"""Incremental re-solve: edit specs, the population transplant and the
anchored objective's host side (copy of timetabling_ga_tpu/serve/
editsolve.py, under the same names and with the same messages).

  edit spec     {"edit": {"base": {"tim"|"problem": ...},
                          "ops": [...] | "edited": {"tim"|"problem": ...},
                          "w_anchor": W, "snapshot": <base wire>,
                          "base_id": ...}}
                ops, applied in order, events indexed in the problem as
                it stands at each step:
                  {"op": "add_event", "students": [s...],
                   "features": [f...]}            append one event
                  {"op": "remove_event", "event": e}
                  {"op": "set_attendance", "event": e, "student": s,
                   "value": 0|1}
                  {"op": "set_event_features", "event": e,
                   "features": [f...]}
                  {"op": "set_room_size", "room": r, "size": n}
                  {"op": "set_room_features", "room": r,
                   "features": [f...]}
                "edited" ships the whole edited instance instead, and
                `diff_problems` matches its events by position.

  warm vs cold  warm iff the edited instance pads into the base wire's
                bucket; a cross-bucket edit, a missing or undecodable
                base wire or a population mismatch demotes the job to a
                cold solve of the edited instance (EditDemoted, counted
                by the scheduler as serve.jobs_edit_demoted).

  transplant    carried events keep their slot and room genes from the
                base wire, new events take seeded random slots (numpy's
                default_rng(seed), room 0), removed events drop; the
                population is re-scored under the edited problem
                (fitness.batch_penalty: K2 on the card), sorted by
                fitness.lex_order and packed as the edit job's own wire
                with its cursors at zero.

  anchor        the base wire's lex-best row becomes the edited
                problem's anchor_slots, with weight w_anchor on carried
                events and 0 on new ones: K2, K6 and K8 charge w_anchor
                a carried event moved off its published slot. w_anchor 0
                leaves the objective as it was.

Everything is host numpy but the transplant's one re-scoring, which runs
at admission, never inside a dispatch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from timetabling_ga_tpu_torch.problem import (
    Problem, derive, load_tim, problem_from_json)
from timetabling_ga_tpu_torch.serve import snapshot as snapshot_mod

# the anchor weight of an edit spec without `w_anchor`: one soft point a
# moved carried event
DEFAULT_ANCHOR_W = 1

_OPS = ("add_event", "remove_event", "set_attendance",
        "set_event_features", "set_room_size", "set_room_features")


class EditError(ValueError):
    """The edit spec is malformed or does not apply to its base problem:
    the submit is rejected."""


class EditDemoted(RuntimeError):
    """A valid edit cannot warm-start: the job runs as a cold solve of
    the edited instance."""


def parse_edit_spec(edit) -> dict:
    """Check the edit object's structure (not its applicability, which
    needs the base problem); returns it unchanged."""
    if not isinstance(edit, dict):
        raise EditError(f"edit spec is {type(edit).__name__}, "
                        f"not an object")
    if "base" not in edit:
        raise EditError("edit spec needs a 'base' (job id or inline "
                        "problem object)")
    has_ops = "ops" in edit
    has_edited = "edited" in edit
    if has_ops == has_edited:
        raise EditError("edit spec needs exactly one of 'ops' or "
                        "'edited'")
    if has_ops:
        ops = edit["ops"]
        if not isinstance(ops, (list, tuple)):
            raise EditError("edit 'ops' must be a list")
        for i, op in enumerate(ops):
            if not isinstance(op, dict) or op.get("op") not in _OPS:
                raise EditError(
                    f"edit op {i} is not one of {_OPS}: {op!r}")
    w = edit.get("w_anchor", DEFAULT_ANCHOR_W)
    try:
        if int(w) < 0:
            raise ValueError
    except (TypeError, ValueError):
        raise EditError(f"edit w_anchor must be a non-negative "
                        f"integer, got {w!r}") from None
    return edit


def load_base_problem(base, n_days=None, slots_per_day=None) -> Problem:
    """The edit's base problem from its inline form ({"tim": ...} or
    {"problem": ...}); a job-id base is refused (only a gateway resolves
    ids)."""
    if not isinstance(base, dict):
        raise EditError(
            f"edit base must be resolved to an inline problem object "
            f"before it reaches the solver, got {type(base).__name__} "
            f"(unresolved job-id bases are a gateway-only form)")
    kw = {}
    days = base.get("n_days", n_days)
    spd = base.get("slots_per_day", slots_per_day)
    if days is not None:
        kw["n_days"] = int(days)
    if spd is not None:
        kw["slots_per_day"] = int(spd)
    if "problem" in base:
        return problem_from_json(base["problem"])
    if "tim" in base:
        return load_tim(str(base["tim"]), **kw)
    raise EditError("edit base object needs a 'tim' text or a "
                    "'problem' object")


def _check_index(name: str, idx, bound: int) -> int:
    try:
        i = int(idx)
    except (TypeError, ValueError):
        raise EditError(f"edit op {name} index {idx!r} is not an "
                        f"int") from None
    if not 0 <= i < bound:
        raise EditError(f"edit op {name} index {i} out of range "
                        f"[0, {bound})")
    return i


def _feature_row(features, n_features: int) -> np.ndarray:
    row = np.zeros((n_features,), np.int8)
    for f in features or ():
        row[_check_index("feature", f, n_features)] = 1
    return row


def apply_ops(base: Problem, ops) -> tuple:
    """Apply an op list to `base`: (edited, event_map), event_map[e] the
    base event edited event e carries, or -1 for a new one."""
    attends = np.array(base.attends, dtype=np.int8)        # (S, E)
    event_features = np.array(base.event_features, np.int8)
    room_features = np.array(base.room_features, np.int8)
    room_size = np.array(base.room_size, np.int32)
    event_map = list(range(base.n_events))
    S, F = base.n_students, base.n_features

    for op in ops:
        kind = op.get("op")
        E = attends.shape[1]
        if kind == "add_event":
            col = np.zeros((S, 1), np.int8)
            for s in op.get("students") or ():
                col[_check_index("student", s, S), 0] = 1
            attends = np.concatenate([attends, col], axis=1)
            event_features = np.concatenate(
                [event_features,
                 _feature_row(op.get("features"), F)[None, :]], axis=0)
            event_map.append(-1)
        elif kind == "remove_event":
            e = _check_index("event", op.get("event"), E)
            attends = np.delete(attends, e, axis=1)
            event_features = np.delete(event_features, e, axis=0)
            del event_map[e]
        elif kind == "set_attendance":
            e = _check_index("event", op.get("event"), E)
            s = _check_index("student", op.get("student"), S)
            attends[s, e] = 1 if op.get("value") else 0
        elif kind == "set_event_features":
            e = _check_index("event", op.get("event"), E)
            event_features[e] = _feature_row(op.get("features"), F)
        elif kind == "set_room_size":
            r = _check_index("room", op.get("room"), base.n_rooms)
            size = int(op.get("size", 0))
            if size < 0:
                raise EditError(f"edit op set_room_size: negative "
                                f"size {size}")
            room_size[r] = size
        elif kind == "set_room_features":
            r = _check_index("room", op.get("room"), base.n_rooms)
            room_features[r] = _feature_row(op.get("features"), F)
        else:
            raise EditError(f"unknown edit op {kind!r}")

    if attends.shape[1] == 0:
        raise EditError("edit removes every event")
    edited = derive(attends.shape[1], base.n_rooms, F, S, room_size,
                    attends, room_features, event_features,
                    n_days=base.n_days, slots_per_day=base.slots_per_day)
    return edited, np.asarray(event_map, np.int32)


def diff_problems(base: Problem, edited: Problem) -> tuple:
    """The positional differ of a whole-instance edit: the common prefix
    of events carries one to one, extra edited events are adds, missing
    base events removes. Returns (ops, event_map) in apply_ops' terms."""
    if (base.n_students, base.n_features, base.n_rooms) != (
            edited.n_students, edited.n_features, edited.n_rooms):
        raise EditError(
            f"diff needs matching (students, features, rooms) axes: "
            f"base ({base.n_students}, {base.n_features}, "
            f"{base.n_rooms}) != edited ({edited.n_students}, "
            f"{edited.n_features}, {edited.n_rooms})")
    if (base.n_days, base.slots_per_day) != (edited.n_days,
                                             edited.slots_per_day):
        raise EditError("diff needs matching slot grids")
    Eb, Ee = base.n_events, edited.n_events
    common = min(Eb, Ee)
    ops: list = []
    for e in range(common):
        changed = np.flatnonzero(base.attends[:, e]
                                 != edited.attends[:, e])
        for s in changed:
            ops.append({"op": "set_attendance", "event": e,
                        "student": int(s),
                        "value": int(edited.attends[s, e])})
        if np.any(base.event_features[e] != edited.event_features[e]):
            ops.append({"op": "set_event_features", "event": e,
                        "features": np.flatnonzero(
                            edited.event_features[e]).tolist()})
    for r in range(base.n_rooms):
        if int(base.room_size[r]) != int(edited.room_size[r]):
            ops.append({"op": "set_room_size", "room": r,
                        "size": int(edited.room_size[r])})
        if np.any(base.room_features[r] != edited.room_features[r]):
            ops.append({"op": "set_room_features", "room": r,
                        "features": np.flatnonzero(
                            edited.room_features[r]).tolist()})
    for e in range(common, Ee):                    # trailing adds
        ops.append({"op": "add_event",
                    "students": np.flatnonzero(
                        edited.attends[:, e]).tolist(),
                    "features": np.flatnonzero(
                        edited.event_features[e]).tolist()})
    for e in range(Eb - 1, common - 1, -1):        # trailing removes
        ops.append({"op": "remove_event", "event": e})
    event_map = np.concatenate(
        [np.arange(common, dtype=np.int32),
         np.full((Ee - common,), -1, np.int32)])
    return ops, event_map


def resolve_edit(edit, n_days=None, slots_per_day=None):
    """Edit spec -> (base, edited, event_map, ops): the spec checked, the
    base loaded, the ops applied or the edited instance diffed."""
    parse_edit_spec(edit)
    base = load_base_problem(edit["base"], n_days=n_days,
                             slots_per_day=slots_per_day)
    if "ops" in edit:
        ops = list(edit["ops"])
        edited, event_map = apply_ops(base, ops)
    else:
        edited_p = load_base_problem(edit["edited"], n_days=base.n_days,
                                     slots_per_day=base.slots_per_day)
        ops, event_map = diff_problems(base, edited_p)
        edited = edited_p
    return base, edited, event_map, ops


def anchor_from_wire(wire) -> Optional[np.ndarray]:
    """The base job's published timetable: the wire population's
    lex-best (penalty, scv) row of slots, (E_padded,) int32, or None
    when the wire is missing or undecodable."""
    if wire is None:
        return None
    try:
        state, _meta = snapshot_mod.unpack_state(wire)
    except Exception:
        return None
    best = int(np.lexsort((np.asarray(state.scv),
                           np.asarray(state.penalty)))[0])
    return np.asarray(state.slots[best], np.int32)


def attach_anchor(edited: Problem, event_map: np.ndarray,
                  base_anchor: Optional[np.ndarray],
                  w_anchor: int) -> Problem:
    """The edited problem with its anchor columns: the base solution's
    slot and weight w_anchor on each carried event, 0 on new ones;
    unanchored when there is no base solution."""
    if base_anchor is None or w_anchor is None:
        return edited
    E = edited.n_events
    anchor_slots = np.zeros((E,), np.int32)
    anchor_w = np.zeros((E,), np.int32)
    carried = event_map >= 0
    # the base's live events are its padded prefix: their indices index
    # base_anchor directly
    anchor_slots[carried] = base_anchor[event_map[carried]]
    anchor_w[carried] = int(w_anchor)
    return dataclasses.replace(edited, anchor_slots=anchor_slots,
                               anchor_w=anchor_w)


def classify(edited_padded_key: tuple, wire) -> bool:
    """Warm iff the edited instance's bucket is the base wire's."""
    if wire is None:
        return False
    return [int(d) for d in edited_padded_key] == [
        int(d) for d in wire.get("bucket", ())]


def transplant(edited_padded: Problem, event_map: np.ndarray, wire, *,
               bucket, pop_size: int, seed: int, pa=None) -> dict:
    """The edit job's warm-start wire (see the module docstring), with
    the edit job's fingerprint, gens_done and chunks 0 and the fresh
    job's floors. `pa` is the edited padded instance's ProblemArrays on
    the device to re-score on (the CPU's when None). Raises EditDemoted
    on any obstacle to a warm start."""
    if wire is None:
        raise EditDemoted("no base snapshot to transplant from")
    if not classify(bucket, wire):
        raise EditDemoted(
            f"cross-bucket edit: edited bucket {list(bucket)} != base "
            f"snapshot bucket {list(wire.get('bucket', ()))}")
    try:
        base_state, _meta = snapshot_mod.unpack_state(wire)
    except Exception as e:
        raise EditDemoted(f"base snapshot undecodable: {e}") from e
    b_slots = np.asarray(base_state.slots)
    b_rooms = np.asarray(base_state.rooms)
    if b_slots.shape[0] != pop_size:
        raise EditDemoted(
            f"base snapshot population {b_slots.shape[0]} != "
            f"configured pop_size {pop_size}")

    Ep = edited_padded.n_events
    live = (edited_padded.n_live_events
            if edited_padded.n_live_events is not None else Ep)
    T = edited_padded.n_slots
    if np.any(event_map[:live] >= b_slots.shape[1]):
        raise EditDemoted("event map exceeds base genotype width")
    rng = np.random.default_rng(seed)
    slots = np.zeros((pop_size, Ep), np.int32)
    rooms = np.zeros((pop_size, Ep), np.int32)
    carried = np.flatnonzero(event_map[:live] >= 0)
    fresh = np.flatnonzero(event_map[:live] < 0)
    slots[:, carried] = b_slots[:, event_map[carried]]
    rooms[:, carried] = b_rooms[:, event_map[carried]]
    if fresh.size:
        # room 0 is a placeholder the search re-rooms on first touch
        slots[:, fresh] = rng.integers(
            0, T, size=(pop_size, fresh.size), dtype=np.int32)

    # the base scores are stale under the edited problem: one re-scoring
    import torch
    from timetabling_ga_tpu_torch.ops import fitness, ga
    if pa is None:
        pa = edited_padded.device_arrays()
    pen_d, hcv_d, scv_d = fitness.batch_penalty(
        pa, torch.from_numpy(slots).to(pa.device),
        torch.from_numpy(rooms).to(pa.device))
    order = fitness.lex_order(pen_d, scv_d).cpu().numpy()
    pen, hcv, scv = (x.cpu().numpy() for x in (pen_d, hcv_d, scv_d))
    state = ga.PopState(slots[order], rooms[order], pen[order], hcv[order],
                        scv[order])
    fresh_floor = 2 ** 31 - 1
    return snapshot_mod.pack_state(
        state, bucket=bucket, pop_size=pop_size, seed=seed,
        gens_done=0, chunks=0, emitted=fresh_floor, best=fresh_floor)


def edit_distance(final_slots, anchor_slots, event_map) -> Optional[int]:
    """Carried live events whose final slot differs from the base
    solution's (from the event map, not anchor_w: a w_anchor 0 edit
    still reports its distance); None without an anchor."""
    if anchor_slots is None or event_map is None:
        return None
    final_slots = np.asarray(final_slots)
    live = min(final_slots.shape[-1], len(event_map))
    carried = np.asarray(event_map[:live]) >= 0
    return int(np.sum((final_slots[..., :live][..., carried]
                       != np.asarray(anchor_slots)[:live][carried])))
