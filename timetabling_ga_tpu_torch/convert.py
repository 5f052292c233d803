"""State carried across from the JAX package, as numpy arrays.

The tests call the JAX functions and the port's on identical inputs:
they take the JAX `ProblemArrays` / `PopState` / `LSState` fields,
`np.asarray` them on the JAX side, and hand the numpy arrays (or any
object exposing them as attributes) to these functions, which place
them on a torch device with the port's dtypes. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from timetabling_ga_tpu_torch.ops.delta import LSState
from timetabling_ga_tpu_torch.ops.ga import PopState
from timetabling_ga_tpu_torch.problem import ProblemArrays, make_problem_arrays

_PA_FIELDS = ("attends", "conflict", "possible", "student_count",
              "room_size", "event_mask", "room_mask", "anchor_slots",
              "anchor_w")


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def problem_arrays_from_numpy(pa, device="cpu") -> ProblemArrays:
    """A JAX ProblemArrays (or a dict of its fields) -> the port's."""
    fields = {k: np.asarray(_get(pa, k)) for k in _PA_FIELDS}
    return make_problem_arrays(
        **fields, n_days=int(_get(pa, "n_days")),
        slots_per_day=int(_get(pa, "slots_per_day")), device=device)


def _i32(x, device):
    return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)


def pop_state_from_numpy(state, device="cpu") -> PopState:
    """A JAX PopState (slots, rooms, penalty, hcv, scv) -> the port's."""
    return PopState(*(_i32(_get(state, k), device)
                      for k in PopState._fields))


def ls_state_from_numpy(state, device="cpu") -> LSState:
    """A JAX LSState -> the port's (att/occ stay int16)."""
    out = {}
    for k in LSState._fields:
        x = np.asarray(_get(state, k))
        out[k] = torch.tensor(
            x,
            dtype=torch.int16 if k in ("att", "occ") else torch.int32,
            device=device)
    return LSState(**out)
