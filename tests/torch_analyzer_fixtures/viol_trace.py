"""TT101 fixture: implicit bool() on tensors in device programs.

Not imported or executed — parsed by tests/test_torch_analysis.py. The
device programs here are the functions handed to `program(name, fn)`
(the dcore.program proxy's shape) and to `torch.vmap`; each marked
statement makes the host wait for every queued kernel.
"""
from typing import NamedTuple

import torch


class State(NamedTuple):
    penalty: torch.Tensor
    hcv: torch.Tensor
    scv: torch.Tensor


class Arrays(NamedTuple):
    conflict: torch.Tensor
    anchored: bool


def program(name, fn):
    return fn


def step(state: State, cfg):
    best = state.penalty.min()
    if best == 0:                                   # EXPECT TT101
        return state
    while (state.hcv > 0).any():                    # EXPECT TT101
        state = state._replace(hcv=state.hcv - 1)
    assert state.scv.sum() >= 0                     # EXPECT TT101
    return state


def rows(x: torch.Tensor):
    for v in x[:4]:                                 # EXPECT TT101
        print(v)
    for i in range(torch.argmax(x)):                # EXPECT TT101
        print(i)


def static_ok(x: torch.Tensor, n: int, cfg):
    # OK: shapes, metadata, identity tests and host config are host values
    if x.shape[0] > 4 and x.dim() == 2:
        x = x[:4]
    if x.numel() == 0 or x.device.type == "cpu":
        return x
    if cfg.sideways is None or n > 3:
        return x * 2
    if x.is_cuda:
        return x
    # OK: an explicit read is a sync asked for by name (TT301 audits loops)
    if int(x.sum()) > 0 or x.item() > 0:
        return x
    return x


def host_side(x: torch.Tensor):
    # OK: no device program — nothing hands this function to a program
    if x.sum() > 0:
        return x
    return -x


def per_row(r: torch.Tensor):
    if r.sum() > 0:                                 # EXPECT TT101
        return r
    return -r


def unannotated(slots, pa, n, k=4):
    # no annotations: `slots` is a tensor by its own use (`.sum()`,
    # `[..., None]`); `pa` and `n` stay host values, `k` by its default
    if slots.sum() > 0:                             # EXPECT TT101
        return slots[..., None]
    if pa.anchored or n > k:                        # OK: host values
        return slots
    while (pa.conflict > 0).any():                  # EXPECT TT101
        pa = pa._replace(conflict=pa.conflict - 1)
    for obj in (slots, slots):                      # OK: a tuple display
        slots = obj
    return slots


def passed_on(slots, pa):
    # `slots` is a tensor because `unannotated` takes it as one
    if slots:                                       # EXPECT TT101
        return slots
    return unannotated(slots, pa, 3)


def driver(state, x):
    program("passed_on", passed_on)(x, None)
    program("unannotated", unannotated)(x, None, 3)
    out = program("runner", step)(state, None)
    program("rows", rows)(x)
    program("static", static_ok)(x, 3, None)
    return out, torch.vmap(per_row)(x)
