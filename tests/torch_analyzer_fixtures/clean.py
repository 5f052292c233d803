"""Negative fixture: idiomatic port code that must produce ZERO findings
under every rule — the analyzer's false-positive guard.

Not imported or executed — parsed by tests/test_torch_analysis.py.
"""
import functools
from typing import NamedTuple

import numpy as np
import torch

from timetabling_ga_tpu_torch.runtime import dispatch_core as dcore

_PROGRAM_CACHE: dict = {}


class Rows(NamedTuple):
    slots: torch.Tensor
    pen: torch.Tensor


def program(name, fn):
    return fn


def make_step(scale):
    return lambda s: s * scale


def cached_step(scale):
    key = (scale,)
    step = _PROGRAM_CACHE.get(key)
    if step is None:
        step = make_step(scale)
        _PROGRAM_CACHE[key] = step
    return step


@functools.lru_cache(maxsize=8)
def weights(p1: float, p2: float, device) -> torch.Tensor:
    return torch.tensor([p1, p2], device=device)


def step(rows: Rows, gen, device):
    # element-wise selection and explicit generators
    u = torch.rand(rows.pen.shape, generator=gen, device=device)
    keep = (u < 0.5) & (rows.pen > 0)
    if rows.slots.shape[0] > 16:                     # static
        rows = Rows(rows.slots[:16], rows.pen[:16])
    return Rows(torch.where(keep[:, None], rows.slots, -rows.slots),
                rows.pen)


def generators(seed, n, device):
    return [torch.Generator(device=device).manual_seed(seed * 1000 + i)
            for i in range(n)]


def drive(rows, n, device, p1, p2):
    gens = generators(7, 2, device)
    w = weights(p1, p2, device)
    for i in range(n):
        rows = program("step", step)(rows, gens[i % 2], device)
        stats = dcore.fetch(rows.pen)
        if int(np.min(stats)) == 0:
            break
    return rows, w
