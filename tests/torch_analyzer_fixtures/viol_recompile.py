"""TT201/TT202 fixture: cache-key hazards.

Not imported or executed — parsed by tests/test_torch_analysis.py.
"""
import functools

import numpy as np
import torch

_LIBS: dict = {}
PROGRAMS: dict = {}


@functools.lru_cache(maxsize=64)
def move_probs(p1: float, p2: float, device) -> torch.Tensor:
    return torch.tensor([p1, p2], device=device)


def load(name, path, flags):
    return (name, path, flags)


def make_runner(name, cfg):
    return (name, cfg)


def draws(cfg, device, weights):
    a = move_probs([cfg.p1], cfg.p2, device)        # EXPECT TT201
    b = move_probs(np.array(weights), 0.5, device)  # EXPECT TT201
    c = move_probs(torch.tensor(0.5), 0.5, device)  # EXPECT TT201
    for p in weights:
        move_probs(p, 0.5, device)                  # EXPECT TT201
    return a, b, c, move_probs(cfg.p1, cfg.p2, device)   # OK


def build(name, path, flags):
    _LIBS[name] = load(name, path, flags)           # EXPECT TT202
    key = (name, path)
    _LIBS[key] = load(name, path, flags)            # EXPECT TT202
    full = (name, path, flags)
    _LIBS[full] = load(name, path, flags)           # OK: whole key


def build_all(names, path, flags, kernels):
    _LIBS.update({n: load(n, path, flags)           # EXPECT TT202
                  for n in names})
    kernels._LIBS.update({names[0]: load(names[0], path, flags)})  # EXPECT TT202
    PROGRAMS.setdefault(path, make_runner(path, flags))  # EXPECT TT202
    _LIBS.update({(n, path, flags): load(n, path, flags)   # OK: whole key
                  for n in names})
    _LIBS.update(kernels.prebuilt)                  # OK: no key shown


def get_program(name, cfg):
    prog = make_runner(name, cfg)                   # EXPECT TT202
    PROGRAMS[name] = prog
    return prog
