"""TT401 fixture: draws outside their generator, and one seed feeding
two generators.

Not imported or executed — parsed by tests/test_torch_analysis.py.
"""
import numpy as np
import torch


def draws(n, E, gen, device, seed):
    a = torch.rand((n, E), device=device)           # EXPECT TT401
    b = torch.randint(0, 8, (n,), device=device)    # EXPECT TT401
    c = torch.randperm(E)                           # EXPECT TT401
    w = torch.ones(3)
    d = w.multinomial(n, replacement=True)          # EXPECT TT401
    e = torch.empty(n).uniform_()                   # EXPECT TT401
    ok = torch.rand((n, E), generator=gen, device=device)     # OK
    ok2 = torch.multinomial(w, n, replacement=True, generator=gen)  # OK
    ok3 = torch.empty(n).normal_(generator=gen)     # OK
    host = np.random.default_rng(seed).permutation(E)  # OK: numpy's
    return a, b, c, d, e, ok, ok2, ok3, host


def generators(seed, device):
    g1 = torch.Generator(device=device)
    g1.manual_seed(seed + 1)
    g2 = torch.Generator(device=device).manual_seed(seed + 1)  # EXPECT TT401
    g3 = torch.Generator(device=device).manual_seed(seed + 2)  # OK
    seed = seed * 7
    g4 = torch.Generator(device=device).manual_seed(seed + 1)  # OK: rebound
    return g1, g2, g3, g4
