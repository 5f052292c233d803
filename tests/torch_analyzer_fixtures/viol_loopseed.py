"""TT402 fixture: loop-carried seeds.

Not imported or executed — parsed by tests/test_torch_analysis.py.
"""
import torch


def islands(n, seed, device):
    gens = []
    for i in range(n):
        g = torch.Generator(device=device)
        g.manual_seed(seed)                         # EXPECT TT402
        gens.append(g)
    same = [torch.Generator(device=device).manual_seed(seed)  # EXPECT TT402
            for _ in range(n)]
    return gens, same


def islands_ok(n, seed, device):
    gens = []
    for i in range(n):
        s = seed * 1000 + i                         # derived from i
        gens.append(torch.Generator(device=device).manual_seed(s))  # OK
    more = [torch.Generator(device=device).manual_seed(seed + k)     # OK
            for k in range(n)]
    return gens, more
