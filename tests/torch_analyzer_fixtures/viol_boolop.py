"""TT102 fixture: and/or short-circuit on tensors in device programs.

Not imported or executed — parsed by tests/test_torch_analysis.py. The
device programs are the functions handed to `program(name, fn)`.
"""
import torch


def program(name, fn):
    return fn


def gate(x: torch.Tensor, y: torch.Tensor, use_default: bool):
    ok = (x > 0).all() and (y > 0).all()            # EXPECT TT102
    z = x.any() or y                                # EXPECT TT102
    fine = use_default or (x > 0)                   # OK: tensor last
    both = (x > 0) & (y > 0)                        # OK: element-wise
    return ok, z, fine, both


def nested(x: torch.Tensor, flag: bool):
    # one finding per chain: the outermost
    return (x.sum() and x.max()) or flag            # EXPECT TT102


def driver(x, y):
    program("gate", gate)(x, y, False)
    return program("nested", nested)(x, True)
