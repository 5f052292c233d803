"""TT603 fixture: allocator/device introspection on hot paths.

Not imported or executed — parsed by tests/test_torch_analysis.py (the
test config adds this file to `dispatch_modules`).
"""
import torch


def program(name, fn):
    return fn


def step(x, device):
    sms = torch.cuda.get_device_properties(device)  # EXPECT TT603
    return x * sms.multi_processor_count


def drive(runner, state, n, device):
    for _ in range(n):
        state = runner(state)
        used = torch.cuda.memory_allocated(device)  # EXPECT TT603
        free, _total = torch.cuda.mem_get_info(device)  # EXPECT TT603
        print(used, free)
    peak = torch.cuda.max_memory_allocated(device)  # OK: outside loops
    return program("step", step)(state, device), peak
