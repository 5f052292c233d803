"""TT502 fixture: torch attribute chains outside the pinned table.

Not imported or executed — parsed by tests/test_torch_analysis.py.
"""
import torch
import torch.distributed as dist


def probe(device):
    free, total = torch.cuda.mem_get_info(device)   # OK: pinned
    peak = torch.cuda.memory_reserved(device)       # EXPECT TT502
    dist.monitored_barrier()                        # EXPECT TT502
    t = torch.zeros(3, device=device)               # OK: "*" namespace
    flag = torch.backends.cuda.matmul.allow_tf32    # OK: pinned
    bf = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction  # EXPECT TT502
    hidden = torch._dynamo                          # EXPECT TT502
    try:
        cfg = torch._C._profiler._ExperimentalConfig  # OK: guarded
    except AttributeError:
        cfg = None
    has = getattr(torch.cuda, "nvtx", None)         # OK: a probe
    return free, total, peak, t, flag, bf, hidden, cfg, has
