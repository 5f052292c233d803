"""The pinned torch surface of the port (the counterpart of JAX's
timetabling_ga_tpu/compat.py table; no shims: nothing the port calls has
moved between the PyTorch versions it runs on).

`TORCH_COMPAT_TABLE` maps a module path to the names the port may
import from it or reach as attributes of it: the analyzer's TT501 and
TT502 (timetabling_ga_tpu_torch/analysis/rules_api.py) read it by AST,
and chip_smoke.py resolves every entry on the card machine's PyTorch.
Where API drift lives (torch.cuda, torch.distributed, torch.profiler,
torch.backends, torch.autograd) the names are listed one by one; "*" on
the tensor namespace allows any public name.
"""

TORCH_COMPAT_TABLE = {
    "torch": ["*"],
    "torch.nn.functional": ["one_hot"],
    "torch.cuda": ["Event", "current_device", "current_stream", "device",
                   "device_count", "get_device_properties", "is_available",
                   "max_memory_allocated", "mem_get_info",
                   "memory_allocated", "set_device", "synchronize"],
    "torch.distributed": ["P2POp", "PrefixStore", "ReduceOp", "TCPStore",
                          "all_gather", "all_reduce", "batch_isend_irecv",
                          "broadcast", "init_process_group", "irecv",
                          "isend"],
    "torch.distributed.ReduceOp": ["MIN"],
    "torch.profiler": ["ProfilerActivity", "profile", "record_function"],
    "torch.profiler.ProfilerActivity": ["CPU", "CUDA"],
    "torch.backends": ["cuda", "cudnn"],
    "torch.backends.cuda": ["matmul"],
    "torch.backends.cuda.matmul": ["allow_tf32"],
    "torch.backends.cudnn": ["allow_tf32"],
    "torch.autograd": ["DeviceType"],
    "torch.autograd.DeviceType": ["CUDA"],
}
