"""TT501 fixture: no JAX, and imports outside the pinned torch surface.

Not imported or executed — parsed by tests/test_torch_analysis.py.
"""
import importlib

import torch                                        # OK: pinned
import torch.distributed as dist                    # OK: pinned
import jax                                          # EXPECT TT501
import jax.numpy as jnp                             # EXPECT TT501
from timetabling_ga_tpu.ops import fitness          # EXPECT TT501
from timetabling_ga_tpu_torch.ops import ga         # OK: the port itself
import torch.utils.cpp_extension                    # EXPECT TT501
from torch.profiler import schedule                 # EXPECT TT501
from torch.profiler import profile                  # OK: pinned

try:
    import jaxlib                                   # EXPECT TT501
except ImportError:
    jaxlib = None

try:
    from torch.cuda import nvtx                     # OK: guarded
except ImportError:
    nvtx = None

ref = importlib.import_module("timetabling_ga_tpu.compat")  # EXPECT TT501
from torch.profiler import tensorboard_trace_handler  # tt-analyze: ignore[TT501]
