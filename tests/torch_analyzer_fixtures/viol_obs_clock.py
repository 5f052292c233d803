"""TT601 fixture: clocks and spans inside device programs.

Not imported or executed — parsed by tests/test_torch_analysis.py:
`sweep` is a device program through `program(...)`, `nested` through
the test config, which adds this file to `program_modules` (as ops/
is).
"""
import time
from time import perf_counter

from timetabling_ga_tpu_torch.obs.spans import SpanTracer


def sweep(x, tracer):
    t0 = time.monotonic()                           # EXPECT TT601
    y = x * 2
    dt = perf_counter() - t0                        # EXPECT TT601
    with tracer.span("sweep"):                      # EXPECT TT601
        y = y + 1
    SpanTracer(None).record("x", t0, dt)            # EXPECT TT601
    return y


def nested(x):
    def inner(v):
        return v, time.time()                       # EXPECT TT601
    return inner(x)


def program(name, fn):
    return fn


def driver(x, tracer):
    return program("sweep", sweep)(x, tracer)
