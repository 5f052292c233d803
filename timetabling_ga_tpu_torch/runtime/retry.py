"""Which failures are transient, and the retry policy for them (copy of
timetabling_ga_tpu/runtime/retry.py:1-127).

`is_transient` decides whether the run supervisor (runtime/
dispatch_core.py Supervisor) and the serve path's quantum recovery may
rehydrate and go on: the error, or anything on its `__cause__` /
`__context__` chain (at most `_CHAIN_LIMIT` links, so a cycle ends),
carries one of TRANSIENT_MARKERS. The marker set is JAX's, unchanged.
A sticky CUDA error (an illegal address, a launch failure) carries none
of them, so it is not transient: the run aborts with its faultEntry and
a final checkpoint, as a JAX run aborts on a non-transient error.

`retry_transient` retries a call through transient errors with
exponential backoff (`backoff_schedule`); anything else re-raises at
once.
"""

from __future__ import annotations

import sys
import time

# substrings of a transient failure, matched against str(exception)
# over the whole cause chain (JAX retry.py:28-59)
TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "response body closed",
    "remote_compile",
    "fetch watchdog",           # dispatch_core.FetchTimeout
    "Connection refused",
    "Connection reset",
    "Remote end closed connection",
    "timed out",
    "peer declared a fault",
)

# the longest cause chain walked: a cycle must not spin the classifier
_CHAIN_LIMIT = 16


def is_transient(exc: BaseException) -> bool:
    """True when `exc`, or anything on its `__cause__`/`__context__`
    chain, carries a TRANSIENT_MARKERS substring."""
    seen: set = set()
    e = exc
    while e is not None and len(seen) < _CHAIN_LIMIT:
        if id(e) in seen:
            break
        seen.add(id(e))
        if any(m in str(e) for m in TRANSIENT_MARKERS):
            return True
        e = e.__cause__ if e.__cause__ is not None else e.__context__
    return False


def backoff_schedule(attempts: int, wait_s: float, backoff: float,
                     max_wait_s: float):
    """The waits retry_transient sleeps between attempts: exponential
    from `wait_s` by `backoff`, capped at `max_wait_s`."""
    return [min(wait_s * backoff ** i, max_wait_s)
            for i in range(max(0, attempts - 1))]


def retry_transient(fn, *args, attempts: int = 3, wait_s: float = 120.0,
                    backoff: float = 2.0, max_wait_s: float = 600.0):
    """Call `fn(*args)`, retrying on transient errors. Returns (result,
    attempts used). A non-transient error, or the last attempt's, is
    re-raised with `exc.tt_attempts` set."""
    waits = backoff_schedule(attempts, wait_s, backoff, max_wait_s)
    for attempt in range(1, attempts + 1):
        try:
            return fn(*args), attempt
        except Exception as e:
            e.tt_attempts = attempt
            if not is_transient(e) or attempt == attempts:
                raise
            wait = waits[attempt - 1]
            print(f"# transient device error "
                  f"({getattr(fn, '__name__', 'fn')}, attempt "
                  f"{attempt}/{attempts}): {str(e)[:120]}; retrying in "
                  f"{wait:.0f}s", file=sys.stderr, flush=True)
            time.sleep(wait)
