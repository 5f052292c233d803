"""The dispatch helpers on one card (port of the one-device part of
timetabling_ga_tpu/runtime/dispatch_core.py:344-525).

    place_state   a host (numpy) PopState onto the device (JAX
                  `reshard_state`, on one card a copy per field)
    state_nbytes  bytes a PopState moves across the host boundary when
                  parked or placed: the unit of `serve.park_bytes` and
                  `serve.resume_bytes`
    fetch_leaf    a telemetry leaf (a trace) to the host
    fetch_state   a PopState to the host in one device read
    decode_telemetry  a fetched trace leaf's events, moments and quality
                  rows, dropped improvement events counted (JAX :520)

The engine's final read, checkpoints and trace decode and the serve
scheduler's parks and quanta share them. JAX's dispatch pipeline (A16)
is not ported yet.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from timetabling_ga_tpu_torch.ops import ga
from timetabling_ga_tpu_torch.parallel import islands


def place_state(host: ga.PopState, device) -> ga.PopState:
    """Place a host (numpy) PopState on `device` as int32 tensors."""
    return ga.PopState(*(torch.from_numpy(np.ascontiguousarray(
        x, dtype=np.int32)).to(device) for x in host))


def state_nbytes(state) -> int:
    """Bytes of a PopState's fields, host (numpy) or device (torch);
    0 for None."""
    if state is None:
        return 0
    return int(sum(x.nbytes if isinstance(x, np.ndarray)
                   else x.numel() * x.element_size() for x in state))


def fetch_leaf(x) -> np.ndarray:
    """A telemetry leaf (a trace) on the host."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fetch_state(state: ga.PopState) -> ga.PopState:
    """Host (numpy) copy of a population in one device read: slots,
    rooms, penalty, hcv and scv packed into one (N, 2E + 3) int32 array,
    fetched once and sliced apart."""
    packed = torch.cat([state.slots, state.rooms, state.penalty[:, None],
                        state.hcv[:, None], state.scv[:, None]],
                       1).cpu().numpy()
    E = state.slots.shape[1]
    return ga.PopState(packed[:, :E], packed[:, E:2 * E], packed[:, 2 * E],
                       packed[:, 2 * E + 1], packed[:, 2 * E + 2])


def decode_telemetry(trace, quality: bool, trace_mode: str, metrics,
                     overflow_counter: str, overflow_warned: bool,
                     warn_label: str = ""):
    """The telemetry decode of a retired dispatch or quantum, shared by
    the engine and the serve scheduler (JAX dispatch_core.py:520): the
    quality rows split off the fetched leaf, its events decoded under
    the effective trace mode (a `full` trace packs as deltas under
    quality; the record stream is the same), and the improvement events
    the event block could not hold counted into `overflow_counter` of
    `metrics` (engine.trace_delta_overflow, serve.trace_delta_overflow),
    with one warning on stderr, prefixed by `warn_label`. Returns
    (events, moments, quality rows or None, overflow_warned)."""
    trace, qrows = islands.split_quality(trace, quality)
    events, counts, moments = islands.trace_events(
        trace, islands.effective_trace_mode(trace_mode, quality))
    if counts is not None:
        dropped = int(sum(max(0, int(c) - len(e))
                          for c, e in zip(counts, events)))
        if dropped:
            metrics.counter(overflow_counter).inc(dropped)
            if not overflow_warned:
                overflow_warned = True
                print(f"warning: {warn_label}--trace-mode {trace_mode} "
                      f"dropped {dropped} improvement event(s) this "
                      f"dispatch (cap {islands.TRACE_DELTAS_CAP}; raise "
                      f"TT_TRACE_DELTAS_CAP)", file=sys.stderr)
    return events, moments, qrows, overflow_warned
