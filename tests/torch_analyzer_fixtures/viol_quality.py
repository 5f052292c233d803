"""TT604 fixture: quality accounting off the card.

Not imported or executed — parsed by tests/test_torch_analysis.py (the
test config adds this file to `dispatch_modules` and
`sharded_modules`). Quality rows ride the telemetry leaf the loop
already fetches; recomputing them on the host per dispatch, or adding
a collective or a draw to a quality helper, breaks that.
"""
import torch
import torch.distributed as dist


def drive_loop(runner, pa, state, batch_penalty):
    for _step in range(8):
        state, trace = runner(pa, state)
        pen = batch_penalty(pa, state.slots, state.rooms)  # EXPECT TT604
    return state, pen


def poll_until_drained(queue, pa, state, event_heat):
    while queue:
        queue.pop()
        heat = event_heat(pa, state.slots, state.rooms)    # EXPECT TT604
    return heat


def quality_gain_rows(best, group):
    # a quality reduction must ride the EXISTING migration exchange
    return group.exchange(best, best)                  # EXPECT TT604


def div_stats_rows(rep):
    dist.all_reduce(rep)                               # EXPECT TT302 # EXPECT TT604
    return rep


def hamming_sample_rows(slots, gen):
    # the coprime-stride sample exists precisely to avoid this draw
    order = torch.randperm(8, generator=gen)           # EXPECT TT604
    return slots[order]


def hamming_global_rows(slots):
    order = torch.randperm(8)          # EXPECT TT604 # EXPECT TT401
    return slots[order]


def fine_outside_loops(pa, state, batch_penalty):
    # OK: a one-off evaluation outside any dispatch loop
    return batch_penalty(pa, state.slots, state.rooms)


def quality_rows_ok(slots, index):
    # OK: a tensor's own gather is no collective
    return torch.gather(slots, 1, index)
