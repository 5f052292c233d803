"""TT309 fixture: edit-solve work on the dispatch path / in device
programs.

Not imported or executed — parsed by tests/test_torch_analysis.py (the
test config adds this file to `dispatch_modules`). tt-edit's diff,
apply and transplant are admission-time host work: once at the
submit/prepare seam, never per quantum and never inside a program.
"""
from timetabling_ga_tpu_torch.serve import editsolve
from timetabling_ga_tpu_torch.serve.editsolve import transplant as warm


def program(name, fn):
    return fn


def dispatch_loop(jobs, base, wire, runner, state):
    for job in jobs:
        edited, emap = editsolve.apply_ops(base, job.ops)  # EXPECT TT309
        job.resume_wire = warm(edited, emap, wire)         # EXPECT TT309
        state = runner(state, job)
    return state


def drain(queue, base, edited):
    while queue.busy():
        ops, emap = editsolve.diff_problems(base, edited)  # EXPECT TT309
        queue.tick(ops, emap)


def device_step(x, base, edited):
    editsolve.diff_problems(base, edited)                  # EXPECT TT309
    return x * 2


def driver(x, base, edited):
    return program("step", device_step)(x, base, edited)


def prepare_edit_is_fine(job, base_wire):
    # OK: the admission seam, once per submitted edit
    from timetabling_ga_tpu_torch.serve import editsolve as es
    base, edited, emap, _ops = es.resolve_edit(job.edit)
    return es.transplant(edited, emap, base_wire)
