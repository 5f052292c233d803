"""The multi-tenant batched solver service, its lanes on one card or
spread over several (port of timetabling_ga_tpu/serve).

  bucket.py     shape bucketing: pad an instance to geometric bucket
                boundaries with neutral, masked padding, so every job of a
                bucket shares one set of shapes
  queue.py      job admission and lifecycle: bounded backlog,
                priorities, per-job seed/budget/deadline, cancellation
  scheduler.py  packs same-bucket jobs into one dispatch (a lane each,
                each lane its own problem: problem.LaneProblems),
                time-slices them into generation quanta, parks and
                resumes them, keeps unchanged groups on the card
  snapshot.py   the per-job wire format: a park fence's state and
                progress, shipped and resumed (warm starts)
  editsolve.py  edit specs, the population transplant and the anchored
                objective's host side (edit jobs)
  service.py    the Python API (SolveService) and the line-JSON protocol
                (`python -m timetabling_ga_tpu_torch serve`)
"""

from timetabling_ga_tpu_torch.serve.bucket import (  # noqa: F401
    BucketSpec, bucket_dims, bucket_key, pad_problem)
from timetabling_ga_tpu_torch.serve.queue import (  # noqa: F401
    AdmissionError, Job, JobQueue, JobState)
