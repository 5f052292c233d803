"""The fleet (port of timetabling_ga_tpu/fleet): an HTTP solve front and
an N-replica router.

  gateway.py     the `/v1` solve protocol a gateway and every replica
                 front share, and the Gateway: accept-and-enqueue
                 handlers, one dispatcher thread that owns every
                 outbound call (routing, submission, polls, snapshot
                 cache, failover, drain), and the cached job table
  router.py      the bucket-affine router: jobs land where their bucket
                 is warm, by each replica's /readyz reasons, backlog
                 gauge and compile-hit rate
  replicas.py    the HTTP replica (`serve --http`), its drive loop and
                 preempt drain, its client (http_json, ReplicaHandle),
                 the prober (ReplicaSet) and the spawned workers
  autoscaler.py  the autoscaler and its scaleEntry report (`scale`)
  client.py      `submit`, the stdlib HTTP client

The gateway, router, client, autoscaler and replica set touch no device
and load no torch: the solver enters a process only through a replica's
drive loop.
"""

from timetabling_ga_tpu_torch.fleet.router import NoReplicaError, Router

__all__ = ["Router", "NoReplicaError"]
