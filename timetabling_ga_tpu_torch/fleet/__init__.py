"""The fleet (mirrors timetabling_ga_tpu.fleet): the replica side so far.

  gateway.py     the `/v1` solve protocol a gateway and every replica
                 front share (ApiHandler, the payload parsing)
  replicas.py    the HTTP replica (`serve --http`), its drive loop and
                 preempt drain, and its client (http_json,
                 ReplicaHandle)
  autoscaler.py  the scaleEntry report (`scale`)
"""
