"""The fleet (mirrors timetabling_ga_tpu.fleet): only the autoscaler's
scaleEntry report so far."""
