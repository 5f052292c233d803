"""Subpackage of the PyTorch port (mirrors timetabling_ga_tpu.runtime)."""
