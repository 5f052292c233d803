"""Fixture package for the whole-program rules (TT303/TT304/TT305/
TT306): `core.py` plays the dispatch core (the program factory, a
device program, the sanctioned fetch, the host copy), `loop.py` plays
the dispatch loops in another module that break the taint, copy and
fence discipline across the module boundary."""
