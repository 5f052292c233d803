"""`python -m timetabling_ga_tpu_torch.analysis` — the tt-analyze CLI."""

import sys

from timetabling_ga_tpu_torch.analysis import main

sys.exit(main())
