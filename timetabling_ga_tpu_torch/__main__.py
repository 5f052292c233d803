"""`python -m timetabling_ga_tpu_torch` == `python -m timetabling_ga_tpu_torch.cli`."""

import sys

from timetabling_ga_tpu_torch.cli import main

sys.exit(main())
