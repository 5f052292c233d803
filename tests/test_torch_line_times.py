"""timetabling_ga_tpu_torch/line_times.py: the output passes through
unchanged, and each line's arrival is written beside its start."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_lines_pass_through_with_their_times(tmp_path):
    ts = tmp_path / "run.ts"
    text = '{"build_seconds": 1.5}\n' + "x" * 150 + "\n"
    r = subprocess.run(
        [sys.executable, "-m", "timetabling_ga_tpu_torch.line_times",
         str(ts)], input=text, capture_output=True, text=True, cwd=REPO,
        timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout == text
    rows = [line.split("\t") for line in ts.read_text().splitlines()]
    assert [row[1] for row in rows] == ['{"build_seconds": 1.5}', "x" * 100]
    times = [float(row[0]) for row in rows]
    assert 0 <= times[0] <= times[1] <= float(r.stderr.strip())
