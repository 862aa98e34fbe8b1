"""The port's gallery runner (``examples_torch/run_all.py``) on the CPU, in
both of its modes: a gallery script and a script that fails, under a root
of their own.  The gallery script must succeed and have its wall written
to ``timings.txt``; the failing one must be reported as failed and left
out of it.

The runner runs in an interpreter of its own, as it does from the command
line: its forked mode forks a parent that has imported torch but run
nothing, and this test process has run torch's thread pools before.
"""

import os
import shutil
import subprocess
import sys

import pytest
from gallery_harness import ROOT

PROGRAM = """
import sys
from pathlib import Path

from examples_torch import run_all

mode, root = sys.argv[1], Path(sys.argv[2])
scripts = sorted(root.glob("*/*.py"))
failures = run_all.run(scripts, root, forked=mode == "forked")
print("FAILED", *[str(f.relative_to(root)) for f in failures])
"""


@pytest.mark.parametrize("mode", ["forked", "spawn"])
def test_run_all_runs_the_scripts_and_reports_a_failure(mode, tmp_path):
    (tmp_path / "steady").mkdir()
    shutil.copy(ROOT / "examples_torch" / "steady" / "linear_adv_dif.py", tmp_path / "steady")
    (tmp_path / "broken").mkdir()
    (tmp_path / "broken" / "fails.py").write_text("raise RuntimeError('a failing script')\n")
    env = {
        **os.environ,
        "MFV2D_EXAMPLES_DEVICE": "cpu",
        "MFV2D_EXAMPLES_FIGURES": "0",
        "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])),
    }
    out = subprocess.run(
        [sys.executable, "-c", PROGRAM, mode, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "FAILED broken/fails.py", out.stdout
    assert any(line.startswith("OK  steady/linear_adv_dif.py") for line in lines), out.stdout
    assert any(line.startswith("FAIL broken/fails.py") for line in lines), out.stdout
    timings = (tmp_path / "_figures" / "timings.txt").read_text().split()
    assert timings[0] == "steady/linear_adv_dif.py" and len(timings) == 2
    assert float(timings[1]) > 0
