"""On the card: one short run of a cell through the CLI comes out
correct, and the control (the reference in float32 in the program's
place) comes out rejected.  ``python -m pytest -m card portbench/tests``
on a machine with a card; skips without one."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
def test_a_short_run_is_correct_and_the_control_is_rejected(card):
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "livejournal.acyclic.c16", "--seed", str(2**33 + 1),
         "--seconds", "5",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    assert json.loads(run.stdout.strip().splitlines()[-1])["correct"]
    ctl = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload",
         "livejournal.acyclic.c16", "--seeds", str(2**33 + 2),
         "--seconds", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert ctl.returncode == 0, ctl.stderr[-2000:]
    line = json.loads(ctl.stdout.strip().splitlines()[-1])
    assert line["program"]["wrong_counts"]["value"] == 0
    assert any(line["rejected"].values())
