"""On the card: a short run of each cell through the command the driver
runs, whose last line is a correct result on the card it names."""

import json
import os
import subprocess
import sys

import pytest

from portbench.run import ROOT

CELLS = ["resnet50_dconv_se.serve_b128", "resnet50_dconv_se.train_b128",
         "hrnet_w32.train_b128"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct_on_the_card(card, workload):
    proc = subprocess.run([sys.executable, os.path.join("portbench", "run.py"), "--workload",
                           workload, "--seed", str(2 ** 31 + 99), "--seconds", "2",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
