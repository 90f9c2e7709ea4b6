"""One short run of a real cell on the card, through the command line
(``python -m pytest benchmark/tests -m cuda`` on a machine with one)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "camera_linear.ordered13", "--seed", "4100000001", "--seconds", "5",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["compared"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert set(r["metrics"]) == {"pano_s", "peak_device_gib", "setup_s"}
    assert list(r)[-1] == "compared"
