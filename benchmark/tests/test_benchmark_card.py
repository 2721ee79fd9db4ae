"""The cells and their controls on the card, at the cells' own sizes with a
short window: ``python -m pytest -m cuda benchmark/tests`` on a machine with
an H100. Each test looks for the card itself and skips without one."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness

CELLS = [w["name"] for w in
         json.load(open(harness.ROOT / "BENCHMARK.json"))["workloads"]]
# windows long enough to finish a greedy and a sampled batch (flagship: up
# to 6.6 s a batch, 512ch ~10 s) or utterance of a stream (up to 5 s of
# audio at ~0.6x real time each)
SECONDS = {"synth.flagship.b256": "15", "synth.512ch.b128": "20",
           "stream.flagship.b1": "20"}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(*args):
    proc = subprocess.run([sys.executable, "-m", *args], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(name):
    _need_card()
    seconds = SECONDS.get(name, "6")
    out = _run("benchmark.run", "--workload", name, "--seed", "2147483999",
               "--seconds", seconds, "--trace", "0")[-1]
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    """The reference at fp8 in the program's place fails a limit."""
    _need_card()
    seconds = SECONDS.get(name, "4")
    for rec in _run("benchmark.control", "--workload", name, "--seeds",
                    "31,32,33", "--seconds", seconds, "--controls", "fp8"):
        assert rec["controls"]["fp8"]["correct"] is False, rec["controls"]
