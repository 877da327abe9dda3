"""On the card: a short run of each cell through the command, correct and on the GPU."""
import json
import subprocess
import sys

import pytest

from benchmark.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", tiny.DECLARED)
def test_a_short_run_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                          "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
                         cwd=tiny.ROOT, capture_output=True, text=True, timeout=600, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
