"""On the card: each cell through the command, with a short window.

    python3 -m pytest -m cuda streambench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from streambench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q5_p8_sat", "q5_p8_rate"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "-m", "streambench.run", "--workload", name,
         "--seed", str(2**31 + 5), "--seconds", "3", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out
    assert out["device"]["platform"] == "gpu"
