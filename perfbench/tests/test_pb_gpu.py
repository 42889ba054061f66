"""A short cell on the card: the entry point as the benchmark's check runs
it.  Decided inside the test; skips without a card."""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.gpu
def test_short_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "granite-moe-1b-a400m.decode-batch", "--seed",
                        "2147483659", "--seconds", "20", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert "mfu.closed" in out["metrics"]
