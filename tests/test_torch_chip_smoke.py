"""``chip_smoke.py`` refuses to report a result where it cannot run the port
on a card: on a machine without CUDA, and in a directory that holds the
script but not the package."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_package(tmp_path, where):
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run for real")
    script = os.path.join(_ROOT, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
