"""The chip scripts on the CPU: ``chip_smoke.py`` refuses to report a
result where it cannot run the port on a card (a machine without CUDA, a
directory that holds the script but not the package) and its lost-track
bound."""
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(_ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


@pytest.mark.parametrize("case", ["kept", "ate", "raw"])
def test_lost_track_bound(case):
    """A lost track fails on the ATE or on any frame's raw error, whatever
    the other says (a run on an H100 drifted 96.6 cm at a 26.9 cm ATE)."""
    smoke = _script("chip_smoke")
    err = {"kept": [0.0, 3.04, 5.61, 28.85], "ate": [0.0, 5.0, 9.0, 12.0],
           "raw": [0.0, 9.2, 40.0, 96.6]}[case]
    ate = {"kept": 4.13, "ate": 32.28, "raw": 26.89}[case]
    why = smoke.lost_track(ate, np.array(err))
    assert (why == "") == (case == "kept")
    if case == "raw":
        assert "frame 3" in why
