"""The port's kernel bench (``niceslam_tpu_torch/kernel_bench.py``) against
the JAX package's ``scripts/kernel_bench.py`` (loaded by path, its compile
cache setting stubbed): the JAX script's ``main`` with ``--pallas`` runs
with its timer stubbed and its ``report`` recording each op's name, count
and analytic cost. The port's ops at the script's shapes must have the same
names in the same order, the same counts and the same ``gflops``,
``mbytes`` and ``sol_ms``; each op's plain CPU path then runs at a tiny
size, and its record has the script's keys."""
import importlib.util
import json
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

from niceslam_tpu.utils import roofline as jroof
from niceslam_tpu_torch import kernel_bench as kb
from niceslam_tpu_torch.grid.hierarchy import GridConfig, init_grids
from niceslam_tpu_torch.models.decoders import DecoderConfig, init_decoders
from niceslam_tpu_torch.render.renderer import RenderConfig
from niceslam_tpu_torch.utils import roofline

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ["op", "n", "mean_ms", "p50_ms", "gflops", "mbytes", "sol_ms", "frac_sol"]


def jax_ops():
    """``(op, n, cost)`` of every op the JAX script reports with
    ``--pallas``, in its order."""
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, "update", lambda *a, **kw: None)
        spec = importlib.util.spec_from_file_location(
            "jax_kernel_bench", os.path.join(_ROOT, "scripts", "kernel_bench.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mp.setattr(mod, "timeit_scanned", lambda fn, *a, **kw: (1.0, 1.0))
        mp.setattr(mod, "report", lambda name, n, m, p50, extra=None, cost=None, peaks=None:
                   seen.append((name, n, cost)))
        mp.setattr(sys, "argv", ["kernel_bench.py", "--pallas"])
        mod.main()
    return seen


def full_size_ops():
    """The port's ops at the JAX script's shapes (built, not run)."""
    gen = torch.Generator().manual_seed(0)
    bound = np.asarray(kb.BOUND, np.float32)
    grids, bounds, adj = init_grids(bound, GridConfig(), gen=gen, device="cpu")
    params = init_decoders(DecoderConfig(), gen=gen, device="cpu")
    pts = torch.rand((kb.N_POINTS, 3), generator=gen) * torch.from_numpy(
        bound[:, 1] - bound[:, 0]) + torch.from_numpy(bound[:, 0])
    return (kb.main_ops(params, grids, bounds, torch.as_tensor(adj), pts)
            + kb.pallas_ops(grids, bounds, pts))


def tiny_ops():
    """The same ops on a coarse grid, 64 points, 4 and 8 rays, 8+4 samples."""
    gen = torch.Generator().manual_seed(1)
    bound = np.asarray([[-1.0, 1.0]] * 3, np.float32)
    grids, bounds, adj = init_grids(
        bound, GridConfig(coarse_len=1.0, middle_len=0.5, fine_len=0.25, color_len=0.25,
                          bound_divisable=0.25), gen=gen, device="cpu")
    params = init_decoders(DecoderConfig(), gen=gen, device="cpu")
    pts = torch.rand((64, 3), generator=gen) * 1.8 - 0.9
    return (kb.main_ops(params, grids, bounds, torch.as_tensor(adj), pts,
                        RenderConfig(n_samples=8, n_surface=4), track_rays=4, map_rays=8)
            + kb.pallas_ops(grids, bounds, pts))


@pytest.fixture(scope="module")
def ops():
    return jax_ops(), full_size_ops(), tiny_ops()


N_OPS = 28  # 14 in the main section, 14 in the Pallas section


def test_op_names_equal_the_jax_script(ops):
    want, got, tiny = ops
    assert len(want) == N_OPS
    assert [op.name for op in got] == [name for name, _, _ in want]
    assert [op.name for op in tiny] == [name for name, _, _ in want]


@pytest.mark.parametrize("i", range(N_OPS))
def test_op_runs_on_the_cpu_with_the_jax_cost(ops, i, capsys):
    (name, n, cost), op, small = ops[0][i], ops[1][i], ops[2][i]
    peaks = roofline.device_peaks("cpu")
    assert tuple(peaks) == tuple(jroof._PEAKS["cpu"])
    rec = kb.record(op, 1.0, 1.0, peaks)
    assert op.n == n
    assert rec["sol_ms"] == round(jroof.sol_ms(cost["flops"], cost["bytes"], peaks), 4)
    assert rec["gflops"] == round(cost["flops"] / 1e9, 2)
    assert rec["mbytes"] == round(cost["bytes"] / 1e6, 2)
    # The plain CPU path at a tiny size: finite outputs and one record.
    out = small.fn()
    leaves = [out] if isinstance(out, torch.Tensor) else [t for t in out if t is not None]
    assert leaves and all(bool(torch.isfinite(t).all()) for t in leaves)
    (line,) = kb.run_ops([small], "cpu", peaks, iters=2, k=2)
    printed = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(s) for s in printed] == [line]
    assert list(line)[:len(KEYS)] == KEYS and line["op"] == name
    assert all(math.isfinite(line[k]) and line[k] > 0 for k in ("mean_ms", "p50_ms"))
    assert math.isfinite(line["sol_ms"]) and line["sol_ms"] >= 0  # rounded: 0 at a tiny size


def test_main_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would run for real")
    with pytest.raises(RuntimeError, match="--cpu"):
        kb.main([])
