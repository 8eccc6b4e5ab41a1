"""The port's bench (``niceslam_tpu_torch/bench.py``) against the JAX
package's ``bench.py``: the same configuration field by field under the
default and overridden ``BENCH_*`` variables (the JAX one captured by
calling ``bench.main()`` with its reader and system replaced by a stub that
records the config and stops, and ``jax.config.update`` stubbed so that no
compile cache is set), the same roofline arithmetic on the JAX cost
functions, and a tiny CPU run whose standard output is one line with
exactly ``bench.py``'s keys, each seed logging its own ATE or ``n/a``."""
import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

import niceslam_tpu.io.datasets.synthetic as jsynthetic
import niceslam_tpu.slam.system as jsystem
from niceslam_tpu.utils import roofline as jroof
from niceslam_tpu_torch import bench
from niceslam_tpu_torch.config.schema import (
    CamConfig,
    GridLenConfig,
    MappingConfig,
    RenderingConfig,
    SLAMConfig,
    TrackingConfig,
)
from niceslam_tpu_torch.grid.hierarchy import GridConfig, init_grids
from niceslam_tpu_torch.slam.system import NiceSLAM
from niceslam_tpu_torch.utils import roofline

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_BENCH = os.path.join(_ROOT, "bench.py")
ENV = ("BENCH_TRACK_PX", "BENCH_KF", "BENCH_SYNC", "BENCH_FRAMES", "BENCH_SEEDS")


class _Stop(Exception):
    pass


def _load_jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", _JAX_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_bench_config(monkeypatch) -> SLAMConfig:
    """The configuration ``bench.main()`` builds, caught where it makes its
    reader."""
    seen = {}

    def stop(cfg, *a, **kw):
        seen["cfg"] = cfg
        raise _Stop

    monkeypatch.setattr(jsynthetic, "SyntheticBoxReader", stop)
    monkeypatch.setattr(jsystem, "NiceSLAM", stop)
    monkeypatch.setattr(jax.config, "update", lambda *a, **kw: None)
    with pytest.raises(_Stop):
        _load_jax_bench().main()
    return seen["cfg"]


def jax_line_keys():
    """The keys of the dict that ``bench.py`` prints, read from its source."""
    tree = ast.parse(open(_JAX_BENCH).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            return [k.value for k in node.keys]
    raise AssertionError("no printed dict in bench.py")


@pytest.mark.parametrize("env", [
    {},
    {"BENCH_TRACK_PX": "123", "BENCH_KF": "50", "BENCH_SYNC": "strict"},
    {"BENCH_SYNC": "strict", "BENCH_FRAMES": "12", "BENCH_SEEDS": "2"},
], ids=["default", "overridden", "strict"])
def test_bench_config_equals_jax(monkeypatch, env):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = dataclasses.asdict(jax_bench_config(monkeypatch))
    got = dataclasses.asdict(bench.bench_config(**bench.bench_env()))
    assert got.keys() == want.keys()
    for field in want:
        assert got[field] == want[field], field
    assert got["pretrained_middle_fine"].endswith(os.path.join("models", "pretrained_decoders.npz"))
    # The smoke's strict configuration is the default one with sync set,
    # whatever the environment holds.
    strict = bench.bench_config(sync="strict")
    assert (strict.tracking.pixels, strict.mapping.keyframe_every) == (400, 10)
    if not env:
        assert dataclasses.asdict(strict) == {**want, "sync_method": "strict"}


def test_bench_config_needs_the_shipped_decoders(monkeypatch):
    """Without the shipped decoders the configuration raises, unless the
    caller takes random ones, as the JAX bench does with a warning."""
    monkeypatch.setattr(bench, "DECODERS", os.path.join(_ROOT, "models", "missing.npz"))
    with pytest.raises(FileNotFoundError, match="shipped decoders"):
        bench.bench_config()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        cfg = bench.bench_config(random_decoders=True)
    assert cfg.pretrained_middle_fine == "" and "RANDOM decoders" in err.getvalue()


def jax_roofline(cfg, gb, per_frame_s, peaks):
    """``bench.py:190-224`` on the JAX cost functions."""
    m_, t_ = cfg.mapping, cfg.tracking
    track_cost = jroof.render_cost(t_.pixels, 48, cfg.model.c_dim, gb, "color", backward=True)
    map_cost = jroof.mapping_step_cost(m_.pixels, 48, cfg.model.c_dim, gb)
    per_group_flops = (m_.every_frame * t_.iters * track_cost["flops"]
                       + 2 * m_.iters * map_cost["flops"])
    per_group_bytes = (m_.every_frame * t_.iters * track_cost["bytes"]
                       + 2 * m_.iters * map_cost["bytes"])
    group_s = per_frame_s * m_.every_frame
    return {
        "hbm_util": per_group_bytes / (peaks.hbm_gbps * 1e9) / group_s,
        "mfu": per_group_flops / peaks.flops_f32 / group_s,
        "sol_fps": m_.every_frame / max(per_group_bytes / (peaks.hbm_gbps * 1e9),
                                        per_group_flops / peaks.flops_f32),
    }


@pytest.mark.parametrize("per_frame_s", [0.05, 0.18, 1.7])
@pytest.mark.parametrize("card", ["NVIDIA H100 80GB HBM3", "cpu"])
def test_roofline_shares_equal_jax(per_frame_s, card):
    cfg = bench.bench_config()
    grids, _, _ = init_grids(np.asarray(cfg.bound, np.float32), GridConfig(), device="cpu")
    gb = {lvl: g.numel() * 4 for lvl, g in grids.items()}
    peaks = roofline.device_peaks(card)
    assert bench.roofline_shares(cfg, gb, per_frame_s, peaks) == jax_roofline(
        cfg, gb, per_frame_s, peaks)


def tiny_config() -> SLAMConfig:
    """A small world for the CPU: 24x32 camera, coarse voxels, a few
    pixels and iterations."""
    return SLAMConfig(
        dataset="synthetic",
        bound=((-2.2, 2.2), (-2.2, 2.2), (-2.2, 2.2)),
        cam=CamConfig(H=24, W=32, fx=20.0, fy=20.0, cx=16.0, cy=12.0),
        grid_len=GridLenConfig(coarse=1.5, middle=0.5, fine=0.25, color=0.25,
                               bound_divisable=0.25),
        tracking=TrackingConfig(pixels=32, iters=2, ignore_edge_H=2, ignore_edge_W=2),
        mapping=MappingConfig(pixels=64, iters_first=6, iters=2, every_frame=2,
                              keyframe_every=2, mapping_window_size=2, max_keyframes=8,
                              color_refine=False, bootstrap_frames=2, retrack=True),
        rendering=RenderingConfig(N_samples=8, N_surface=4),
        coarse=True,
        verbose=False,
        sync_method="async",
    )


@pytest.fixture(scope="module")
def tiny_run():
    """A tiny CPU bench of 4 frames (2 warm-up) and 3 seeds, in which seed
    1's result has no ATE: its printed line, standard output and error."""
    result = NiceSLAM.result

    def without_ate_for_seed_1(self):
        res = result(self)
        if self.seed == 1:
            res.pop("ate_rmse", None)
        return res

    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(NiceSLAM, "result", without_ate_for_seed_1)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            line = bench.run(tiny_config(), n_frames=4, seeds=3, warm=2, device="cpu")
    return line, out.getvalue(), err.getvalue()


def test_tiny_run_prints_one_line_with_the_jax_keys(tiny_run):
    line, out, _ = tiny_run
    lines = out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == line
    assert list(line) == jax_line_keys()
    assert line["metric"] == "end_to_end_tracked_frames_per_s" and line["unit"] == "frames/s"
    assert line["chip"] == "cpu"
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == line["value"]
    assert 0 < line["hbm_util"] and 0 < line["mfu"] and line["sol_fps"] > 0
    # Seeds 0 and 2 have an ATE, seed 1 none: the mean is over those two.
    assert len(line["ate_seeds_cm"]) == 2
    assert line["ate_seeds_cm"][0] == round(line["ate_seed0_cm"], 3)
    assert line["ate_rmse_cm"] == pytest.approx(np.mean(line["ate_seeds_cm"]), abs=1e-3)


def test_each_seed_logs_its_own_ate_or_na(tiny_run):
    """Not ``bench.py:187``'s fault: a seed without an ATE logs ``n/a``, not
    the seed before it."""
    line, _, err = tiny_run
    logged = dict(re.findall(r"^seed (\d+): ATE RMSE = (\S+?)(?: cm)?;", err, re.M))
    assert logged.keys() == {"0", "1", "2"}
    assert logged["1"] == "n/a"
    assert [float(logged["0"]), float(logged["2"])] == line["ate_seeds_cm"]
    assert re.search(r"^seed 1: .*graph pool 0\.0 MiB; peak n/a$", err, re.M)


def test_main_fails_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would run for real")
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="--cpu"):
        bench.main([])
