"""The port's diagnostics (``niceslam_tpu_torch/diagnostics/``) against the
JAX package's scripts (``scripts/<name>.py``, loaded by path):

- each module's configuration equals its script's field by field, the
  script's caught where it builds its reader or system (or, for
  ``mapper_step_probe`` and ``dispatch_probe``, in the arguments of its
  first program calls), under the defaults and under other arguments;
- each printed record has the keys of the dicts the script prints, read
  from its source;
- on identical state (the JAX system's, converted with ``convert.py``) the
  draw-free parts agree with the script's own record, printed unrounded
  (its ``round`` replaced by the identity): ``saturation_probe`` at full
  width within 1e-5 on values and 2e-5 relative on the gradient norm;
  ``bias_probe``, ``depth_diag`` and the true-pose part of ``track_diag``
  at a tiny world within ``VALUE_RTOL`` / ``VALUE_ATOL``, and
  ``track_diag``'s solve and three losses on the JAX keys' pixels (5 and
  123, injected) within ``TRACK_RTOL``;
- the parts that hang on a package's own draws (``lag_probe``,
  ``accuracy_probe``, ``perf_breakdown``, ``mapper_step_probe``,
  ``dispatch_probe``) give finite numbers of the right types at a tiny
  world; ``lag_probe``'s rebuilt warm start is the system's, frame by
  frame, and ``perf_breakdown``'s wrapped run the unwrapped trajectory;
- without a card each ``main`` raises unless ``--cpu`` is given.
"""
import ast
import contextlib
import dataclasses
import importlib
import importlib.util
import io
import json
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

import niceslam_tpu.config.schema as jschema
import niceslam_tpu.io.datasets.synthetic as jsynthetic
import niceslam_tpu.slam.keyframes as jkf
import niceslam_tpu.slam.mapper as jmapper
import niceslam_tpu.slam.system as jsystem
import niceslam_tpu.slam.tracker as jtracker
from niceslam_tpu_torch import bench, convert
from niceslam_tpu_torch.config import schema as tschema
from niceslam_tpu_torch.core.rays import Intrinsics
from niceslam_tpu_torch.diagnostics import (
    accuracy_probe,
    bias_probe,
    depth_diag,
    dispatch_probe,
    lag_probe,
    mapper_step_probe,
    perf_breakdown,
    saturation_probe,
    track_diag,
    world,
)
from niceslam_tpu_torch.grid.hierarchy import GridConfig
from niceslam_tpu_torch.render.renderer import RenderConfig
from niceslam_tpu_torch.slam.tracker import TrackConfig
from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
from niceslam_tpu_torch.slam.system import NiceSLAM

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = {m.__name__.rsplit(".", 1)[1]: m for m in (
    saturation_probe, bias_probe, depth_diag, track_diag, lag_probe, accuracy_probe,
    perf_breakdown, mapper_step_probe, dispatch_probe)}

# Renders of one map by both packages at the tiny world: each value (cm
# where the record says so) within VALUE_RTOL relative or VALUE_ATOL.
VALUE_RTOL, VALUE_ATOL = 1e-4, 1e-3
# The pose solve on the same pixels, 10 GN iterations: losses and cm.
TRACK_RTOL, TRACK_ATOL = 1e-3, 1e-3


class _Stop(Exception):
    pass


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(_ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_script(monkeypatch):
    """Run a JAX script's ``main`` under ``argv``, its compile cache left
    alone: what it printed on standard output."""
    monkeypatch.setattr(jax.config, "update", lambda *a, **kw: None)

    def run(name, argv=(), unrounded=False):
        mod = load_script(name)
        if unrounded:
            mod.round = lambda x, n=None: x
        monkeypatch.setattr(sys, "argv", [name, *argv])
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            mod.main()
        return out.getvalue()

    return run


def catch_config(monkeypatch, jax_script, name, argv) -> dict:
    """The configuration a script builds, caught where it makes its reader
    (or its system), and the reader's frame count."""
    seen = {}

    def stop(cfg, *a, **kw):
        seen.update(cfg=cfg, n_frames=kw.get("n_frames"))
        raise _Stop

    monkeypatch.setattr(jsynthetic, "SyntheticBoxReader", stop)
    monkeypatch.setattr(jsystem, "NiceSLAM", stop)
    with pytest.raises(_Stop):
        jax_script(name, argv)
    return seen


def as_fields(cfg) -> dict:
    """A configuration's fields, the decoders' path as the port resolves
    it (the scripts' paths are relative to the repository's root)."""
    d = dataclasses.asdict(cfg)
    d["pretrained_middle_fine"] = world.decoders_path(d["pretrained_middle_fine"])
    return d


def port_config(name, argv):
    """The port module's configuration under the script's ``argv``."""
    if name == "saturation_probe":
        return saturation_probe.config(*argv[:1])
    if name == "bias_probe":
        return bias_probe.config()
    if name == "depth_diag":
        a = depth_diag.parser().parse_args(argv)
        return depth_diag.config(a.pretrained, a.iters_first, a.iters)
    if name == "track_diag":
        a = track_diag.parser().parse_args(argv)
        return track_diag.config(a.pretrained, a.decoder_train)
    if name == "lag_probe":
        a = lag_probe.parser().parse_args(argv)
        return lag_probe.config(a.pretrained, a.separate_lr, a.track_iters, a.track_pixels,
                                a.track_lr, a.depth_gate)
    if name == "accuracy_probe":
        return accuracy_probe.config(accuracy_probe.parser().parse_args(argv))
    if name == "perf_breakdown":
        return perf_breakdown.config()
    raise KeyError(name)


CONFIG_CASES = [
    ("saturation_probe", []), ("saturation_probe", ["none"]),
    ("saturation_probe", ["models/other.npz"]),
    ("bias_probe", []),
    ("depth_diag", []),
    ("depth_diag", ["--frames", "5", "--pretrained", "x.npz", "--iters-first", "100",
                    "--iters", "7", "--seed", "3"]),
    ("track_diag", []), ("track_diag", ["none", "always", "14"]),
    ("lag_probe", []),
    ("lag_probe", ["--frames", "7", "--pretrained", "", "--separate-lr", "--track-iters", "5",
                   "--track-pixels", "123", "--track-lr", "0.01", "--depth-gate", "0.2"]),
    ("accuracy_probe", []),
    ("accuracy_probe", [
        "--frames", "9", "--gt-camera", "--decoder-train", "never", "--no-coarse", "--no-ba",
        "--sync", "strict", "--track-iters", "7", "--track-pixels", "111", "--track-lr", "0.002",
        "--track-wcolor", "0.3", "--no-color-track", "--no-dynamic", "--depth-gate", "0.4",
        "--track-method", "adam", "--gn-prior-r", "0.05", "--gn-prior-t", "0.06", "--tv", "0.01",
        "--ba-min", "2", "--bootstrap", "3", "--separate-lr", "--map-pixels", "500",
        "--map-iters", "30", "--iters-first", "300", "--every-frame", "4",
        "--keyframe-every", "8", "--pretrained", "models/pretrained_decoders.npz", "--seed", "2"]),
    ("perf_breakdown", []), ("perf_breakdown", ["--frames", "9"]),
]


@pytest.mark.parametrize("name,argv", CONFIG_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CONFIG_CASES)])
def test_config_equals_the_script(name, argv, monkeypatch, jax_script):
    want = catch_config(monkeypatch, jax_script, name, argv)
    got = as_fields(port_config(name, argv))
    assert got == as_fields(want["cfg"])
    assert isinstance(port_config(name, argv), tschema.SLAMConfig)


def test_perf_breakdown_bench_is_the_bench_configuration():
    assert perf_breakdown.config(bench=True) == bench.bench_config(sync="strict")


def test_config_cases_change_something():
    """Every non-default case sets some field away from the default."""
    for name, argv in CONFIG_CASES:
        if argv and name not in ("perf_breakdown",):
            assert as_fields(port_config(name, argv)) != as_fields(port_config(name, [])), name


# ---------------------------------------------------------------- program calls
def _caught_calls(monkeypatch, jax_script, name, stubs):
    """Run the script with ``stubs`` (``(owner, attr, fn)``) in place until
    one raises ``_Stop``."""
    for owner, attr, fn in stubs:
        monkeypatch.setattr(owner, attr, fn)
    with pytest.raises(_Stop):
        jax_script(name, ["--iters", "60"] if name == "mapper_step_probe" else [])


def assert_schedule_equal(got, want):
    for field in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)


def assert_setup_equal(s, a):
    """The port's probe inputs against the JAX ``run_schedule`` call's: the
    shapes of the seed-0 map (another generator), and every other value."""
    grids, decoders, cams, masks, bounds, scene_bound, intr, colors, depths, valid, fixed = a
    assert {k: tuple(v.shape) for k, v in s.grids.items()} == {
        k: tuple(v.shape) for k, v in grids.items()}
    for k, v in bounds.items():
        np.testing.assert_allclose(s.bounds[k].numpy(), np.asarray(v), rtol=1e-6)
    np.testing.assert_allclose(s.scene_bound.numpy(), np.asarray(scene_bound), rtol=1e-6)
    np.testing.assert_allclose(s.cams.numpy(), np.asarray(cams), atol=1e-7)
    assert tuple(s.intr) == tuple(intr)
    np.testing.assert_array_equal(s.depths.numpy(), np.asarray(depths))
    assert s.colors.shape == tuple(colors.shape)
    np.testing.assert_array_equal(s.valid, np.asarray(valid))
    np.testing.assert_array_equal(s.fixed, np.asarray(fixed))
    for k, v in masks.items():
        np.testing.assert_array_equal(s.masks[k].numpy(), np.asarray(v))


def test_mapper_step_probe_calls_equal_the_script(monkeypatch, jax_script):
    calls = []

    def run_schedule(*a):
        calls.append(a)
        return a[0], a[1], a[2], a[13], jax.numpy.zeros((len(a[12].iter_idx),))

    def track_frame(*a):
        calls.append(("track",) + a)
        raise _Stop

    _caught_calls(monkeypatch, jax_script, "mapper_step_probe",
                  [(jmapper, "run_schedule", run_schedule), (jtracker, "track_frame", track_frame)])
    a, t = calls[0], calls[-1]
    s = mapper_step_probe.setup("cpu", mapper_step_probe.World())
    assert_setup_equal(s, a[:11])
    np.testing.assert_array_equal(s.colors.numpy(), np.asarray(a[7]))
    mcfg, sched, pcfg = mapper_step_probe.staged_pass(60)
    assert_schedule_equal(sched, a[12])
    assert pcfg._asdict() == a[14]._asdict()
    assert s.rcfg._asdict() == a[15]._asdict()
    # The solve: the first frame, from the identity, 200 pixels x 10.
    assert tuple(t[5]) == tuple(s.intr)
    np.testing.assert_array_equal(np.asarray(t[8]), np.eye(4, dtype=np.float32))
    assert t[10]._asdict() == mapper_step_probe.World().track._asdict()
    assert len(calls) == 1 + 6 + 1  # a warm call and 6 timed ones, then the solve


def test_dispatch_probe_calls_equal_the_script(monkeypatch, jax_script):
    calls = []

    def overlap(*a):
        calls.append(("overlap",) + a)
        return jax.numpy.zeros((a[-1].shape[0],))

    def run_schedule(*a):
        calls.append(("map",) + a)
        return a[0], a[1], a[2], a[13], jax.numpy.zeros((len(a[12].iter_idx),))

    def mapping_loss(*a, **kw):
        calls.append(("loss", kw))
        raise _Stop

    _caught_calls(monkeypatch, jax_script, "dispatch_probe",
                  [(jkf, "keyframe_overlap_percentages", overlap),
                   (jmapper, "run_schedule", run_schedule),
                   (jmapper, "mapping_loss", mapping_loss)])
    kinds = [c[0] for c in calls]
    assert kinds == ["overlap"] * 6 + ["map"] * 12 + ["loss"]
    ov = calls[0]
    s = mapper_step_probe.setup("cpu", mapper_step_probe.World())
    assert tuple(ov[2]) == tuple(s.intr)
    np.testing.assert_array_equal(np.asarray(ov[6]), np.tile(np.eye(4), (64, 1, 1)))
    np.testing.assert_array_equal(np.asarray(ov[4]), np.full((480, 640), 1.5))
    np.testing.assert_array_equal(np.asarray(ov[5]), np.zeros((480, 640, 3)))
    m, mcfg, pcfg = dispatch_probe.probe_config()
    staged, coarse = calls[6][1:], calls[12][1:]
    assert_setup_equal(s, staged[:11])
    for a, is_coarse in ((staged, False), (coarse, True)):
        plan = dispatch_probe.build_stage_plan(m.iters, 0.4, 0.6, m.stage_lr, coarse=is_coarse)
        assert_schedule_equal(dispatch_probe.chunked_schedule(plan, mcfg, m.iters)[0][0], a[12])
        assert pcfg._asdict() == a[14]._asdict()
    kw = calls[-1][1]
    assert (kw["stage"], kw["n_pixels"], kw["w_color_loss"]) == ("color", 1000, 0.2)
    assert kw["rcfg"]._asdict() == s.rcfg._asdict()


# ---------------------------------------------------------------- printed keys
def jax_keys(name) -> set:
    """Every constant key of a dict literal, or of a subscript assignment,
    in the script's source."""
    tree = ast.parse(open(os.path.join(_ROOT, "scripts", f"{name}.py")).read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant):
                    keys.add(t.slice.value)
    return keys


def printed_keys(rec) -> set:
    if isinstance(rec, dict):
        return set(rec) | set().union(*(printed_keys(v) for v in rec.values()))
    if isinstance(rec, list):
        return set().union(*(printed_keys(v) for v in rec))
    return set()


# What a port record holds beyond the script's literal keys (keys the
# script computes), and the script's literal keys it does not print.
EXTRA_KEYS = {
    "saturation_probe": {"middle", "color"},
    "depth_diag": {"middle", "fine", "color"},
    "track_diag": {"base", "10", "50", "90", "99", "loss_at_init", "loss_at_tracked",
                   "loss_at_gt"},
    "mapper_step_probe": {"capture_s"},
}
NOT_PRINTED = {
    "perf_breakdown": {"on"},  # its timer switch
    # capture_s in the place of compile_s; the program's parameter tree
    "mapper_step_probe": {"compile_s", "grids", "decoders", "cams"},
    "dispatch_probe": {"grids", "decoders", "cams"},
}
SECTIONS = {"track", "retrack", "overlap_sel", "frustum_masks", "map_coarse", "map_staged"}


def check_keys(name, recs):
    keys = printed_keys(recs)
    if name == "perf_breakdown":
        sections = set().union(*(set(r["sections"]) for r in recs))
        assert sections <= SECTIONS and {"track", "map_staged"} <= sections
        keys -= sections
    assert keys == (jax_keys(name) - NOT_PRINTED.get(name, set())) | EXTRA_KEYS.get(name, set())


def numbers(rec):
    if isinstance(rec, dict):
        return [x for v in rec.values() for x in numbers(v)]
    if isinstance(rec, (list, tuple)):
        return [x for v in rec for x in numbers(v)]
    return [rec] if isinstance(rec, (int, float)) and not isinstance(rec, bool) else []


def check_finite(recs):
    assert all(math.isfinite(x) for x in numbers(recs)), recs


# ---------------------------------------------------------------- tiny world
def tiny(cfg, schema=tschema):
    """A configuration cut for the CPU: a 48x64 camera (4-pixel tracking
    edges), coarser voxels, 16+8 samples, short budgets."""
    return dataclasses.replace(
        cfg,
        cam=schema.CamConfig(H=48, W=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0),
        grid_len=schema.GridLenConfig(coarse=2.0, middle=0.64, fine=0.32, color=0.32,
                                      bound_divisable=0.32),
        rendering=schema.RenderingConfig(N_samples=16, N_surface=8),
        tracking=dataclasses.replace(cfg.tracking, pixels=min(cfg.tracking.pixels, 64),
                                     iters=min(cfg.tracking.iters, 4), ignore_edge_H=4,
                                     ignore_edge_W=4),
        mapping=dataclasses.replace(cfg.mapping, pixels=min(cfg.mapping.pixels, 128),
                                    iters_first=min(cfg.mapping.iters_first, 20),
                                    iters=min(cfg.mapping.iters, 4)),
    )


TINY_WORLD = mapper_step_probe.World(
    intr=Intrinsics(H=48, W=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0),
    grid=GridConfig(middle_len=0.64, fine_len=0.32, color_len=0.32, bound_divisable=0.32),
    pixels=32, rcfg=RenderConfig(n_samples=8, n_surface=4),
    track=TrackConfig(pixels=32, iters=2, ignore_edge_H=4, ignore_edge_W=4))


@pytest.fixture
def tiny_world(monkeypatch):
    """Every port module's world cut by :func:`tiny`."""
    for mod in MODULES.values():
        if hasattr(mod, "world_config"):
            monkeypatch.setattr(mod, "world_config",
                                lambda *a, **k: tiny(world.world_config(*a, **k)))
    for mod in (mapper_step_probe, dispatch_probe):
        monkeypatch.setattr(mod, "World", lambda: TINY_WORLD)


def run_main(name, argv) -> list:
    """The port module's ``main`` on the CPU: its JSON records on standard
    output (one document, or one per line)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert MODULES[name].main([*argv, "--cpu"]) == 0
    text = out.getvalue().strip()
    try:
        return [json.loads(text)]
    except json.JSONDecodeError:
        return [json.loads(line) for line in text.splitlines()]


@pytest.mark.parametrize("name,argv", [
    ("lag_probe", ["--frames", "4"]),
    ("accuracy_probe", ["--frames", "4", "--depth-psnr"]),
    ("perf_breakdown", ["--frames", "4", "--warm", "1"]),
    ("mapper_step_probe", ["--iters", "3", "--reps", "1"]),
    ("dispatch_probe", []),
])
def test_tiny_records_have_the_script_keys(name, argv, tiny_world):
    recs = run_main(name, argv)
    check_keys(name, recs)
    check_finite(recs)
    if name == "lag_probe":
        rows = recs[0][lag_probe.ROWS_KEY]
        assert [r[0] for r in rows] == [0, 1, 2, 3] and [r[4] for r in rows] == [
            True, False, False, False]
        assert isinstance(recs[0]["ate_rmse_cm"], float)
    if name == "accuracy_probe":
        assert len(recs[0]["t_err_curve_cm"]) == 4 and recs[0]["variant"]["track"] == [
            200, 10, 0.001]
    if name == "mapper_step_probe":
        assert [r["op"] for r in recs] == ["run_schedule", "run_schedule_eager", "track_frame",
                                           "implied_fps"]
        assert all(r.get("capture_s", None) is None for r in recs)  # nothing captured
    if name == "dispatch_probe":
        assert [r["probe"] for r in recs] == [
            "overlap_sel", "run_schedule_staged_60", "run_schedule_coarse_60",
            "scan_lossgrad_color", "scan_lossgrad_adam_color", "scan_lossgrad_coarse"]
        assert all(len(r["ms"]) == 5 for r in recs[:3])


def test_lag_probe_rebuilds_the_systems_warm_start(tiny_world):
    cfg = lag_probe.config()
    slam, reader = lag_probe.build(cfg, 5, 0, "cpu")
    inits = []
    solve = slam._solve

    def recorded(frame, init, td=None):
        inits.append(init.cpu().numpy())
        return solve(frame, init, td)

    slam._solve = recorded
    rec = lag_probe.measure(slam, reader, 5)
    assert len(inits) == 4
    for k, init in enumerate(inits, start=1):
        np.testing.assert_array_equal(rec["warm_starts"][k], init)


def test_perf_breakdown_wrapping_keeps_the_trajectory(tiny_world):
    cfg = perf_breakdown.config()
    rec, wrapped = perf_breakdown.measure(cfg, 6, 1, "cpu")
    reader = SyntheticBoxReader(cfg, n_frames=6)
    plain = NiceSLAM(cfg, reader=reader, device="cpu")
    plain.precompile()
    for f in perf_breakdown.staged_frames(reader, 6, "cpu"):
        plain.step(f)
    for a, b in zip(wrapped.est_c2w, plain.est_c2w, strict=True):
        np.testing.assert_array_equal(a, b)
    for lvl, g in plain.state.grids.items():
        torch.testing.assert_close(wrapped.state.grids[lvl], g, rtol=0, atol=0)
    assert sum(s["total_s"] for s in rec["sections"].values()) <= rec["total_s"]
    assert rec["host_and_dispatch_s"] >= 0
    calls = {k: s["calls"] for k, s in rec["sections"].items()}
    # Frames 1-5 are solved; frame 5 (every 5th) and the last map.
    assert calls["track"] == 5 and calls["map_staged"] == 1 and calls["map_coarse"] == 1


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        MODULES[name].main([])


@pytest.mark.parametrize("name", sorted(MODULES))
def test_imports_no_jax(name):
    """No diagnostic module imports JAX or the JAX package."""
    src = open(MODULES[name].__file__).read() + open(world.__file__).read()
    tree = ast.parse(src)
    for node in ast.walk(tree):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert not any(m.split(".")[0] in ("jax", "niceslam_tpu", "optax") for m in mods)


# ---------------------------------------------------------------- identical state
def jax_state(slam) -> dict:
    return jax.tree_util.tree_map(np.asarray, {
        "grids": slam.state.grids, "decoders": slam.state.decoders, "bounds": slam.bounds,
        "scene_bound": slam.scene_bound})


def port_system(cfg, state, n_frames: int = 2) -> NiceSLAM:
    """A port system on the CPU holding the JAX system's state."""
    slam = NiceSLAM(cfg, reader=SyntheticBoxReader(cfg, n_frames=n_frames), seed=0,
                    device="cpu")
    slam.state.grids = convert.grids_from_jax(state["grids"], "cpu")
    slam.state.decoders = convert.decoders_from_jax(state["decoders"], "cpu")
    slam._set_bounds(*convert.bounds_from_jax(state["bounds"], state["scene_bound"], "cpu"))
    return slam


@pytest.fixture
def caught_system(monkeypatch):
    """The JAX systems the scripts build, each kept; with ``shrink`` their
    configurations are cut by :func:`tiny`."""
    systems = []

    class Kept(jsystem.NiceSLAM):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            systems.append(self)

    monkeypatch.setattr(jsystem, "NiceSLAM", Kept)

    def shrink():
        real = jschema.SLAMConfig
        monkeypatch.setattr(jschema, "SLAMConfig", lambda **kw: tiny(real(**kw), jschema))

    return systems, shrink


def assert_records_close(got, want, rtol, atol, path="record"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_records_close(got[k], want[k], rtol, atol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for k, (g, w) in enumerate(zip(got, want)):
            assert_records_close(g, w, rtol, atol, f"{path}[{k}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=rtol, abs_tol=atol), f"{path}: {got} vs {want}"
    else:
        assert got == want, path


def normalised(rec):
    """A record as the JSON that prints it reads back (string keys, lists)."""
    return json.loads(json.dumps(rec))


@pytest.mark.parametrize("path", ["models/pretrained_decoders.npz", "none"])
def test_saturation_probe_equals_the_script(path, jax_script, caught_system, monkeypatch):
    """At full width. The script's gradient norm is a float32 sum over the
    middle grid's ~163,000 entries, off by up to ~6e-5 of itself (measured
    here with the random decoders); the port sums in float64, so the
    script's ``jnp.linalg.norm`` is replaced by a float64 norm of the same
    gradient for the comparison."""
    systems, _ = caught_system
    monkeypatch.setattr(jax.numpy.linalg, "norm",
                        lambda g: np.linalg.norm(np.asarray(g, np.float64)))
    want = json.loads(jax_script("saturation_probe", [path], unrounded=True))
    cfg = saturation_probe.config(path)
    slam = port_system(cfg, jax_state(systems[0]), n_frames=1)
    got = saturation_probe.measure(slam, saturation_probe.points(cfg, "cpu"))
    check_keys("saturation_probe", [saturation_probe.rounded(got)])
    for stage in saturation_probe.STAGES:
        for k, w in want[stage].items():
            if k == "docc_dmiddlegrid_norm":
                assert math.isclose(got[stage][k], w, rel_tol=2e-5), (stage, k, got[stage][k], w)
            else:
                assert abs(got[stage][k] - w) <= 1e-5, (stage, k, got[stage][k], w)


def test_bias_probe_equals_the_script(jax_script, caught_system):
    systems, shrink = caught_system
    shrink()
    want = json.loads(jax_script("bias_probe", unrounded=True))
    cfg = tiny(bias_probe.config())
    slam = port_system(cfg, jax_state(systems[0]))
    got = bias_probe.measure(slam, slam.reader[0])
    check_keys("bias_probe", [bias_probe.rounded(got)])
    assert_records_close(normalised(got), want, VALUE_RTOL, VALUE_ATOL)


def test_depth_diag_equals_the_script(jax_script, caught_system):
    systems, shrink = caught_system
    shrink()
    argv = ["--frames", "2", "--iters-first", "20", "--iters", "4"]
    want = json.loads(jax_script("depth_diag", argv, unrounded=True))
    cfg = tiny(depth_diag.config(iters_first=20, iters=4))
    slam = port_system(cfg, jax_state(systems[0]))
    got = depth_diag.measure(slam, slam.reader, [0, 1, 1])
    check_keys("depth_diag", depth_diag.rounded(got))
    assert_records_close(normalised(got), want, VALUE_RTOL, VALUE_ATOL)


def track_draws(intr):
    """The JAX script's draws: the GN solve's from key 5 (one batch per
    iteration) and the losses' from key 123, as ``(i, j)`` tensors."""
    jr = jax.random
    tc = track_diag.TCFG

    def ij(key):
        kj, ki = jr.split(key)
        j = jr.randint(kj, (tc.pixels,), tc.ignore_edge_H, intr.H - tc.ignore_edge_H)
        i = jr.randint(ki, (tc.pixels,), tc.ignore_edge_W, intr.W - tc.ignore_edge_W)
        return tuple(torch.from_numpy(np.asarray(x, np.int64)) for x in (i, j))

    solve = [ij(jr.fold_in(jr.PRNGKey(5), it)) for it in range(tc.iters)]
    return solve, ij(jr.PRNGKey(123))


def test_track_diag_equals_the_script(jax_script, caught_system):
    systems, shrink = caught_system
    shrink()
    want = json.loads(jax_script("track_diag", unrounded=True))
    cfg = tiny(track_diag.config())
    slam = port_system(cfg, jax_state(systems[0]), n_frames=12)
    solve, loss = track_draws(slam.intr)
    got = track_diag.measure(slam, slam.reader, track_pixels=solve, loss_pixels=loss)
    check_keys("track_diag", [normalised(track_diag.rounded(got))])
    base_got, base_want = got.pop("base"), want.pop("base")
    assert_records_close(normalised(got), want, VALUE_RTOL, VALUE_ATOL)
    assert_records_close(base_got, base_want, TRACK_RTOL, TRACK_ATOL, "base")
