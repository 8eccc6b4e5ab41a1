"""The port's sweep (``niceslam_tpu_torch/accuracy_sweep.py``) against the
JAX package's ``scripts/accuracy_sweep.py`` (loaded by path): the same
defaults and variant parser, every key on the same configuration field
(both ``run_one`` s caught, through stubs of their reader and system, where
they build the run), a tiny CPU variant's record with the JAX record's
keys, and a non-zero exit when a variant fails."""
import ast
import dataclasses
import importlib.util
import json
import os

import pytest

import niceslam_tpu.io.datasets.synthetic as jsynthetic
import niceslam_tpu.slam.system as jsystem
from niceslam_tpu_torch import accuracy_sweep as sweep
from niceslam_tpu_torch.config.schema import CamConfig, GridLenConfig

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_SWEEP = os.path.join(_ROOT, "scripts", "accuracy_sweep.py")


def _load_jax_sweep():
    spec = importlib.util.spec_from_file_location("jax_accuracy_sweep", _JAX_SWEEP)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsweep = _load_jax_sweep()


class _Stop(Exception):
    pass


def caught_run(run_one, v, reader_owner, system_owner, monkeypatch) -> dict:
    """What ``run_one(v)`` builds its run from: the config and frame count
    its reader gets and the seed its system gets (which stops it)."""
    seen = {}

    class Reader:
        def __init__(self, cfg, n_frames):
            seen.update(cfg=dataclasses.asdict(cfg), n_frames=n_frames)

    def system(cfg, reader, seed, **kw):
        seen.update(system_cfg=dataclasses.asdict(cfg), seed=seed)
        raise _Stop

    monkeypatch.setattr(reader_owner, "SyntheticBoxReader", Reader)
    monkeypatch.setattr(system_owner, "NiceSLAM", system)
    with pytest.raises(_Stop):
        run_one(v)
    return seen


def test_defaults_equal_jax():
    assert sweep.DEFAULTS == jsweep.DEFAULTS
    assert [type(v) for v in sweep.DEFAULTS.values()] == [
        type(v) for v in jsweep.DEFAULTS.values()]


SPECS = ["base", "a:seed=3", "b:method=adam:tv=0.01:fs=3", "c:pt=r6:pretrained=0",
         "d:frames=12:iters=5.0:gate=0.25", "e:cs=0:use_color=0:retrack=1:lock=2",
         "f:doff=0.05:nsurf=8:sband=0.1:bi=300:bootstrap=5"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_variant_equals_jax(spec):
    got, want = sweep.parse_variant(spec), jsweep.parse_variant(spec)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


def test_parse_variant_refuses_an_unknown_key_as_jax_does():
    for mod in (sweep, jsweep):
        with pytest.raises(KeyError, match="unknown sweep key"):
            mod.parse_variant("x:nope=1")


def other_value(key):
    """A value of ``key`` other than its default."""
    d = sweep.DEFAULTS[key]
    if isinstance(d, str):
        return {"method": "adam", "pt": "r6"}[key]
    if isinstance(d, int) and d in (0, 1):
        return 1 - d
    return type(d)(d * 2 + 3)


@pytest.mark.parametrize("key", sorted(sweep.DEFAULTS))
def test_each_key_sets_the_jax_field(key, monkeypatch):
    spec = f"v:{key}={other_value(key)}"
    got = caught_run(sweep.run_one, sweep.parse_variant(spec), sweep, sweep, monkeypatch)
    want = caught_run(jsweep.run_one, jsweep.parse_variant(spec), jsynthetic, jsystem,
                      monkeypatch)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    base = caught_run(sweep.run_one, sweep.parse_variant("v"), sweep, sweep, monkeypatch)
    if key not in ("depth_psnr",):
        assert got != base, f"{key} changes nothing"


def shrunk(cfg):
    """The sweep's world cut for the CPU: a 24x32 camera (2-pixel edges),
    coarse voxels, 8+4 samples."""
    return dataclasses.replace(
        cfg, bound=((-2.2, 2.2),) * 3,
        cam=CamConfig(H=24, W=32, fx=20.0, fy=20.0, cx=16.0, cy=12.0),
        tracking=dataclasses.replace(cfg.tracking, ignore_edge_H=2, ignore_edge_W=2),
        grid_len=GridLenConfig(coarse=1.5, middle=0.5, fine=0.25, color=0.25,
                               bound_divisable=0.25),
        rendering=dataclasses.replace(cfg.rendering, N_samples=8, N_surface=4),
    )


def jax_record_keys():
    """The keys of the JAX sweep's record with ``depth_psnr``, read from its
    source: ``run_one``'s ``out`` and what it and ``main`` add to a record
    (``main``'s error record aside)."""
    tree = ast.parse(open(_JAX_SWEEP).read())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    keys = []
    for fn, var in (("run_one", "out"), ("main", "rec")):
        for node in ast.walk(fns[fn]):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            t = node.targets[0]
            if (fn == "run_one" and isinstance(t, ast.Name) and t.id == var
                    and isinstance(node.value, ast.Dict)):
                keys += [k.value for k in node.value.keys]
            elif (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                  and t.value.id == var):
                keys.append(t.slice.value)
    return keys


def test_tiny_variant_record_has_the_jax_keys(tmp_path, capsys, monkeypatch):
    config = sweep.sweep_config
    monkeypatch.setattr(sweep, "sweep_config", lambda v: shrunk(config(v)))
    out = tmp_path / "sweep.jsonl"
    spec = ("t:frames=3:iters=2:pixels=16:map_iters=2:map_pixels=32:iters_first=4:"
            "every=2:window=2:kf_every=2:depth_psnr=1")
    assert sweep.main(["--cpu", "--out", str(out), spec]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(rec) == jax_record_keys()
    assert "error" not in rec
    assert rec["frames"] == 3 and len(rec["curve_cm"]) == 1
    assert rec["variant"] == {k: v for k, v in sorted(sweep.parse_variant(spec).items())
                              if k != "name"}
    assert json.loads(out.read_text()) == rec


def test_a_failing_variant_exits_non_zero(capsys):
    assert sweep.main(["--cpu", "bad:method=bogus"]) == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["name"] == "bad" and "unknown tracking.method" in rec["error"]


def test_main_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the sweep would run for real")
    with pytest.raises(RuntimeError, match="--cpu"):
        sweep.main(["base"])
