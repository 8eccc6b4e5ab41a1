"""The reference envelope's mechanisms on the CPU, held to the JAX package:

- (a) the port's fixture writer (``niceslam_tpu_torch.make_fixture_dataset``,
  run with JAX blocked) against ``scripts/make_fixture_dataset.py`` on every
  layout: the same files, byte-equal text and EXR, equal decoded images;
- (b) a keyframe ring that wraps twice: the port's keyframe bookkeeping and
  window choice against the JAX system's on the same frames, with the
  mapping passes stubbed out in both (what a pass would do does not enter
  the bookkeeping); the colour refine's window too;
- (c) ``mapping.lock_after`` on one device: the event counts and the update
  masks on the same injected frustum masks; a locked voxel takes no update
  in the port's real mapping pass;
- (d) a checkpoint taken after the ring wrapped restores the keyframe DB's
  host mirrors and continues as the run did; both packages restore with
  zero lock counts (ROADMAP queue 3 item 2);
- (e) ``niceslam_tpu_torch.scaling_bench`` with ``--cpu 2`` and
  ``--real-1x1``, with the JAX script's keys;
- (f) the multi-process demo through its local launcher.
"""
import glob
import json
import os
import subprocess
import sys
import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niceslam_tpu.config.schema import load_config as jload_config
from niceslam_tpu.slam import system as jsystem
from niceslam_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint
from niceslam_tpu_torch import scaling_bench
from niceslam_tpu_torch.config.schema import load_config
from niceslam_tpu_torch.parallel.runtime import free_port
from niceslam_tpu_torch.slam.system import NiceSLAM
from niceslam_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(_ROOT, "configs", "cofusion.yaml")
LAYOUTS = ("cofusion", "replica", "tumrgbd", "scannet")
FIXTURE_ARGS = ["--frames", "3", "--H", "48", "--W", "64", "--arc", "2.0"]
# A Python that cannot import JAX or the JAX package.
NO_JAX = ("import sys, runpy; sys.modules['jax'] = None; sys.modules['niceslam_tpu'] = None; "
          "sys.argv = ['make_fixture_dataset'] + sys.argv[1:]; "
          "runpy.run_module('niceslam_tpu_torch.make_fixture_dataset', run_name='__main__')")


def _env():
    return dict(os.environ, PYTHONPATH=_ROOT, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


# The port's writer with its frames over 2 spawned processes.
TWO_WORKERS = ("import sys; from niceslam_tpu_torch.make_fixture_dataset import write_layout; "
               "write_layout('cofusion', sys.argv[1], 3, 24, 32, 18.0, arc=2.0, workers=2)")
# Every module of the port, and the smoke, imported with JAX blocked.
IMPORT_ALL = ("import sys, pkgutil, importlib; sys.modules['jax'] = None; "
              "sys.modules['niceslam_tpu'] = None; import niceslam_tpu_torch as p; "
              "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'niceslam_tpu_torch.')]; "
              "[importlib.import_module(m) for m in mods + ['chip_smoke']]; print(len(mods))")


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every subprocess of this file, started at once so that they run
    beside the in-process tests: both writers on every layout, the port's
    writer with two workers, the import check, the scaling bench on two CPU
    ranks and the multi-process demo's launcher."""
    root = tmp_path_factory.mktemp("launched")
    cmds = {}
    for layout in LAYOUTS:
        for who, cmd in (("jax", [os.path.join(_ROOT, "scripts", "make_fixture_dataset.py")]),
                         ("port", ["-c", NO_JAX])):
            cmds[who, layout] = [sys.executable, *cmd, "--layout", layout,
                                 "--out", str(root / who / layout), *FIXTURE_ARGS]
    cmds["workers"] = [sys.executable, "-c", TWO_WORKERS, str(root / "workers")]
    cmds["imports"] = [sys.executable, "-c", IMPORT_ALL]
    cmds["scaling"] = [sys.executable, "-m", "niceslam_tpu_torch.scaling_bench", "--cpu", "2",
                       "--pixels", "32", "--iters", "2"]
    cmds["multihost"] = [os.path.join(_ROOT, "niceslam_tpu_torch", "run_multihost_cpu.sh"),
                         "--devices-per-process", "1", "--iters", "2", "--steps", "2"]
    env = dict(_env(), PORT=str(free_port()), N="2")
    procs = {k: subprocess.Popen(c, cwd=_ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, c in cmds.items()}
    done = {}

    def result(key):
        """``(returncode, stdout, stderr)`` of one of them, waited for."""
        if key not in done:
            try:
                out, err = procs[key].communicate(timeout=300)
            finally:
                if procs[key].poll() is None:
                    procs[key].kill()
                    procs[key].communicate()
            done[key] = (procs[key].returncode, out, err)
        return done[key]

    yield root, result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


# ---------------------------------------------------------------------- (a)
def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"),
                                                              recursive=True)
                  if os.path.isfile(p))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fixture_writer_matches_the_jax_script(launched, layout):
    """The same file names; trajectory, list and pose text and EXR depth
    byte for byte; PNG and JPEG decoded to the same arrays (the port writes
    PNG with ``io/png.py``, so only the PNG bytes may differ)."""
    root, result = launched
    for who in ("jax", "port"):
        rc, out, err = result((who, layout))
        assert rc == 0, (who, err[-2000:])
        assert out.strip() == f"{layout} fixture: 3 frames -> {root / who / layout}"
    jax_root, port_root = root / "jax" / layout, root / "port" / layout
    names = _files(jax_root)
    assert names == _files(port_root) and len(names) >= 6
    for name in names:
        want = (jax_root / name).read_bytes()
        got = (port_root / name).read_bytes()
        if name.endswith((".txt", ".exr", ".jpg")):
            assert got == want, name
        else:
            assert name.endswith(".png")
            a = cv2.imread(str(jax_root / name), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(port_root / name), cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_fixture_workers_write_the_same_bytes(launched, tmp_path):
    """Frames split over spawned processes give the same files."""
    from niceslam_tpu_torch.make_fixture_dataset import write_layout

    root, result = launched
    rc, _, err = result("workers")
    assert rc == 0, err[-2000:]
    write_layout("cofusion", str(tmp_path), 3, 24, 32, 18.0, arc=2.0, workers=1)
    names = _files(tmp_path)
    assert names == _files(root / "workers") and len(names) == 7
    for name in names:
        assert (tmp_path / name).read_bytes() == (root / "workers" / name).read_bytes()


@pytest.mark.parametrize("workers", [1, 2])
def test_fixture_writer_keeps_what_it_wrote(tmp_path, workers):
    """With ``keep`` the writer returns the colours and depths that its
    files decode to, from one process or from spawned ones."""
    from niceslam_tpu_torch.io import exr_write
    from niceslam_tpu_torch.make_fixture_dataset import write_layout

    poses, colors, depths = write_layout("cofusion", str(tmp_path), 3, 24, 32, 18.0,
                                         arc=2.0, workers=workers, keep=True)
    assert len(poses) == len(colors) == len(depths) == 3
    for k in range(3):
        rgb = cv2.imread(str(tmp_path / "colour" / f"Color0{k:03d}.png"), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(rgb[..., ::-1], colors[k])
        assert depths[k].dtype == np.float32 and depths[k].shape == (24, 32)
        exr = tmp_path / "ref.exr"
        exr_write.write_exr(str(exr), depths[k])
        assert exr.read_bytes() == (tmp_path / "depth_noise" / f"Depth0{k:03d}.exr").read_bytes()


def test_the_port_and_the_smoke_import_with_jax_blocked(launched):
    """Every module of the port, and ``chip_smoke.py``, imports in a Python
    where ``jax`` and ``niceslam_tpu`` cannot be imported (their sources are
    read for such imports by ``test_torch_packed.test_port_imports_no_jax``)."""
    rc, out, err = launched[1]("imports")
    assert rc == 0, err[-3000:]
    assert int(out.strip()) > 40


# ------------------------------------------------------------- (b), (c), (d)
TINY = {"dataset": "synthetic", "cam.H": 24, "cam.W": 32, "cam.fx": 24.0, "cam.fy": 24.0,
        "cam.cx": 16.0, "cam.cy": 12.0, "mapping.pixels": 48, "mapping.iters": 2,
        "mapping.iters_first": 2, "tracking.gt_camera": True, "mapping.BA": False,
        "mapping.every_frame": 1, "mapping.keyframe_every": 2, "mapping.max_keyframes": 3,
        "mapping.mapping_window_size": 5, "mapping.color_refine": True, "verbose": False}
# Keyframes at frames 0, 2, .., 12 (12 is also the last but one): 7 in a
# ring of 3 slots, which wraps twice; frame 13 runs the colour refine.
N_FRAMES = 14


def _overlap(idx: int, cap: int) -> np.ndarray:
    """Injected overlap percentages for the selection at frame ``idx``:
    some slots without overlap."""
    rng = np.random.default_rng(idx)
    return (rng.uniform(size=cap) * (rng.uniform(size=cap) > 0.35)).astype(np.float32)


def _frustum(count: int, grids) -> dict:
    """Injected frustum masks of the ``count``-th call (0/1 float)."""
    rng = np.random.default_rng(100 + count)
    return {lvl: (rng.uniform(size=tuple(grids[lvl].shape[:3]) + (1,)) > 0.4)
            .astype(np.float32) for lvl in sorted(grids)}


class Recorder:
    """What each package's system did: per pass the window's signature,
    valid slots, colours and update masks; per frame the ring's mirrors."""

    def __init__(self):
        self.passes, self.frames, self.slots, self.frustum_calls = [], [], [], 0

    def frame(self, slam, idx):
        self.frames.append((slam._kf_count, slam._kf_slot_frame.tolist(),
                            [k for k in range(idx + 1) if slam._is_keyframe(k)]))


def _port_system(overrides, rec: Recorder, inject_frustum=False):
    slam = NiceSLAM(load_config(CONFIG, overrides={**TINY, **overrides}), device="cpu")
    slam.n_imgs = N_FRAMES
    window_slots = slam._window_slots

    def slots(idx, coarse, salt=0):
        if slam._overlap_pct is not None:
            slam._overlap_pct = types.SimpleNamespace(
                numpy=lambda: _overlap(idx, slam.state.keyframes.capacity))
        out = window_slots(idx, coarse, salt)
        rec.slots.append((idx, coarse, salt, list(out[0])))
        return out

    def map_pass(signature, plan, mcfg, pcfg, grids, masks, decoders, cams, colors, depths,
                 valid, fixed, device=None):
        rec.passes.append(dict(
            signature=signature, frustum=pcfg.frustum, valid=np.asarray(valid),
            colors=colors.numpy().copy(),
            masks={k: v.numpy().copy() for k, v in masks.items()} if pcfg.frustum else None))
        return grids, decoders, cams, torch.zeros((sum(n for _, n, _ in plan),))

    slam._window_slots, slam._map_pass = slots, map_pass
    if inject_frustum:
        def frustum_masks(poses, pose_valid, depths, intr, bounds, grids):
            rec.frustum_calls += 1
            return {k: torch.from_numpy(v) for k, v in
                    _frustum(rec.frustum_calls - 1, grids).items()}
        slam._programs.frustum_masks = frustum_masks
    return slam


def _jax_system(overrides, rec: Recorder, monkeypatch, inject_frustum=False):
    slam = jsystem.NiceSLAM(jload_config(CONFIG, overrides={**TINY, **overrides}))
    slam.n_imgs = N_FRAMES
    window_slots = slam._window_slots

    def slots(idx, coarse, salt=0):
        if slam._overlap_pct is not None:
            slam._overlap_pct = _overlap(idx, slam.state.keyframes.capacity)
        out = window_slots(idx, coarse, salt=salt)
        rec.slots.append((idx, coarse, salt, list(out[0])))
        return out

    def run_schedule(grids, decoders, cams, masks, bounds, scene_bound, intr, colors, depths,
                     valid, fixed, key, chunk, opt_state, pcfg, rcfg):
        rec.passes.append(dict(
            signature=(colors.shape[0],),
            frustum=pcfg.frustum, valid=np.asarray(valid), colors=np.asarray(colors),
            masks={k: np.asarray(v) for k, v in masks.items()} if pcfg.frustum else None))
        return grids, decoders, cams, opt_state, jnp.zeros((len(chunk.stage_ids),))

    slam._window_slots, slam.run_schedule_fn = slots, run_schedule
    if inject_frustum:
        def frustum_masks(poses, valid, depths, intr, bounds, grids):
            rec.frustum_calls += 1
            return {k: jnp.asarray(v) for k, v in _frustum(rec.frustum_calls - 1, grids).items()}
        monkeypatch.setattr(jsystem.kf_mod, "frustum_masks_for_levels", frustum_masks)
    return slam


def _drive(slam, rec: Recorder, frames, counts=None):
    for k in frames:
        slam.step(slam.reader[k])
        rec.frame(slam, k)
        if counts is not None:
            counts.append({lvl: np.asarray(c).copy() for lvl, c in slam._obs_counts.items()})


def _same_passes(port: Recorder, jax_: Recorder):
    assert len(port.passes) == len(jax_.passes) > 0
    for k, (p, j) in enumerate(zip(port.passes, jax_.passes)):
        assert p["signature"][0] == j["signature"][0], k
        assert p["frustum"] == j["frustum"], k
        np.testing.assert_array_equal(p["valid"], j["valid"], err_msg=f"pass {k}")
        # The window's images name its keyframes: the same slots were chosen.
        np.testing.assert_array_equal(p["colors"], j["colors"], err_msg=f"pass {k}")
        if p["masks"] is not None:
            for lvl in p["masks"]:
                np.testing.assert_array_equal(p["masks"][lvl], j["masks"][lvl],
                                              err_msg=f"pass {k} {lvl}")


@pytest.mark.parametrize("method", ["global", "overlap"])
def test_keyframe_ring_wraps_twice_as_in_jax(method, monkeypatch):
    """Seven keyframes in three slots: after every frame the count, each
    slot's frame and which frames are keyframes equal the JAX system's;
    every pass selects the same keyframes (global selection from the same
    numpy seed; overlap selection on the same injected percentages), the
    colour refine's doubled window included."""
    over = {"mapping.keyframe_selection_method": method}
    port, jax_ = Recorder(), Recorder()
    p = _port_system(over, port)
    j = _jax_system(over, jax_, monkeypatch)
    _drive(p, port, range(N_FRAMES))
    _drive(j, jax_, range(N_FRAMES))
    assert port.frames == jax_.frames
    assert port.slots == jax_.slots
    count, slot_frames, keyframes = port.frames[-1]
    assert count == 7 and keyframes == [8, 10, 12] and sorted(slot_frames) == [8, 10, 12]
    # Where the ring first reused a slot: the fourth keyframe, frame 6.
    assert [f[0] for f in port.frames][5:7] == [3, 4]
    _same_passes(port, jax_)
    refine = [r for r in port.passes if r["signature"][1]]
    assert len(refine) == 5 and all(r["colors"].shape[0] == 10 for r in refine)
    assert all(r["valid"].sum() == 4 for r in refine)  # 3 keyframes + the frame


def test_lock_after_counts_and_masks_as_in_jax(monkeypatch):
    """``lock_after`` 2 on injected frustum masks: after every event the
    per-level counts equal the JAX system's, and so does every pass's
    update mask (the frustum mask with the locked voxels taken out). The
    colour refine's passes run without frustum selection and so apply no
    mask, the locks included, in both packages (ROADMAP queue 3 item 7)."""
    over = {"mapping.lock_after": 2, "mapping.keyframe_selection_method": "global"}
    port, jax_ = Recorder(), Recorder()
    pc, jc = [], []
    p = _port_system(over, port, inject_frustum=True)
    j = _jax_system(over, jax_, monkeypatch, inject_frustum=True)
    _drive(p, port, range(8), pc)
    _drive(j, jax_, range(8), jc)
    # The coarse pass asks for masks too (its update mask; only the staged
    # pass's masks count).
    assert port.frustum_calls == jax_.frustum_calls == 15
    for k, (a, b) in enumerate(zip(pc, jc)):
        assert a.keys() == b.keys()
        for lvl in a:
            np.testing.assert_array_equal(a[lvl], b[lvl], err_msg=f"frame {k} {lvl}")
    assert all(float(c.max()) >= 2 for c in pc[-1].values())
    _same_passes(port, jax_)
    # Injected masks are 60 % ones; after 7 events most voxels are locked.
    last = port.passes[-1]["masks"]
    assert sum(float(m.mean()) for m in last.values()) / len(last) < 0.3
    # The last frame's colour refine: no update mask in either package.
    p.n_imgs = j.n_imgs = 9
    _drive(p, port, [8])
    _drive(j, jax_, [8])
    assert [r["frustum"] for r in port.passes[-5:]] == [False] * 5
    assert [r["frustum"] for r in jax_.passes[-5:]] == [False] * 5


def test_a_locked_voxel_takes_no_update_in_the_mapping_pass():
    """The port's real mapping pass (strict, lock_after 1): from the second
    event on, the voxels that earlier events saw keep their grid values bit
    for bit while the others move."""
    cfg = load_config(CONFIG, overrides={**TINY, "mapping.lock_after": 1,
                                         "mapping.color_refine": False,
                                         "mapping.iters_first": 4, "mapping.iters": 4})
    slam = NiceSLAM(cfg, device="cpu")
    slam.n_imgs = 3
    slam.step(slam.reader[0])
    for k in (1, 2):
        locked = {lvl: c[..., 0] >= 1 for lvl, c in slam._obs_counts.items()}
        before = {lvl: g.clone() for lvl, g in slam.state.grids.items()}
        slam.step(slam.reader[k])
        moved = 0
        for lvl, g in slam.state.grids.items():
            assert torch.equal(g[locked[lvl]], before[lvl][locked[lvl]]), (k, lvl)
            moved += int((g[~locked[lvl]] != before[lvl][~locked[lvl]]).sum())
        assert int(sum(m.sum() for m in locked.values())) > 0 and moved > 0


def test_checkpoint_after_the_wrap_restores_and_continues(tmp_path, monkeypatch):
    """A checkpoint at frame 9, after the ring wrapped: a fresh system's
    restore holds the DB's host mirrors, and the rest of the run keeps the
    bookkeeping and selections of the run that went on. With ``lock_after``,
    both packages restore with every lock count at zero, though the saved
    run had counted: the checkpoints hold no counts (ROADMAP queue 3 item
    2)."""
    over = {"mapping.lock_after": 2, "mapping.keyframe_selection_method": "global"}
    run = Recorder()
    p = _port_system(over, run, inject_frustum=True)
    _drive(p, run, range(10))
    calls = run.frustum_calls
    ck = str(tmp_path / "port" / "frame_000009")
    save_checkpoint(ck, p.state, p.est_c2w, p.gt_c2w, 9, bounds=p.bounds,
                    scene_bound=p.scene_bound)
    n_before = len(run.slots)
    _drive(p, run, range(10, N_FRAMES))

    resumed = Recorder()
    q = _port_system(over, resumed, inject_frustum=True)
    resumed.frustum_calls = calls  # the masks the run went on with
    assert q.restore(ck) == 10
    assert q._kf_count == 5 and q._kf_count == run.frames[9][0]
    assert q._kf_slot_frame.tolist() == run.frames[9][1]
    assert all(float(c.abs().max()) == 0 for c in q._obs_counts.values())
    assert any(float(c.max()) > 0 for c in p._obs_counts.values())
    _drive(q, resumed, range(10, N_FRAMES))
    assert resumed.frames == run.frames[10:]
    assert resumed.slots == run.slots[n_before:]

    jrec = Recorder()
    j = _jax_system(over, jrec, monkeypatch, inject_frustum=True)
    _drive(j, jrec, range(10))
    assert any(float(c.max()) > 0 for c in j._obs_counts.values())
    jck = str(tmp_path / "jax" / "frame_000009")
    jsave_checkpoint(jck, j.state, j.est_c2w, j.gt_c2w, 9, bounds=j.bounds,
                     scene_bound=j.scene_bound)
    j2 = _jax_system(over, Recorder(), monkeypatch)
    assert j2.restore(jck) == 10 and j2._kf_count == run.frames[9][0]
    assert j2._kf_slot_frame.tolist() == run.frames[9][1]
    assert all(float(jnp.abs(c).max()) == 0 for c in j2._obs_counts.values())


# ---------------------------------------------------------------------- (e)
SCALING_KEYS = ["mesh_devices", "pixels", "iters", "t_step_s", "scaling_efficiency", "mode",
                "platform"]


def test_scaling_bench_on_two_cpu_ranks(launched):
    """``--cpu 2``: a line for 1 and for 2 ranks with the JAX script's keys
    (weak scaling: twice the pixels on 2)."""
    rc, out, err = launched[1]("scaling")
    assert rc == 0, err[-3000:]
    rows = [json.loads(line) for line in out.strip().splitlines()]
    assert [list(r) for r in rows] == [SCALING_KEYS] * 2
    assert [(r["mesh_devices"], r["pixels"], r["mode"], r["platform"]) for r in rows] == [
        (1, 32, "weak", "cpu"), (2, 64, "weak", "cpu")]
    assert rows[0]["scaling_efficiency"] == 1.0
    assert all(r["t_step_s"] > 0 and r["scaling_efficiency"] > 0 for r in rows)


def test_scaling_bench_refuses_more_ranks_than_it_has():
    with pytest.raises(ValueError, match=r"\[4\] need more ranks"):
        scaling_bench.main(["--cpu", "2", "--devices", "1", "4"])


def test_scaling_bench_real_1x1_matches_the_unsharded_program(capsys):
    """``--real-1x1``: the 1 x 1 map-sharded program (its segments) and the
    unsharded program print their rows and the overhead with the JAX keys,
    and their losses agree within ``tests/test_torch_parallel.py``'s
    tolerances (rtol and atol 2e-4)."""
    out = scaling_bench.real_1x1(pixels=32, iters=2, cpu=True)
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [list(r) for r in lines] == [
        ["prog", "pixels", "iters", "t_step_s", "sentinel", "platform"]] * 2 + [
        ["real_chip_1x1_overhead", "platform"]]
    assert [r["prog"] for r in lines[:2]] == ["unsharded", "sharded_1x1"]
    a, b = out["unsharded"]["losses"], out["sharded_1x1"]["losses"]
    assert a.shape == b.shape == (2,) and np.isfinite(a).all()
    np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4)
    assert abs(lines[0]["sentinel"] - lines[1]["sentinel"]) <= 2e-4 * abs(lines[0]["sentinel"])


# ---------------------------------------------------------------------- (f)
def test_multihost_demo_through_its_launcher(launched):
    """Two local CPU processes of the demo (one rank each, map 2): exit 0,
    and process 0 prints its line with the JAX demo's keys."""
    rc, out, err = launched[1]("multihost")
    assert rc == 0, err[-3000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == ["multihost", "processes", "global_devices", "mesh", "finite",
                         "loss_first", "loss_last", "s_per_mapping_step"]
    assert rec["processes"] == 2 and rec["global_devices"] == 2
    assert rec["mesh"] == {"map": 2, "kf": 1} and rec["finite"]
    assert "OK (2 processes)" in err
