"""The port's run loop on the CPU: the YAML config loader against the JAX
package's, the frame prefetcher, checkpoint / resume, and the command line
(``python -m niceslam_tpu_torch``) on a tiny synthetic run."""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from niceslam_tpu.config.schema import load_config as jload_config
from niceslam_tpu_torch import __main__ as cli
from niceslam_tpu_torch.config.schema import load_config
from niceslam_tpu_torch.io.datasets.base import Frame
from niceslam_tpu_torch.io.datasets.synthetic import SyntheticBoxReader
from niceslam_tpu_torch.io.prefetch import Prefetcher
from niceslam_tpu_torch.models.decoders import tree_leaves
from niceslam_tpu_torch.parallel.runtime import setup_runtime
from niceslam_tpu_torch.slam.system import NiceSLAM
from niceslam_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

from test_torch_slam import tiny_config

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(_ROOT, "configs", "*.yaml")))
OVERRIDES = {
    "sync_method": "async", "tracking.method": "adam", "dataset": "synthetic",
    "tracking.lr": 0.01, "mapping.stage.color.decoders_lr": 0.5,
    "meshing.clean_mesh": False, "parallel.kf": 2,
}


@pytest.mark.parametrize("overrides", [None, OVERRIDES], ids=["plain", "overrides"])
@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_jax(path, overrides):
    got = load_config(path, overrides=dict(overrides) if overrides else None)
    want = jload_config(path, overrides=dict(overrides) if overrides else None)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_unknown_config_key_raises():
    path = os.path.join(_ROOT, "configs", "cofusion.yaml")
    for load in (load_config, jload_config):
        with pytest.raises(KeyError, match="no_such_key"):
            load(path, overrides={"tracking.no_such_key": 1})


def test_what_one_device_cannot_run_is_refused():
    """A ``parallel`` block whose mesh needs more ranks than one process
    raises in the runtime (``NiceSLAM`` itself takes any block); a dataset
    without a reader raises, naming the readers there are."""
    cfg = dataclasses.replace(tiny_config(), parallel=load_config(
        os.path.join(_ROOT, "configs", "apartment_multihost.yaml"),
        overrides={"parallel.map": 2}).parallel)
    NiceSLAM(cfg, reader=SyntheticBoxReader(cfg, n_frames=2), device="cpu")
    with pytest.raises(ValueError, match="does not fit 1 rank"):
        setup_runtime(cfg, cpu=True)
    with pytest.raises(KeyError, match="unknown dataset 'kitti'.*'cofusion'"):
        NiceSLAM(dataclasses.replace(tiny_config(), dataset="kitti"), device="cpu")


class _Reader:
    """Frames whose color holds their index; ``fail_at`` raises there."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise OSError(f"cannot decode frame {i}")
        return Frame(idx=i, color=np.full((2, 2, 3), i, np.float32),
                     depth=np.ones((2, 2), np.float32), gt_c2w=None)


def test_prefetcher_order_error_and_close():
    pf = Prefetcher(_Reader(9), prefetch_depth=2, device="cpu", start=2, end=7)
    got = [(f.idx, float(f.color[0, 0, 0])) for f in pf]
    assert got == [(i, float(i)) for i in range(2, 7)]
    pf.close()
    assert not pf._thread.is_alive()

    pf = Prefetcher(_Reader(9, fail_at=4), prefetch_depth=2, device="cpu")
    seen = []
    with pytest.raises(RuntimeError, match="prefetch worker failed") as ei:
        for f in pf:
            seen.append(f.idx)
    assert seen == [0, 1, 2, 3] and isinstance(ei.value.__cause__, OSError)
    pf.close()

    # Closed early, with the worker blocked on a full queue.
    pf = Prefetcher(_Reader(50), prefetch_depth=1, device="cpu")
    assert next(iter(pf)).idx == 0
    pf.close()
    assert not pf._thread.is_alive() and pf.q.empty()


def _gt_cfg():
    cfg = tiny_config(gt_camera=True)
    return dataclasses.replace(
        cfg, mapping=dataclasses.replace(cfg.mapping, iters_first=30, iters=6))


def _tensors(slam):
    st = slam.state
    db = dataclasses.asdict(st.keyframes)
    out = {f"grid/{k}": v for k, v in st.grids.items()}
    out.update({f"dec/{n}": t for n, t in enumerate(tree_leaves(st.decoders))})
    out.update({f"kf/{k}": v for k, v in db.items() if isinstance(v, torch.Tensor)})
    out.update({f"bound/{k}": v for k, v in slam.bounds.items()})
    out["scene_bound"] = slam.scene_bound
    return out


def test_checkpoint_round_trip_and_resume_continues(tmp_path):
    cfg = _gt_cfg()
    reader = SyntheticBoxReader(cfg, n_frames=8)
    slam = NiceSLAM(cfg, reader=reader, device="cpu")
    slam.n_imgs = 8
    for i in range(6):
        slam.step(reader[i])
    ck = os.path.join(tmp_path, "ck", "frame_000005")
    save_checkpoint(ck, slam.state, slam.est_c2w, slam.gt_c2w, 5,
                    bounds=slam.bounds, scene_bound=slam.scene_bound)
    payload = load_checkpoint(ck, "cpu")
    assert payload["frame_idx"] == 5 and payload["state"].keyframes.count == slam._kf_count

    fresh = NiceSLAM(cfg, reader=reader, device="cpu")
    fresh.n_imgs = 8
    # A frame already on the run's device is not copied again.
    color = torch.zeros((2, 2, 3))
    assert fresh._tensor(color) is color
    start = fresh.restore(ck)
    assert start == 6 and len(fresh.est_c2w) == 6
    assert fresh.state.version == slam.state.version
    want, got = _tensors(slam), _tensors(fresh)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_array_equal(np.stack(fresh.est_c2w), np.stack(slam.est_c2w))
    np.testing.assert_array_equal(np.stack(fresh.gt_c2w), np.stack(slam.gt_c2w))
    # The host mirrors of the keyframe DB are rebuilt from the DB.
    assert fresh._kf_count == slam._kf_count
    np.testing.assert_array_equal(fresh._kf_slot_frame, slam._kf_slot_frame)
    assert fresh._is_keyframe(0) == slam._is_keyframe(0)
    for i in range(start, 8):
        fresh.step(reader[i])
    res = fresh.result()
    assert len(res["est_c2w"]) == 8 and res["ate_rmse"] < 0.2


def _tiny_yaml(tmp_path) -> str:
    """A config file in the tiny CPU world, inheriting the base config."""
    path = tmp_path / "tiny.yaml"
    path.write_text(
        f"inherit_from: {os.path.join(_ROOT, 'configs', 'niceslam.yaml')}\n"
        "dataset: synthetic\ncoarse: False\nverbose: False\n"
        "bound: [[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]]\n"
        "grid_len: {coarse: 1.5, middle: 0.5, fine: 0.25, color: 0.25, bound_divisable: 0.25}\n"
        "cam: {H: 48, W: 64, fx: 40.0, fy: 40.0, cx: 32.0, cy: 24.0, png_depth_scale: 1.0}\n"
        "rendering: {N_samples: 16, N_surface: 8}\n"
        "tracking: {pixels: 64, iters: 4, ignore_edge_H: 4, ignore_edge_W: 4}\n"
        "mapping: {pixels: 128, iters_first: 20, iters: 4, every_frame: 1,\n"
        "          keyframe_every: 2, mapping_window_size: 4, max_keyframes: 8,\n"
        "          color_refine: False, BA: False, ckpt_freq: 1, mesh_freq: 2}\n"
    )
    return str(path)


def test_cli_runs_checkpoints_and_resumes(tmp_path, capsys):
    cfg_path = _tiny_yaml(tmp_path)
    d = tmp_path / "out"
    common = [cfg_path, "--cpu", "--frames", "3", "--set", "sync_method=async",
              "--set", "tracking.method=adam", "--set", "meshing.clean_mesh=false",
              "--ckpt-dir", str(d / "ck"), "--log", str(d / "metrics.jsonl"),
              "--mesh", str(d / "mesh.ply"), "--mesh-resolution", "16"]
    assert cli.main(common + ["--trajectory", str(d / "traj.npy")]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["frames"] == 3 and last["fps_avg"] > 0 and last["ate_rmse_cm"] < 20.0
    traj = np.load(d / "traj.npy")
    assert traj.shape == (3, 4, 4) and np.isfinite(traj).all()
    assert sorted(os.listdir(d / "ck")) == ["frame_000001", "frame_000002"]
    assert os.path.getsize(d / "mesh_frame000002.ply") > 0
    assert "element face 0\n" not in (d / "mesh.ply").read_text()
    records = [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]
    assert [r["frame"] for r in records if r["event"] == "frame"] == [0, 1, 2]

    assert cli.main(common + ["--resume", str(d / "ck" / "frame_000001"),
                              "--trajectory", str(d / "traj2.npy")]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    traj2 = np.load(d / "traj2.npy")
    assert last["frames"] == 3 and traj2.shape == (3, 4, 4) and np.isfinite(traj2).all()
    np.testing.assert_array_equal(traj2[:2], traj[:2])  # restored, then continued
