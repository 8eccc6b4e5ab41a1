"""The stream generator: a path that closes after one period, and frames
whose depth is the distance to the room's walls."""
import numpy as np
import torch

from benchmark.harness import spec, stream
from benchmark.reference import render as R


def test_bench_stream_closes_after_one_period():
    traffic = spec.traffic("slam_stream")
    bench = spec.load_benchmark()
    box = stream.room(spec.config(bench, "scannet_scene0000")["slam"]["bound"],
                      traffic["shrink"])
    ps = stream.poses(dict(traffic, period=traffic["period"] + 1), box)
    np.testing.assert_allclose(ps[-1], ps[0], atol=1e-5)
    steps = [np.linalg.norm(ps[k + 1][:3, 3] - ps[k][:3, 3]) for k in range(traffic["period"])]
    assert min(steps) > 1e-3
    for p in ps:
        assert np.all(p[:3, 3] > box[:, 0]) and np.all(p[:3, 3] < box[:, 1])


def test_bench_stream_frames_see_the_walls():
    traffic = spec.traffic("slam_stream")
    slam = spec.config(spec.load_benchmark(), "replica_room0")["slam"]
    cam = R.Camera(24, 32, 30.0, 30.0, 16.0, 12.0)
    colors, depths, ps = stream.stage(cam, slam["bound"], dict(traffic, period=4), "cpu")
    assert len(colors) == len(depths) == len(ps) == 4
    box = stream.room(slam["bound"], traffic["shrink"])
    diag = float(np.linalg.norm(box[:, 1] - box[:, 0]))
    for c, d in zip(colors, depths):
        assert c.shape == (24, 32, 3) and d.shape == (24, 32)
        assert torch.all(d > 0) and torch.all(d < diag)
        assert torch.all((c >= 0) & (c <= 1))
