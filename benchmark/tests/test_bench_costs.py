"""The frozen cost arithmetic equals the port's ``utils/roofline.py`` at the
port's bench shapes, and the ATE copy equals ``eval/ate.py``."""
import numpy as np
import pytest

from benchmark.harness import ate, costs


@pytest.mark.parametrize("stage", ["coarse", "middle", "fine", "color"])
def test_bench_costs_match_the_port(stage):
    from niceslam_tpu_torch.utils import roofline

    gb = {"coarse": 4 * 32 * 40, "middle": 27 * 11 * 18 * 32 * 4,
          "fine": 52 * 22 * 36 * 32 * 4, "color": 52 * 22 * 36 * 32 * 4}
    for rays, backward in ((400, True), (1000, True), (1000, False)):
        ref = roofline.render_cost(rays, 48, 32, gb, stage, backward=backward)
        assert costs.render_cost(rays, 48, 32, gb, stage, backward) == (ref["flops"],
                                                                         ref["bytes"])
    if stage == "color":
        ref = roofline.mapping_step_cost(1000, 48, 32, gb)
        assert costs.mapping_step_cost(1000, 48, 32, gb, "color") == (ref["flops"],
                                                                       ref["bytes"])


def test_bench_ate_matches_the_port():
    from niceslam_tpu_torch.eval import ate as port

    rng = np.random.default_rng(3)
    gt = [np.eye(4) for _ in range(20)]
    for k, g in enumerate(gt):
        g[:3, 3] = [np.cos(k / 3), 0.1 * k, np.sin(k / 5)]
    est = []
    for g in gt:
        e = g.copy()
        e[:3, 3] += rng.normal(0, 0.02, 3)
        est.append(e)
    for scale in (False, True):
        assert ate.ate_rmse(est, gt, scale) == port.ate_rmse(est, gt, scale)


def test_bench_sampler_bytes_count_the_schedule():
    cfg = {"rendering": {"N_samples": 32, "N_surface": 16}, "model": {"c_dim": 32},
           "tracking": {"pixels": 10, "iters": 2}, "mapping": {"pixels": 20}}
    gb = {"coarse": 100, "middle": 200, "fine": 300, "color": 400}
    one_gn = 3 * 10 * 48 * (12 + 4 * 32 + 12 * 32)
    assert costs.sampler_bytes(cfg, 1, [], gb) == 2 * one_gn
    n = 20 * 48
    mid = n * (12 + 4 * 32) + n * (4 * 32 + 12) + 200
    assert costs.sampler_bytes(cfg, 0, [("middle", False)], gb) == mid
    assert costs.sampler_bytes(cfg, 0, [("middle", True)], gb) == mid + n * 12
