"""The port's roofline model (``utils/roofline.py``) against the JAX
package's: every cost function equal on the same shapes, and the device
table keyed on the card's name, raising for a device it does not know."""
import pytest

from niceslam_tpu.utils import roofline as jroof
from niceslam_tpu_torch.utils import roofline as roof

GRID_BYTES = {"coarse": 4 * 5 * 3 * 4 * 32, "middle": 4 * 27 * 11 * 18 * 32,
              "fine": 4 * 53 * 24 * 38 * 32, "color": 4 * 53 * 24 * 38 * 32}

CASES = [
    ("trilinear_cost", (48_000, 32, GRID_BYTES["fine"]), {}),
    ("trilinear_cost", (48_000, 32, GRID_BYTES["fine"]), {"backward": True}),
    ("trilinear_cost", (100, 32, 1 << 30), {"backward": True}),  # the gather term binds
    ("mlp_cost", (8190,), {}),
    ("mlp_cost", (8190,), {"c_in": 64, "backward": True}),
    ("mlp_cost", (4094,), {"color": True, "backward": True}),
    ("compositing_cost", (1000, 48), {}),
    *[("render_cost", (1000, 48, 32, GRID_BYTES), {"stage": s, "backward": b})
      for s in ("coarse", "middle", "fine", "color") for b in (False, True)],
    ("render_cost", (400, 48, 32, {"middle": GRID_BYTES["middle"]}), {"stage": "fine"}),
    ("mapping_step_cost", (1000, 48, 32, GRID_BYTES), {}),
]


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_cost_functions_equal_jax(name, args, kw):
    assert getattr(roof, name)(*args, **kw) == getattr(jroof, name)(*args, **kw)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sol_ms_equals_jax(dtype):
    peaks = roof.device_peaks("cpu")
    assert tuple(peaks) == tuple(jroof._PEAKS["cpu"])
    for flops, nbytes in ((1e9, 1e6), (1e6, 1e9), (0.0, 0.0)):
        assert roof.sol_ms(flops, nbytes, peaks, dtype) == jroof.sol_ms(
            flops, nbytes, jroof._PEAKS["cpu"], dtype)


def test_device_peaks_by_name():
    h100 = roof.device_peaks("NVIDIA H100 80GB HBM3")
    assert (h100.hbm_gbps, h100.flops_f32, h100.flops_bf16) == (3350.0, 67e12, 989e12)
    assert roof.device_peaks("cpu").name == "cpu"
    # 48,000 corner gathers of the fine grid: bound by bytes over 3.35 TB/s
    c = roof.trilinear_cost(48_000, 32, GRID_BYTES["fine"])
    assert roof.sol_ms(c["flops"], c["bytes"], h100) == pytest.approx(
        c["bytes"] / 3.35e12 * 1e3)
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "TPU v5 lite"):
        with pytest.raises(ValueError, match="no roofline peaks"):
            roof.device_peaks(name)
