"""The port's dataset readers, PNG codec and native EXR loader against the
JAX package's, and the port's command line over a Co-Fusion layout on disk.

Fixtures are written by ``scripts/make_fixture_dataset.py`` (H=24, W=32,
3 frames, as ``tests/unit/test_dataset_readers.py``). Readers must give the
JAX readers' colour, depth and pose bit for bit (no tolerance); the PNG
reader must give ``cv2``'s pixels bit for bit.
"""
import json
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from niceslam_tpu.config.schema import CamConfig as JCamConfig
from niceslam_tpu.config.schema import SLAMConfig as JSLAMConfig
from niceslam_tpu.io import native_loader as jnative
from niceslam_tpu.io.datasets.base import get_dataset as jget_dataset
from niceslam_tpu.io.datasets.cofusion import _imread_exr as j_imread_exr
from niceslam_tpu_torch import __main__ as cli
from niceslam_tpu_torch.config.schema import CamConfig, SLAMConfig
from niceslam_tpu_torch.io import exr_write, native_loader, png
from niceslam_tpu_torch.io.datasets import base
from niceslam_tpu_torch.io.datasets.base import get_dataset
from niceslam_tpu_torch.io.datasets.cofusion import _imread_exr
from niceslam_tpu_torch.models.decoders import DecoderConfig, init_decoders
from niceslam_tpu_torch.models.pretrained import load_decoders_npz, upstream_state_dict

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FX, FRAMES, SCALE = 24, 32, 20.0, 3, 1000.0
LAYOUTS = {"cofusion": 1.0, "replica": SCALE, "tumrgbd": SCALE, "scannet": SCALE}


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("layouts")
    for layout in LAYOUTS:
        subprocess.run(
            [sys.executable, os.path.join(_ROOT, "scripts", "make_fixture_dataset.py"),
             "--layout", layout, "--out", str(root / layout), "--frames", str(FRAMES),
             "--H", str(H), "--W", str(W), "--fx", str(FX), "--depth-scale", str(SCALE)],
            check=True, capture_output=True,
        )
    return root


def _cfgs(dataset, folder, scale):
    cam = dict(H=H, W=W, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, png_depth_scale=scale)
    return (SLAMConfig(dataset=dataset, data_input_folder=str(folder), cam=CamConfig(**cam)),
            JSLAMConfig(dataset=dataset, data_input_folder=str(folder), cam=JCamConfig(**cam)))


@pytest.mark.parametrize("dataset", ["cofusion", "replica", "tumrgbd", "scannet", "apartment"])
def test_reader_equals_jax_reader(fixtures, dataset):
    layout = "scannet" if dataset == "apartment" else dataset
    cfg, jcfg = _cfgs(dataset, fixtures / layout, LAYOUTS[layout])
    got, want = get_dataset(cfg), jget_dataset(jcfg)
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) == FRAMES
    for k in range(FRAMES):
        g, w = got[k], want[k]
        assert g.idx == w.idx == k
        for name in ("color", "depth", "gt_c2w"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=f"{dataset} frame {k} {name}")


def test_registry_names_match_jax():
    from niceslam_tpu.io.datasets.base import _REGISTRY as jregistry

    with pytest.raises(KeyError, match="unknown dataset"):
        get_dataset(SLAMConfig(dataset="no_such_layout"))
    assert sorted(base._REGISTRY) == sorted(jregistry)


@pytest.mark.parametrize("dataset", ["replica", "scannet", "apartment"])
def test_jpeg_layout_without_cv2_says_so(fixtures, dataset, monkeypatch):
    layout = "scannet" if dataset == "apartment" else dataset
    reader = get_dataset(_cfgs(dataset, fixtures / layout, SCALE)[0])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=f"{dataset} layout .* JPEG"):
        reader[0]


def test_crop_and_pose_convention_match_jax():
    from niceslam_tpu.io.datasets.base import crop_frame as jcrop
    from niceslam_tpu.io.datasets.base import opencv_to_opengl as jgl

    rng = np.random.default_rng(0)
    m = rng.normal(size=(4, 4))
    np.testing.assert_array_equal(base.opencv_to_opengl(m), jgl(m))
    c, d = rng.random((10, 12, 3)), rng.random((10, 12))
    for edge in (0, 2):
        for a, b in zip(base.crop_frame(c, d, edge), jcrop(c, d, edge)):
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------------- PNG
def _filter_rows(rows: np.ndarray, bpp: int, types) -> bytes:
    """PNG filtering (the encoder's side) of ``rows [H, stride]`` with the
    given filter type per row."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, cur in enumerate(rows.astype(np.int64)):
        t = types[y % len(types)]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if t == 0:
            pred = np.zeros_like(cur)
        elif t == 1:
            pred = left
        elif t == 2:
            pred = prev
        elif t == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([t]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))


def _encode(path, samples, color_type, depth, palette=None, types=(0, 1, 2, 3, 4),
            interlace=0):
    h, w = samples.shape[:2]
    data = samples.astype(">u2") if depth == 16 else samples.astype(np.uint8)
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1)
    bpp = max(1, rows.shape[1] // w)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    idat = zlib.compress(_filter_rows(rows, bpp, types))
    body += _chunk(b"IDAT", idat[:len(idat) // 2]) + _chunk(b"IDAT", idat[len(idat) // 2:])
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b""))


@pytest.mark.parametrize("color_type,depth", [(0, 8), (0, 16), (2, 8), (2, 16), (3, 8),
                                              (4, 8), (4, 16), (6, 8), (6, 16)])
def test_png_reader_equals_cv2_on_every_filter_type(tmp_path, color_type, depth):
    """A file with rows of all five filter types, read by the port and by cv2."""
    rng = np.random.default_rng(color_type * 100 + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    hi = 2**depth if color_type != 3 else 40
    smooth = np.add.outer(np.arange(13), np.arange(17))[..., None] * (hi // 64)
    samples = (smooth + rng.integers(0, hi // 8 + 2, (13, 17, ch))) % hi
    palette = rng.integers(0, 256, (40, 3)) if color_type == 3 else None
    path = str(tmp_path / "f.png")
    _encode(path, samples, color_type, depth, palette)
    np.testing.assert_array_equal(png.read_png_rgb(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    if color_type in (0, 4):
        got, want = png.read_png_grey(path), cv2.imread(path, cv2.IMREAD_ANYDEPTH)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_png_reader_equals_cv2_on_cv2_files(fixtures):
    for path in sorted((fixtures / "tumrgbd").glob("*/*.png")):
        want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if want.ndim == 3:
            np.testing.assert_array_equal(png.read_png_rgb(str(path)), want[..., ::-1])
        else:
            got = png.read_png_grey(str(path))
            assert got.dtype == want.dtype == np.uint16
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_cpp_unfilter_equals_plain(bpp):
    rng = np.random.default_rng(bpp)
    rows, stride = 11, 7 * bpp
    raw = rng.integers(0, 256, (rows, stride + 1), dtype=np.uint8)
    raw[:, 0] = np.arange(rows) % 5  # every filter type, the first row too
    raw = raw.tobytes()
    np.testing.assert_array_equal(png.unfilter(raw, rows, stride, bpp),
                                  png.unfilter_plain(raw, rows, stride, bpp))
    bad = bytearray(raw)
    bad[3 * (stride + 1)] = 5
    with pytest.raises(ValueError, match="row 3: unknown filter type 5"):
        png.unfilter(bytes(bad), rows, stride, bpp)


def test_write_png_reads_back_with_cv2(tmp_path):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (9, 14, 3), dtype=np.uint8)
    g16 = rng.integers(0, 65536, (9, 14), dtype=np.uint16)
    for name, img, want in [("rgb", rgb, lambda p: cv2.imread(p)[..., ::-1]),
                            ("g16", g16, lambda p: cv2.imread(p, cv2.IMREAD_ANYDEPTH))]:
        path = str(tmp_path / f"{name}.png")
        png.write_png(path, img)
        np.testing.assert_array_equal(want(path), img, err_msg=name)
    for bad in (rgb.astype(np.float32), g16.astype(np.uint8)):
        with pytest.raises(ValueError, match="write_png takes"):
            png.write_png(str(tmp_path / "x.png"), bad)


@pytest.mark.parametrize("fault", ["interlaced", "depth4", "crc", "signature", "colour_as_grey"])
def test_png_reader_names_file_and_reason(tmp_path, fault):
    path = str(tmp_path / "bad.png")
    samples = np.zeros((4, 5, 3 if fault == "colour_as_grey" else 1), np.uint8)
    _encode(path, samples, 2 if fault == "colour_as_grey" else 0,
            4 if fault == "depth4" else 8, interlace=int(fault == "interlaced"))
    if fault in ("crc", "signature"):
        data = bytearray(open(path, "rb").read())
        data[1 if fault == "signature" else 20] ^= 0xFF
        open(path, "wb").write(bytes(data))
    reason = {"interlaced": "interlaced", "depth4": "bit depth 4", "crc": "CRC mismatch",
              "signature": "bad signature", "colour_as_grey": "where a grey one"}[fault]
    read = png.read_png_grey if fault == "colour_as_grey" else png.read_png_rgb
    with pytest.raises(IOError, match=f"bad.png: .*{reason}"):
        read(path)


# -------------------------------------------------------------------- EXR
def test_exr_reader_and_pool_equal_jax(fixtures, tmp_path):
    rng = np.random.default_rng(4)
    paths = sorted(str(p) for p in (fixtures / "cofusion" / "depth_noise").glob("*.exr"))
    for i in range(2):
        p = str(tmp_path / f"r{i}.exr")
        exr_write.write_exr(p, rng.uniform(0, 9, (H, W)).astype(np.float32),
                            compression="none" if i else "zip")
        paths.append(p)
    pool = native_loader.NativeDecodePool(n_workers=2)
    tickets = [pool.submit(p, (H, W)) for p in paths]
    for p, t in zip(paths, tickets):
        want = jnative.read_exr(p)
        assert want.dtype == np.float32 and want.shape == (H, W)
        for got in (native_loader.read_exr(p), _imread_exr(p), pool.wait(t), j_imread_exr(p)):
            np.testing.assert_array_equal(got, want)
    pool.close()
    with pytest.raises(IOError):
        native_loader.read_exr(paths[0], "Q")


def test_exr_compression_the_decoder_refuses(tmp_path, monkeypatch):
    """An EXR the native decoder refuses goes to cv2; without cv2 the error
    names the file and the missing package."""
    p = str(tmp_path / "piz.exr")
    exr_write.write_exr(p, np.ones((4, 4), np.float32), compression="none")
    data = open(p, "rb").read()
    at = data.index(b"compression\0compression\0") + len("compression\0compression\0") + 4
    open(p, "wb").write(data[:at] + bytes([4]) + data[at + 1:])  # PIZ
    with pytest.raises(IOError):
        native_loader.read_exr(p)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(IOError, match="piz.exr: .*needs OpenCV"):
        _imread_exr(p)


def test_failed_native_build_raises_with_compiler_output(tmp_path, monkeypatch):
    from niceslam_tpu_torch.io import native_build

    src = tmp_path / "broken.cpp"
    src.write_text("int f( {\n")
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .*broken.cpp"):
        native_build.build("broken", [src])


# -------------------------------------------------------------------- CLI
def test_cli_on_cofusion_layout_with_panels_and_pt(fixtures, tmp_path, capsys):
    """``python -m niceslam_tpu_torch configs/cofusion.yaml`` on the CPU over
    the Co-Fusion fixture, with upstream-format .pt decoders, panels every
    frame and a profiler trace."""
    npz = load_decoders_npz(os.path.join(_ROOT, "models", "pretrained_decoders.npz"),
                            init_decoders(DecoderConfig(), device="cpu"))
    torch.save(upstream_state_dict(npz, ("coarse",)), tmp_path / "c.pt")
    torch.save({"model": upstream_state_dict(npz, ("middle", "fine"))}, tmp_path / "mf.pt")
    out = tmp_path / "out"
    sets = {
        "data.input_folder": str(fixtures / "cofusion"), "cam.H": H, "cam.W": W,
        "cam.fx": FX, "cam.fy": FX, "cam.cx": W / 2.0, "cam.cy": H / 2.0,
        "grid_len.coarse": 4.0, "grid_len.middle": 1.0, "grid_len.fine": 0.5,
        "grid_len.color": 0.5, "grid_len.bound_divisable": 0.5,
        "rendering.N_samples": 8, "rendering.N_surface": 4,
        "tracking.pixels": 32, "tracking.iters": 3, "tracking.ignore_edge_H": 2,
        "tracking.ignore_edge_W": 2, "tracking.method": "adam", "sync_method": "async",
        "mapping.pixels": 64, "mapping.iters_first": 10, "mapping.iters": 3,
        "mapping.every_frame": 1, "mapping.color_refine": False, "mapping.vis_freq": 1,
        "pretrained_coarse": str(tmp_path / "c.pt"),
        "pretrained_middle_fine": str(tmp_path / "mf.pt"), "verbose": False,
    }
    argv = [os.path.join(_ROOT, "configs", "cofusion.yaml"), "--cpu",
            "--log", str(out / "m.jsonl"), "--trajectory", str(out / "traj.npy"),
            "--vis-dir", str(out / "vis"), "--profile-dir", str(out / "prof")]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    assert cli.main(argv) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["frames"] == FRAMES and last["ate_rmse_cm"] is not None
    traj = np.load(out / "traj.npy")
    assert traj.shape == (FRAMES, 4, 4) and np.isfinite(traj).all()
    # no_vis_on_first_frame: panels for frames 1 and 2.
    assert sorted(os.listdir(out / "vis")) == ["frame_000001.png", "frame_000002.png"]
    panel = png.read_png_rgb(str(out / "vis" / "frame_000002.png"))
    assert panel.shape == (H, 5 * W, 3) and panel.min() != panel.max()
    events = json.load(open(out / "prof" / "trace.json"))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"track", "map"} <= names
