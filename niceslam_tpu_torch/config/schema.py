"""Typed configuration: the dataclasses behind ``SLAMConfig`` and the YAML
loader.

A copy of the JAX package's configuration (``niceslam_tpu/config/schema.py``)
with the same field names and defaults, so that a configuration written for
one package loads into the other unchanged: ``inherit_from`` chains, dotted
overrides, the upstream key aliases and the ``data:`` /
``pretrained_decoders:`` blocks. An unknown key raises ``KeyError`` naming it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import yaml


@dataclass(frozen=True)
class CamConfig:
    """Pinhole camera + depth scaling."""

    H: int = 480
    W: int = 640
    fx: float = 360.0
    fy: float = 360.0
    cx: float = 320.0
    cy: float = 240.0
    png_depth_scale: float = 1.0
    crop_edge: int = 0


@dataclass(frozen=True)
class TrackingConfig:
    ignore_edge_W: int = 20
    ignore_edge_H: int = 20
    use_color_in_tracking: bool = True
    handle_dynamic: bool = True
    w_color_loss: float = 0.5
    seperate_LR: bool = False  # (sic) upstream key spelling
    depth_err_gate: float = 0.3
    # Pose solver: "gn" (Gauss-Newton/IRLS) or "adam" (the reference's
    # first-order loop); see slam/tracker.py.
    method: str = "gn"
    gn_prior_sigma_r: float = 0.02
    gn_prior_sigma_t: float = 0.03
    gn_step_clip: float = 0.02
    gn_depth_offset_sigma: float = 0.0
    const_speed_assumption: bool = True
    gt_camera: bool = False
    lr: float = 0.001
    pixels: int = 200
    iters: int = 10
    vis_freq: int = 50
    vis_inside_freq: int = 25
    no_vis_on_first_frame: bool = True


@dataclass(frozen=True)
class StageLR:
    """Per-stage learning rates."""

    decoders_lr: float = 0.0
    coarse_lr: float = 0.0
    middle_lr: float = 0.0
    fine_lr: float = 0.0
    color_lr: float = 0.0


@dataclass(frozen=True)
class MappingConfig:
    color_refine: bool = True
    middle_iter_ratio: float = 0.4
    fine_iter_ratio: float = 0.6
    every_frame: int = 5
    BA: bool = True
    BA_cam_lr: float = 0.001
    BA_min_keyframes: int = 4
    bootstrap_frames: int = 0
    bootstrap_iters: int = 0
    fix_fine: bool = True
    fix_color: bool = False
    keyframe_every: int = 50
    mapping_window_size: int = 5
    w_color_loss: float = 0.2
    tv_weight: float = 0.0
    fs_weight: float = 0.0
    fs_band: float = 0.05
    retrack: bool = False
    lock_after: int = 0
    frustum_feature_selection: bool = True
    keyframe_selection_method: str = "overlap"
    lr_first_factor: float = 5.0
    lr_factor: float = 1.0
    pixels: int = 1000
    iters_first: int = 1500
    iters: int = 60
    max_keyframes: int = 128
    decoder_train: str = "never"
    decoders_lr: float = 0.005
    stage_coarse: StageLR = StageLR(coarse_lr=0.001)
    stage_middle: StageLR = StageLR(middle_lr=0.1)
    stage_fine: StageLR = StageLR(middle_lr=0.005, fine_lr=0.005)
    stage_color: StageLR = StageLR(
        decoders_lr=0.005, middle_lr=0.005, fine_lr=0.005, color_lr=0.005
    )
    vis_freq: int = 50
    mesh_freq: int = 50
    ckpt_freq: int = 500

    def stage_lr(self, stage: str) -> StageLR:
        return getattr(self, f"stage_{stage}")


@dataclass(frozen=True)
class RenderingConfig:
    N_samples: int = 32
    N_surface: int = 16
    N_importance: int = 0
    lindisp: bool = False
    perturb: float = 0.0
    surface_band: float = 0.05


@dataclass(frozen=True)
class ModelConfig:
    c_dim: int = 32
    hidden_size: int = 32
    coarse_bound_enlarge: float = 2.0
    pos_embedding_method: str = "fourier"


@dataclass(frozen=True)
class GridLenConfig:
    coarse: float = 2.0
    middle: float = 0.32
    fine: float = 0.16
    color: float = 0.16
    bound_divisable: float = 0.32


@dataclass(frozen=True)
class ParallelConfig:
    """Multi-device layout. ``n_processes`` ranks (processes, one per card,
    over ``torch.distributed`` at ``coordinator``) form a ``map`` x ``kf``
    mesh (``kf`` 0: the ranks over ``map``) that shards the grids along Z
    and the mapping rays (``parallel/``). Without ranks, ``track_role`` and
    ``stage_ep`` put tracking and the coarse stage on devices of their own
    (the last and the second of ``NiceSLAM(devices=...)``)."""

    n_processes: int = 1
    coordinator: str = "localhost:9991"
    kf: int = 0
    map: int = 1
    stage_ep: bool = False
    track_role: bool = False


@dataclass(frozen=True)
class MeshingConfig:
    """Offline mesher options (``eval/mesher.py``): the isosurface level and
    the cleanup of ``postprocess_mesh``."""

    level_set: float = 0.0
    resolution: int = 256
    eval_rec: bool = False
    # Cull mesh geometry never observed by the trajectory (project every
    # vertex into each camera; keep faces with a frustum-visible vertex).
    clean_mesh: bool = True
    # Additionally require vertices to pass the per-view depth test
    # (not behind the observed surface by > its depth x (scale - 1)).
    depth_test: bool = False
    mesh_coarse_level: bool = False
    clean_mesh_bound_scale: float = 1.02
    get_largest_components: bool = False
    color_mesh_extraction_method: str = "direct_point_query"


@dataclass(frozen=True)
class SLAMConfig:
    """Top-level system config."""

    coarse: bool = True
    sync_method: str = "strict"
    scale: float = 1.0
    verbose: bool = True
    occupancy: bool = True
    dataset: str = "synthetic"
    data_input_folder: str = ""
    output: str = "output"
    bound: Tuple[Tuple[float, float], ...] = (
        (-4.5, 3.82),
        (-1.5, 2.02),
        (-3.0, 2.76),
    )
    grid_len: GridLenConfig = GridLenConfig()
    model: ModelConfig = ModelConfig()
    cam: CamConfig = CamConfig()
    tracking: TrackingConfig = TrackingConfig()
    mapping: MappingConfig = MappingConfig()
    rendering: RenderingConfig = RenderingConfig()
    parallel: ParallelConfig = ParallelConfig()
    meshing: MeshingConfig = MeshingConfig()
    pretrained_coarse: str = ""
    pretrained_middle_fine: str = ""


_NESTED = {
    "grid_len": GridLenConfig,
    "model": ModelConfig,
    "cam": CamConfig,
    "tracking": TrackingConfig,
    "mapping": MappingConfig,
    "rendering": RenderingConfig,
    "parallel": ParallelConfig,
    "meshing": MeshingConfig,
}

_KEY_ALIASES = {
    # upstream yaml key -> dataclass field
    "hidden": "hidden_size",
}


def _build(cls, data: Dict[str, Any]):
    """Construct a dataclass from a dict, validating keys."""
    valid = {f.name: f for f in fields(cls)}
    kwargs = {}
    for k, v in data.items():
        k = _KEY_ALIASES.get(k, k)
        if k == "stage" and cls is MappingConfig:
            for s, lrs in v.items():
                kwargs[f"stage_{s}"] = _build(StageLR, lrs)
            continue
        if k not in valid:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        f = valid[k]
        if dataclasses.is_dataclass(f.type) or f.name in _NESTED:
            kwargs[k] = _build(_NESTED[f.name], v)
        elif f.name == "bound":
            kwargs[k] = tuple(tuple(float(x) for x in row) for row in v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _apply_overrides(data: Dict[str, Any], overrides: Dict[str, Any]):
    for dotted, v in overrides.items():
        node = data
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return data


def _load_chain(p: Path, seen: Tuple[Path, ...] = ()) -> Dict[str, Any]:
    """A config file with its ``inherit_from`` chain resolved, recursively
    (``cofusion_synth849.yaml`` -> ``cofusion.yaml`` -> ``niceslam.yaml``),
    each file over its parent. ``seen`` holds the files that led here: a
    file that inherits from one of them raises ``ValueError`` naming the
    cycle."""
    key = Path(p).resolve()
    if key in seen:
        chain = " -> ".join(str(q) for q in (*seen[seen.index(key):], key))
        raise ValueError(f"inherit_from cycle: {chain}")
    with open(p) as f:
        d = yaml.safe_load(f) or {}
    parent = d.pop("inherit_from", None)
    if parent is not None:
        d = _deep_merge(_load_chain(Path(p).parent / parent, (*seen, key)), d)
    return d


def load_config(
    path: str | Path | None = None,
    base: str | Path | None = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> SLAMConfig:
    """Load a dataset config, overlaying it on a base algorithm config.

    The layers, lowest first: ``base`` (with its own ``inherit_from``
    chain), the ``inherit_from`` chain of ``path`` (``path: <relative
    path>``, each file over its parent), ``path`` itself, then
    ``overrides`` in dotted paths (``{"tracking.lr": 0.01}``). A cyclic
    ``inherit_from`` raises ``ValueError`` naming the files.
    """
    data: Dict[str, Any] = {}
    if path is not None:
        data = _load_chain(Path(path))
    if base is not None:
        data = _deep_merge(_load_chain(Path(base)), data)
    if overrides:
        data = _apply_overrides(data, overrides)
    # Alternate key spellings and upstream keys that mean nothing here.
    for blk in ("tracking", "mapping"):
        blk_d = data.get(blk)
        if isinstance(blk_d, dict):
            blk_d.pop("device", None)
            for k in ("no_mesh_on_first_frame", "no_log_on_first_frame",
                      "save_selected_keyframes_info", "vis_inside_freq"):
                if blk != "tracking" or k != "vis_inside_freq":
                    blk_d.pop(k, None)
    if isinstance(data.get("data"), dict):
        d = data.pop("data")
        if "input_folder" in d:
            data["data_input_folder"] = d["input_folder"]
        if "output" in d:
            data["output"] = d["output"]
    if isinstance(data.get("pretrained_decoders"), dict):
        pd = data.pop("pretrained_decoders")
        data["pretrained_coarse"] = pd.get("coarse", "")
        data["pretrained_middle_fine"] = pd.get("middle_fine", "")
    data.pop("low_gpu_mem", None)
    return _build(SLAMConfig, data)
