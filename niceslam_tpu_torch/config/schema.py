"""Typed configuration: the dataclasses behind ``SLAMConfig``.

A copy of the configuration dataclasses of the JAX package
(``niceslam_tpu/config/schema.py``) with the same field names and defaults,
so that a configuration written for one package transcribes one to one. The
YAML overlay loader is not part of this package yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
    # Pose solver. Only "gn" (Gauss-Newton/IRLS) is implemented here.
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
class MeshingConfig:
    """Offline mesher options (``eval/mesher.py``): the isosurface level and
    the cleanup of ``postprocess_mesh``. The JAX schema's options that no
    code of this package reads are left out until their code is ported."""

    level_set: float = 0.0
    # Cull mesh geometry never observed by the trajectory (project every
    # vertex into each camera; keep faces with a frustum-visible vertex).
    clean_mesh: bool = True
    # Additionally require vertices to pass the per-view depth test
    # (not behind the observed surface by > its depth x (scale - 1)).
    depth_test: bool = False
    clean_mesh_bound_scale: float = 1.02
    get_largest_components: bool = False


@dataclass(frozen=True)
class SLAMConfig:
    """Top-level system config. Only ``sync_method="strict"`` on one
    device is implemented by this package's driver."""

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
    meshing: MeshingConfig = MeshingConfig()
    pretrained_coarse: str = ""
    pretrained_middle_fine: str = ""
