"""Pose calculus: quaternion <-> SO(3), camera-tensor packing, warm starts.

Camera tensor layout: ``[qw, qx, qy, qz, tx, ty, tz]`` (quaternion first).
Everything is differentiable torch, so pose optimization backprops (and
forward-mode differentiates) through quat -> R and the SE(3) exponential.
"""
from __future__ import annotations

import torch


def quat_to_rotation(quad: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) ``[..., 4]`` (w,x,y,z) -> rotation ``[..., 3, 3]``.

    ``two_s = 2 / <q,q>`` makes the map scale-invariant, so an optimizer may
    drift off the unit sphere freely.
    """
    qr, qi, qj, qk = quad[..., 0], quad[..., 1], quad[..., 2], quad[..., 3]
    two_s = 2.0 / torch.sum(quad * quad, dim=-1)
    r00 = 1 - two_s * (qj**2 + qk**2)
    r01 = two_s * (qi * qj - qk * qr)
    r02 = two_s * (qi * qk + qj * qr)
    r10 = two_s * (qi * qj + qk * qr)
    r11 = 1 - two_s * (qi**2 + qk**2)
    r12 = two_s * (qj * qk - qi * qr)
    r20 = two_s * (qi * qk - qj * qr)
    r21 = two_s * (qj * qk + qi * qr)
    r22 = 1 - two_s * (qi**2 + qj**2)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rotation_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation ``[..., 3, 3]`` -> unit quaternion ``[..., 4]`` (w,x,y,z).

    Branch-free over the four Shepperd cases (largest pivot wins); the sign
    is canonicalized to ``w >= 0`` with a strict ``<`` test, so ``w == -0.0``
    (a 180-degree rotation) stays on the +w branch.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack(
        [0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0],
        dim=-1,
    )
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack(
        [(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1],
        dim=-1,
    )
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack(
        [(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2],
        dim=-1,
    )
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack(
        [(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3],
        dim=-1,
    )

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0.0, -q, q)


def camera_from_tensor(cam: torch.Tensor) -> torch.Tensor:
    """Camera tensor ``[..., 7]`` -> c2w ``[..., 3, 4]``."""
    R = quat_to_rotation(cam[..., :4])
    return torch.cat([R, cam[..., 4:, None]], dim=-1)


def tensor_from_camera(c2w: torch.Tensor) -> torch.Tensor:
    """c2w ``[..., 3|4, 4]`` -> camera tensor ``[..., 7]``."""
    return torch.cat([rotation_to_quat(c2w[..., :3, :3]), c2w[..., :3, 3]], dim=-1)


def to_homogeneous(c2w34: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 4]`` -> ``[..., 4, 4]`` with the affine bottom row.

    The row is filled on the tensor's device: a ``torch.tensor`` of it would
    be a copy from the host that waits for the stream."""
    bottom = c2w34.new_zeros(c2w34.shape[:-2] + (1, 4))
    bottom[..., 3] = 1.0
    return torch.cat([c2w34, bottom], dim=-2)


def invert_pose(c2w: torch.Tensor) -> torch.Tensor:
    """Rigid-transform inverse of ``[..., 4, 4]``."""
    Rt = c2w[..., :3, :3].transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", Rt, c2w[..., :3, 3])
    return to_homogeneous(torch.cat([Rt, t_inv[..., None]], dim=-1))


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: twist ``[6]`` (omega, v) -> ``[4, 4]`` transform.

    Rodrigues with Taylor branches near theta = 0, selected with ``where``;
    the far branch's denominators are swapped for 1 where the Taylor branch
    is taken, so neither branch produces a non-finite value or derivative at
    the identity, where the Gauss-Newton tracker linearizes.
    """
    w, v = xi[:3], xi[3:]
    th2 = torch.sum(w * w)
    small = th2 < 1e-12
    th2_s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2_s)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2_s)
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (1.0 - A) / th2_s)
    zero = torch.zeros_like(w[0])
    K = torch.stack(
        [
            torch.stack([zero, -w[2], w[1]]),
            torch.stack([w[2], zero, -w[0]]),
            torch.stack([-w[1], w[0], zero]),
        ]
    )
    K2 = K @ K
    I = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = I + A * K + B * K2
    V = I + B * K + C * K2
    return to_homogeneous(torch.cat([R, (V @ v)[:, None]], dim=-1))


def constant_speed_warm_start(
    prev: torch.Tensor,
    prev2: torch.Tensor,
    max_t: float = 0.15,
    max_angle: float = 0.3,
) -> torch.Tensor:
    """Constant-velocity motion model ``prev @ inv(prev2) @ prev``, with the
    extrapolated delta clamped to ``max_t`` meters and ``max_angle`` radians
    (an unclamped extrapolation doubles a one-frame error every frame)."""
    delta = prev @ invert_pose(prev2)
    R, t = delta[:3, :3], delta[:3, 3]
    tn = torch.linalg.norm(t)
    t = t * torch.clamp(max_t / (tn + 1e-12), max=1.0)
    q = rotation_to_quat(R)
    half = torch.arccos(torch.clamp(q[0], -1.0, 1.0))  # theta/2
    axis = q[1:] / torch.clamp(torch.linalg.norm(q[1:]), min=1e-12)
    half_c = torch.clamp(half, max=max_angle / 2.0)
    q_c = torch.cat([torch.cos(half_c)[None], torch.sin(half_c) * axis])
    Rc = quat_to_rotation(q_c)
    return to_homogeneous(torch.cat([Rc, t[:, None]], dim=-1)) @ prev
