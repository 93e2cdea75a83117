"""SE(3), euler-angle and camera-projection ops used by the episodes.

PyTorch twins of the JAX package's ``ops/geometry.py`` (same names, same
``[..., N, 3]`` point layout, same conventions):

* ``euler_angles_to_matrix_xyz`` is the torch-style
  ``euler_angles_to_matrix(e, 'XYZ')`` = ``Rx @ Ry @ Rz`` used by the
  environment step (reference environment/environment.py:210-232);
* ``matrix_to_euler_xyz_extrinsic`` (the expert's delta) and
  ``matrix_to_euler_intrinsic_xyz_degrees`` (``pose_diff``) are scipy's
  ``as_euler('xyz')`` and ``as_euler('XYZ', degrees=True)`` in closed form,
  with the gimbal-lock branches of the JAX package;
* ``angle2matrix_sxyz`` is the transforms3d-style extrinsic-xyz
  ``Rz @ Ry @ Rx`` of the cost volume's pose grid (reference
  models/IterModel.py:95-130), with ``make_se3``, ``se3_inverse`` and the
  entangled ``transform_points`` beside it;
* ``project_points_cn`` and ``frustum_mask_cn`` are the channel-major
  ``[B, 3, N]`` twins of the fused-stack eval episode.
"""

from __future__ import annotations

import math

import torch


def axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices about a named axis; ``angle`` of any shape ->
    ``(..., 3, 3)`` (reference environment/environment.py:235-260)."""
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError(f"invalid axis {axis!r}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix_xyz(euler: torch.Tensor) -> torch.Tensor:
    """``euler (..., 3)`` radians -> ``Rx @ Ry @ Rz`` ``(..., 3, 3)``."""
    rx = axis_angle_rotation("X", euler[..., 0])
    ry = axis_angle_rotation("Y", euler[..., 1])
    rz = axis_angle_rotation("Z", euler[..., 2])
    return rx @ ry @ rz


def angle2matrix_sxyz(euler: torch.Tensor) -> torch.Tensor:
    """Extrinsic-xyz ``euler (..., 3)`` radians -> ``Rz @ Ry @ Rx``
    (scipy ``from_euler('xyz')``, transforms3d ``'sxyz'``)."""
    rx = axis_angle_rotation("X", euler[..., 0])
    ry = axis_angle_rotation("Y", euler[..., 1])
    rz = axis_angle_rotation("Z", euler[..., 2])
    return rz @ ry @ rx


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 3)`` + ``(..., 3)`` -> ``(..., 4, 4)`` homogeneous
    transform."""
    T = R.new_zeros(R.shape[:-2] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)
    return T


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_se3(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def transform_points(pc: torch.Tensor, R: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """``R p + t`` on points ``[..., N, 3]`` (entangled)."""
    return torch.einsum("...ij,...nj->...ni", R, pc) + t[..., None, :]


_GIMBAL_EPS = 1e-7


def matrix_to_euler_xyz_extrinsic(R: torch.Tensor) -> torch.Tensor:
    """``R = Rz Ry Rx`` ``(..., 3, 3)`` -> ``(ax, ay, az)`` radians
    (geometry.py:77-101): ``ay = -asin(R20)``, ``ax = atan2(R21, R22)``,
    ``az = atan2(R10, R00)``; at gimbal lock (``|cos ay| < 1e-7``)
    ``ax = 0`` and ``az = atan2(-R01, R11)``, scipy's convention."""
    ay = -torch.asin(R[..., 2, 0].clamp(-1.0, 1.0))
    locked = torch.cos(ay).abs() < _GIMBAL_EPS
    ax = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    az = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    ax = torch.where(locked, torch.zeros_like(ax), ax)
    az = torch.where(locked, torch.atan2(-R[..., 0, 1], R[..., 1, 1]), az)
    return torch.stack([ax, ay, az], dim=-1)


def matrix_to_euler_intrinsic_xyz_degrees(R: torch.Tensor) -> torch.Tensor:
    """``R = Rx Ry Rz`` -> intrinsic-XYZ angles in degrees
    (geometry.py:104-123): ``ay = asin(R02)``, ``ax = atan2(-R12, R22)``,
    ``az = atan2(-R01, R00)``; at gimbal lock ``az = 0`` and
    ``ax = atan2(R21, R11)``."""
    ay = torch.asin(R[..., 0, 2].clamp(-1.0, 1.0))
    locked = torch.cos(ay).abs() < _GIMBAL_EPS
    ax = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    az = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    ax = torch.where(locked, torch.atan2(R[..., 2, 1], R[..., 1, 1]), ax)
    az = torch.where(locked, torch.zeros_like(az), az)
    return torch.stack([ax, ay, az], dim=-1) * (180.0 / math.pi)


def pose_diff(P_pred: torch.Tensor, P_gt: torch.Tensor):
    """``(RTE, RRE)``: the L2 translation error and the sum of
    ``|intrinsic-XYZ angles|`` (degrees) of ``R_pred R_gt^T``
    (geometry.py:230-241; reference Test_Agent.py:99-105)."""
    r_rel = P_pred[..., :3, :3] @ P_gt[..., :3, :3].transpose(-1, -2)
    rre = matrix_to_euler_intrinsic_xyz_degrees(r_rel).abs().sum(dim=-1)
    rte = torch.linalg.norm(P_pred[..., :3, 3] - P_gt[..., :3, 3], dim=-1)
    return rte, rre


def transform_points_disentangled(pc: torch.Tensor, R: torch.Tensor,
                                  t: torch.Tensor) -> torch.Tensor:
    """``p' = R (p - mean) + mean + t`` about the cloud centroid
    (reference environment/environment.py:52-56, 91-93)."""
    mean = pc.mean(dim=-2, keepdim=True)
    return (torch.einsum("...ij,...nj->...ni", R, pc - mean) + mean
            + t[..., None, :])


def to_disentangled(pose: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Fold rotation-about-centroid into the translation (paper eq. 11):
    ``t' = t - mean + R @ mean`` (reference environment/environment.py:14-21).

    ``pose [..., 4, 4]``, ``pc [..., N, 3]``; returns a new pose.
    """
    mean = pc.mean(dim=-2)
    R = pose[..., :3, :3]
    t = pose[..., :3, 3]
    out = pose.clone()
    out[..., :3, 3] = t - mean + torch.einsum("...ij,...j->...i", R, mean)
    return out


def project_points(pc: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pinhole projection ``[..., N, 3] x [..., 3, 3] -> [..., N, 3]``:
    ``(x/z, y/z, z)``; combine with :func:`frustum_mask`."""
    proj = torch.einsum("...ij,...nj->...ni", K, pc)
    z = proj[..., 2:3]
    xy = proj[..., 0:2] / torch.where(z.abs() < 1e-10,
                                      torch.full_like(z, 1e-10), z)
    return torch.cat([xy, z], dim=-1)


def frustum_mask(xyz: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """In-image test on unrounded projected ``(x, y, z)``: inclusive
    ``[0, w-1] x [0, h-1]`` and ``z > 0`` (environment.py:61-65)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return (x >= 0) & (x <= (w - 1)) & (y >= 0) & (y <= (h - 1)) & (z > 0)


def project_points_cn(pcT: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Channel-major :func:`project_points`: ``[B, 3, N] -> [B, 3, N]``
    ``(x/z, y/z, z)`` (geometry.py:209-221)."""
    proj = torch.einsum("bij,bjn->bin", K, pcT)
    z = proj[:, 2:3]
    xy = proj[:, 0:2] / torch.where(z.abs() < 1e-10, torch.full_like(z, 1e-10),
                                    z)
    return torch.cat([xy, z], dim=1)


def frustum_mask_cn(projT: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """:func:`frustum_mask` on channel-major ``[B, 3, N]`` -> ``[B, N]``."""
    x, y, z = projT[:, 0], projT[:, 1], projT[:, 2]
    return (x >= 0) & (x <= (w - 1)) & (y >= 0) & (y <= (h - 1)) & (z > 0)
