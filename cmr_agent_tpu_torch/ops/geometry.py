"""SE(3), euler-angle and camera-projection ops used by the serving episode.

PyTorch twins of the JAX package's ``ops/geometry.py`` (same names, same
``[..., N, 3]`` point layout, same conventions):

* ``euler_angles_to_matrix_xyz`` is the torch-style
  ``euler_angles_to_matrix(e, 'XYZ')`` = ``Rx @ Ry @ Rz`` used by the
  environment step (reference environment/environment.py:210-232).
"""

from __future__ import annotations

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
