"""Shared per-sample geometry pipeline (pure numpy, RNG threaded explicitly).

The port's own copy of the JAX package's ``data/pipeline.py``: the same
functions, so that the same seed gives bit-identical samples in both.

Reproduces the math of the reference datasets' ``__getitem__``
(dataset/KittiDataset.py:258-423) as composable functions:

  downsample -> (resize/crop handled per dataset) -> project + masks ->
  circle-loss sampling -> random SE(3) perturbation -> FPS nodes ->
  1-NN point->node assignment -> sample dict.

Extensions over the reference (SURVEY.md §2.4 drift fixes):

* emits ``point_xy_float_all`` (needed by the matching-IR eval,
  Test_Geo.py:94) and the cost-volume keys ``R_amplitude / T_amplitude /
  label_R / label_T_x / label_T_z`` (needed by IterModel.py:134-135,
  175-177) which no reference dataset produces;
* circle-loss sampling is static-shape: when fewer than ``num`` in-view
  points exist the indices are padded by resampling (the reference would
  emit a ragged tensor and crash at collation).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


# --------------------------------------------------------------------------
# Camera helpers
# --------------------------------------------------------------------------

def camera_matrix_scaling(K: np.ndarray, s: float) -> np.ndarray:
    K = s * K
    K[2, 2] = 1.0
    return K


def camera_matrix_cropping(K: np.ndarray, dx: float, dy: float) -> np.ndarray:
    K = np.copy(K)
    K[0, 2] -= dx
    K[1, 2] -= dy
    return K


# --------------------------------------------------------------------------
# Random rigid perturbation
# --------------------------------------------------------------------------

def angles_to_rotation_matrix(angles) -> np.ndarray:
    """Rz @ Ry @ Rx from (rx, ry, rz) (KittiDataset.py:220-231)."""
    rx, ry, rz = angles
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def random_transform(rng: np.random.Generator, t_amp, r_amp):
    """Random SE(3) perturbation; ``t_amp``/``r_amp`` are (x, y, z) triples.

    Returns ``(P [4,4], angles [3], t [3])`` (KittiDataset.py:238-253).
    """
    t = np.array([rng.uniform(-a, a) if a > 0 else 0.0 for a in t_amp])
    angles = np.array([rng.uniform(-a, a) if a > 0 else 0.0 for a in r_amp])
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = angles_to_rotation_matrix(angles)
    P[:3, 3] = t
    return P, angles.astype(np.float32), t.astype(np.float32)


# --------------------------------------------------------------------------
# Point cloud helpers
# --------------------------------------------------------------------------

def downsample_indices(rng: np.random.Generator, n_in: int,
                       n_out: int) -> np.ndarray:
    """Random choice without replacement; repeat-pad when too few
    (KittiDataset.py:182-196)."""
    if n_in >= n_out:
        return rng.choice(n_in, n_out, replace=False)
    fix = np.arange(n_in)
    while n_in + fix.shape[0] < n_out:
        fix = np.concatenate([fix, np.arange(n_in)])
    extra = rng.choice(n_in, n_out - fix.shape[0], replace=False)
    return np.concatenate([fix, extra])


def farthest_point_sample_np(rng: np.random.Generator, pts: np.ndarray,
                             k: int) -> np.ndarray:
    """Host FPS on ``[N, 3]`` points -> index array ``[k]``
    (KittiDataset.py:107-126).
    """
    n = pts.shape[0]
    idxs = np.zeros(k, dtype=np.int64)
    idxs[0] = rng.integers(n)
    d = np.sum((pts - pts[idxs[0]]) ** 2, axis=1)
    for i in range(1, k):
        far = int(np.argmax(d))
        idxs[i] = far
        d = np.minimum(d, np.sum((pts - pts[far]) ** 2, axis=1))
    return idxs


def nearest_assign_np(points: np.ndarray, centers: np.ndarray,
                      block: int = 8192) -> np.ndarray:
    """Brute-force 1-NN (cKDTree replacement), blocked to bound memory."""
    out = np.empty(points.shape[0], dtype=np.int64)
    c2 = np.sum(centers**2, axis=1)
    for s in range(0, points.shape[0], block):
        p = points[s:s + block]
        d = p @ centers.T * (-2.0) + np.sum(p**2, axis=1)[:, None] + c2[None]
        out[s:s + block] = np.argmin(d, axis=1)
    return out


# --------------------------------------------------------------------------
# Projection, masks, circle-loss sampling
# --------------------------------------------------------------------------

def project_and_masks(pc: np.ndarray, K: np.ndarray, img_h: int, img_w: int):
    """Project ``[N,3]`` cam-space points; in-picture mask + pixel raster.

    Uses the reference's rounded-coordinate bound test
    (KittiDataset.py:314-341). Returns ``(xy_float [2,N], pc_mask [N] bool,
    img_mask [img_h, img_w] int)``.
    """
    proj = K @ pc.T                       # [3, N]
    z = proj[2]
    with np.errstate(divide="ignore", invalid="ignore"):
        xy = proj[:2] / np.where(np.abs(z) < 1e-12, 1e-12, z)
    xy_round = np.round(xy)
    in_pic = ((xy_round[0] >= 0) & (xy_round[0] <= img_w - 1)
              & (xy_round[1] >= 0) & (xy_round[1] <= img_h - 1) & (z > 0))
    img_mask = np.zeros((img_h, img_w), dtype=np.int64)
    xs = xy_round[0, in_pic].astype(np.int64)
    ys = xy_round[1, in_pic].astype(np.int64)
    img_mask[ys, xs] = 1
    return xy.astype(np.float32), in_pic, img_mask


def sample_circle_loss_points(rng: np.random.Generator, xy_float: np.ndarray,
                              in_pic: np.ndarray, num: int):
    """Sample ``num`` in-view points for the circle loss
    (KittiDataset.py:343-348), padded to a static shape.

    Returns ``(idx [num], xy_float [2,num], xy_int [2,num])``.
    """
    candidates = np.where(in_pic)[0]
    if candidates.size == 0:
        candidates = np.arange(xy_float.shape[1])
    perm = rng.permutation(candidates.size)[:num]
    idx = candidates[perm]
    if idx.size < num:  # static-shape pad by resampling (deviation, doc'd)
        pad = rng.choice(candidates, num - idx.size, replace=True)
        idx = np.concatenate([idx, pad])
    xy_f = xy_float[:, idx]
    xy_i = np.round(xy_f).astype(np.int64)
    return idx.astype(np.int64), xy_f.astype(np.float32), xy_i


# --------------------------------------------------------------------------
# IterModel (cost volume) label reconstruction — SURVEY.md §2.4
# --------------------------------------------------------------------------

def cost_volume_labels(angles: np.ndarray, translation: np.ndarray,
                       r_amplitude: float, t_amplitude: float, nlabel: int):
    """One-hot grid labels for the pose-hypothesis cost volume.

    The hypothesis grid spans ``[-amp, amp]`` in ``nlabel`` steps
    (IterModel.py:137-148); the label marks the grid cell nearest the true
    perturbation (ry, tx, tz) — the keys the committed reference datasets
    never emitted.
    """
    base = np.arange(-(nlabel - 1) // 2, (nlabel - 1) // 2 + 1, dtype=np.float64)
    r_grid = 2.0 * r_amplitude / (nlabel - 1) * base
    t_grid = 2.0 * t_amplitude / (nlabel - 1) * base

    def onehot(val, grid):
        v = np.zeros(nlabel, dtype=np.float32)
        v[int(np.abs(grid - val).argmin())] = 1.0
        return v

    return (onehot(angles[1], r_grid), onehot(translation[0], t_grid),
            onehot(translation[2], t_grid))


# --------------------------------------------------------------------------
# Sample assembly
# --------------------------------------------------------------------------

def build_geometry_sample(
    rng: np.random.Generator,
    img: np.ndarray,            # [H, W, 3] float32 in [0,1]
    pc_cam: np.ndarray,         # [N, 3] camera-space points (downsampled)
    K: np.ndarray,              # [3, 3] intrinsics at the 1/4 PnP scale
    *,
    num_node: int,
    circle_loss_num: int,
    t_amplitude,
    r_amplitude,
    nlabel: int,
    fps_fn=None,
    nn_fn=None,
    knn_k: int = 0,
) -> Dict[str, np.ndarray]:
    """Geometry half of ``__getitem__`` shared by every dataset.

    ``img`` must already be resized/cropped/augmented; ``K`` already at the
    projection scale. ``t_amplitude``/``r_amplitude`` are (x,y,z) triples.
    ``fps_fn(rng, pts, k)`` / ``nn_fn(points, centers)`` allow swapping in
    faster implementations of the same recurrences.
    """
    fps_fn = fps_fn or farthest_point_sample_np
    nn_fn = nn_fn or nearest_assign_np

    img_h = int(round(img.shape[0] * 0.25))
    img_w = int(round(img.shape[1] * 0.25))

    pc_in_cam_space = pc_cam.astype(np.float32)
    xy_float, in_pic, img_mask = project_and_masks(pc_cam, K, img_h, img_w)
    idx_cl, xy_f_cl, xy_i_cl = sample_circle_loss_points(
        rng, xy_float, in_pic, circle_loss_num)

    P_rand, angles, t = random_transform(rng, t_amplitude, r_amplitude)
    pc = (P_rand[:3, :3] @ pc_cam.T + P_rand[:3, 3:]).T.astype(np.float32)

    n = pc.shape[0]
    sub = rng.choice(n, min(num_node * 8, n), replace=False)
    node_idx = fps_fn(rng, pc[sub], num_node)
    node = pc[sub[node_idx]]
    pt2node = nn_fn(pc, node)

    label_r, label_tx, label_tz = cost_volume_labels(
        angles, t, float(max(r_amplitude)), float(max(t_amplitude)), nlabel)

    extra = {}
    if knn_k > 0:
        # host knn of the perturbed cloud for the gnn-embedding variant
        # (reference dataset/KittiDataset.py:362-367 True-branch)
        from scipy.spatial import cKDTree
        _, knn_idx = cKDTree(pc).query(pc, k=knn_k)
        extra["pc_knn"] = knn_idx.astype(np.int32)

    return {
        **extra,
        "img": img.astype(np.float32),
        "pc": pc,
        "K": K.astype(np.float32),
        "P": np.linalg.inv(P_rand).astype(np.float32),
        "img_mask": img_mask.astype(np.int32),
        "pc_mask": in_pic.astype(np.int32),
        "pc_idx_for_circle_loss": idx_cl.astype(np.int32),
        "pc_xy_float_for_circle_loss": xy_f_cl,
        "pc_xy_int_for_circle_loss": xy_i_cl.astype(np.int32),
        "pc_in_cam_space": pc_in_cam_space,
        "pt2node": pt2node.astype(np.int32),
        "node": node.astype(np.float32),
        "angles": angles,
        "translation": t,
        # §2.4 drift fixes:
        "point_xy_float_all": xy_float,
        "R_amplitude": np.float32(max(r_amplitude)),
        "T_amplitude": np.float32(max(t_amplitude)),
        "label_R": label_r,
        "label_T_x": label_tx,
        "label_T_z": label_tz,
    }
