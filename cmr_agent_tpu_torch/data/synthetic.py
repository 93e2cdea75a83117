"""Synthetic scene generator for tests and benchmarks.

The port's own copy of the JAX package's ``data/synthetic.py``.

No reference analog (the reference has no test suite, SURVEY.md §4). Emits
raw (img, pc_cam, K) triplets that are geometrically consistent — a
structured cloud in front of a pinhole camera with a matching gradient
image — and runs them through the exact shared geometry pipeline, so every
downstream component (masks, circle-loss sampling, episode engine, cost
volume) is exercised with realistic statistics without KITTI on disk.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..config import Config
from .pipeline import build_geometry_sample


def make_synthetic_raw(rng: np.random.Generator, img_h: int, img_w: int,
                       num_pt: int):
    """Random scene: ~60% of points inside the frustum, the rest around it.

    Returns ``(img [H,W,3] float32 in [0,1], pc_cam [N,3], K [3,3])`` with
    ``K`` already at the 1/4 PnP scale of (img_h, img_w).
    """
    h4, w4 = img_h // 4, img_w // 4
    f = 1.2 * w4
    K = np.array([[f, 0, w4 / 2], [0, f, h4 / 2], [0, 0, 1]], np.float64)

    n_in = int(num_pt * 0.6)
    z = rng.uniform(2.0, 40.0, size=n_in)
    u = rng.uniform(0, w4 - 1, size=n_in)
    v = rng.uniform(0, h4 - 1, size=n_in)
    x = (u - K[0, 2]) * z / K[0, 0]
    y = (v - K[1, 2]) * z / K[1, 1]
    inside = np.stack([x, y, z], axis=1)

    n_out = num_pt - n_in
    outside = rng.normal(size=(n_out, 3)) * np.array([15.0, 3.0, 15.0])
    outside[:, 2] += 5.0
    pc = np.concatenate([inside, outside], axis=0)
    pc = pc[rng.permutation(num_pt)]

    yy, xx = np.mgrid[0:img_h, 0:img_w]
    img = np.stack([xx / img_w, yy / img_h,
                    (xx + yy) / (img_h + img_w)], axis=-1)
    img = (img + 0.1 * rng.random((img_h, img_w, 3))).clip(0, 1)
    return img.astype(np.float32), pc, K


# --------------------------------------------------------------------------
# Structured scenes: persistent ground + boxes, geometry-correlated image.
#
# The random generator above is fine for wiring tests, but at the reference
# KITTI perturbation protocol (+-10 m x/z, +-pi yaw — KittiConfig.py:19-24)
# an isotropic cloud leaves the frustum and the imitation problem becomes
# unobservable (docs/CONVERGENCE.md round 2). A structured scene covers the
# full 360-degree disc like a real drive: wherever the perturbation points
# the camera, persistent structure (ground, boxes) fills the frustum, and
# the rendered image is computed FROM the scene geometry (inverse depth /
# height / albedo channels), so cross-modal features have real signal.
# --------------------------------------------------------------------------

_GROUND_Y = 1.6      # camera height above ground, KITTI-ish (y points down)


def _make_scene(rng: np.random.Generator, n_boxes: int = 28):
    """Persistent scene parameters: boxes on a ground disc around origin."""
    r = rng.uniform(4.0, 45.0, n_boxes)
    th = rng.uniform(-np.pi, np.pi, n_boxes)
    dims = rng.uniform([1.0, 1.5, 1.0], [6.0, 7.0, 6.0], (n_boxes, 3))
    yaw = rng.uniform(-np.pi, np.pi, n_boxes)
    albedo = rng.uniform(0.25, 0.95, n_boxes)
    return {"cx": r * np.sin(th), "cz": r * np.cos(th), "dims": dims,
            "yaw": yaw, "albedo": albedo}


def _sample_scene_points(rng: np.random.Generator, scene, n: int):
    """Sample ``n`` surface points + albedo from the scene (cam space)."""
    n_ground = int(n * 0.35)
    n_box = n - n_ground

    # ground disc, checkerboard albedo (texture correlated with position)
    rr = 50.0 * np.sqrt(rng.uniform(0, 1, n_ground))
    th = rng.uniform(-np.pi, np.pi, n_ground)
    gx, gz = rr * np.sin(th), rr * np.cos(th)
    gy = np.full(n_ground, _GROUND_Y)
    g_alb = 0.35 + 0.25 * ((np.floor(gx / 2) + np.floor(gz / 2)) % 2)

    # boxes: area-weighted faces (4 sides + top)
    n_boxes = len(scene["yaw"])
    box_id = rng.integers(0, n_boxes, n_box)
    w, h, d = (scene["dims"][box_id, i] for i in range(3))
    areas = np.stack([h * d, h * d, w * h, w * h, w * d], axis=1)
    u = rng.uniform(-0.5, 0.5, n_box)
    v = rng.uniform(-0.5, 0.5, n_box)
    csum = np.cumsum(areas, axis=1)
    pick = rng.uniform(0, 1, n_box) * csum[:, -1]
    face = (pick[:, None] > csum).sum(axis=1)

    lx = np.where(face == 0, 0.5 * w, np.where(face == 1, -0.5 * w, u * w))
    lz = np.where(face == 2, 0.5 * d, np.where(face == 3, -0.5 * d,
                  np.where(face == 4, v * d, v * d)))
    up = np.where(face < 2, (u + 0.5) * h,
                  np.where(face < 4, (v + 0.5) * h, h))   # height above ground
    c, s = np.cos(scene["yaw"][box_id]), np.sin(scene["yaw"][box_id])
    bx = scene["cx"][box_id] + c * lx + s * lz
    bz = scene["cz"][box_id] - s * lx + c * lz
    by = _GROUND_Y - up
    b_alb = scene["albedo"][box_id] + rng.normal(0, 0.03, n_box)

    pts = np.concatenate([np.stack([gx, gy, gz], 1),
                          np.stack([bx, by, bz], 1)]).astype(np.float64)
    alb = np.concatenate([g_alb, b_alb]).clip(0, 1)
    perm = rng.permutation(n)
    return pts[perm], alb[perm]


def _render_scene(points, albedo, K_full, img_h: int, img_w: int,
                  rng: np.random.Generator):
    """Z-buffer point splat -> [H,W,3] image: inverse depth / height above
    ground / albedo. One dilation pass fills splat holes."""
    z = points[:, 2]
    m = z > 0.5
    p, a = points[m], albedo[m]
    u = np.rint(K_full[0, 0] * p[:, 0] / p[:, 2] + K_full[0, 2]).astype(int)
    v = np.rint(K_full[1, 1] * p[:, 1] / p[:, 2] + K_full[1, 2]).astype(int)
    ok = (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
    p, a, u, v = p[ok], a[ok], u[ok], v[ok]
    order = np.argsort(-p[:, 2])          # far -> near; nearest wins
    u, v, p, a = u[order], v[order], p[order], a[order]

    img = np.zeros((img_h, img_w, 3), np.float32)
    img[v, u, 0] = np.clip(4.0 / p[:, 2], 0, 1)
    img[v, u, 1] = np.clip((_GROUND_Y - p[:, 1]) / 8.0 + 0.1, 0, 1)
    img[v, u, 2] = a
    filled = img.max(axis=-1) > 0
    for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):   # fill splat holes
        shifted = np.roll(img, (dy, dx), axis=(0, 1))
        sf = np.roll(filled, (dy, dx), axis=(0, 1))
        take = (~filled) & sf
        img[take] = shifted[take]
        filled |= take
    img += 0.02 * rng.random(img.shape).astype(np.float32)
    return img.clip(0, 1)


def make_structured_raw(rng: np.random.Generator, img_h: int, img_w: int,
                        num_pt: int):
    """Structured scene sample: 360-degree cloud + rendered image.

    Same contract as :func:`make_synthetic_raw` (``K`` at 1/4 PnP scale),
    but the cloud and image are two independent samplings of ONE persistent
    scene, so features must encode scene structure rather than frustum
    position — and +-10 m / +-pi perturbations always leave structure in
    view.
    """
    h4, w4 = img_h // 4, img_w // 4
    f = 1.2 * w4
    K = np.array([[f, 0, w4 / 2], [0, f, h4 / 2], [0, 0, 1]], np.float64)
    K_full = K.copy()
    K_full[:2] *= 4.0

    scene = _make_scene(rng)
    pc, _ = _sample_scene_points(rng, scene, num_pt)
    render_pts, render_alb = _sample_scene_points(
        rng, scene, min(4 * num_pt, 200_000))
    img = _render_scene(render_pts, render_alb, K_full, img_h, img_w, rng)
    return img.astype(np.float32), pc, K


def sample_settings(cfg: Config) -> tuple:
    """Every ``Config`` value a sample depends on, as ``(name, value)``
    pairs: a :class:`SyntheticDataset` sample reads its config only
    through this, so two configs with equal settings give equal samples
    (the key of ``serve``'s batch cache)."""
    return (("img_hw", (cfg.cropped_img_h, cfg.cropped_img_w)),
            ("num_pt", cfg.num_pt), ("num_node", cfg.num_node),
            ("circle_loss_num", cfg.circle_loss_num),
            ("t_amplitude", (cfg.p_tx_amplitude, cfg.p_ty_amplitude,
                             cfg.p_tz_amplitude)),
            ("r_amplitude", (cfg.p_rx_amplitude, cfg.p_ry_amplitude,
                             cfg.p_rz_amplitude)),
            ("nlabel", cfg.nlabel),
            ("knn_k", cfg.knn_k if cfg.use_gnn_embedding else 0))


class SyntheticDataset:
    """Map-style synthetic dataset running the real geometry pipeline.

    ``scene='random'`` (default) keeps the historical unstructured
    generator; ``scene='structured'`` uses the persistent ground+boxes
    scene that stays observable at the full reference perturbation
    protocol.
    """

    def __init__(self, cfg: Config, length: int = 64, seed: int = 0,
                 fps_fn=None, nn_fn=None, scene: str = "random"):
        self.cfg = cfg
        self.settings = dict(sample_settings(cfg))
        self.length = length
        self.seed = seed
        self.fps_fn = fps_fn
        self.nn_fn = nn_fn
        self.scene = scene
        self._epoch = 0

    def __len__(self) -> int:
        return self.length

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        st = self.settings
        # epoch folds into the stream like the real datasets (kitti.py:117);
        # epoch 0 keeps the historical (seed, index) key so fixed-seed
        # benchmarks/demos are unchanged
        key = ((self.seed, index) if self._epoch == 0
               else (self.seed, self._epoch, index))
        rng = np.random.default_rng(key)
        raw = (make_structured_raw if self.scene == "structured"
               else make_synthetic_raw)
        img, pc, K = raw(rng, *st["img_hw"], st["num_pt"])
        return build_geometry_sample(
            rng, img, pc, K,
            num_node=st["num_node"],
            circle_loss_num=st["circle_loss_num"],
            t_amplitude=st["t_amplitude"], r_amplitude=st["r_amplitude"],
            nlabel=st["nlabel"],
            fps_fn=self.fps_fn, nn_fn=self.nn_fn, knn_k=st["knn_k"])
