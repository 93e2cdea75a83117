"""KITTI odometry image <-> LiDAR dataset (the port's copy of the JAX
package's ``data/kitti.py``; reference dataset/KittiDataset.py:62-423).

Calib parsing, train (sequences 0-8) / val / test (9-10) splits with both
the P2 and the P3 camera, half-res resize, the 160 x 512 crop (random in
train, centred otherwise), 1/4-scale PnP intrinsics, colour jitter in
train, and the shared geometry pipeline. Samples come out channels-last
and equal the JAX package's array for array: the resize and the jitter
are :mod:`.augment`'s numpy copies of OpenCV's and Pillow's arithmetic,
and every draw comes from the per-sample generator ``(seed, epoch,
index)`` in the same order.

On disk: ``<root>/calib/<seq>/calib.txt``,
``<root>/<data_color>/sequences/<seq>/image_{2,3}/%06d.npy`` (uint8
H x W x 3) and ``<root>/<data_velodyne>/sequences/<seq>/
voxel0.1-SNr0.6/%06d.npy`` (rows 0-2 are the velodyne xyz).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from ..config import Config
from .augment import color_jitter, resize_image
from .pipeline import (build_geometry_sample, camera_matrix_cropping,
                       camera_matrix_scaling, downsample_indices)


def parse_calib_line(text: str) -> np.ndarray:
    """The 12 numbers of one ``calib.txt`` row as a 3 x 4 f64 matrix
    (Python's correctly rounded ``float``, the values of the JAX package's
    ``np.fromstring(..., sep=" ")``)."""
    return np.array([float(v) for v in text.split()],
                    dtype=np.float64).reshape(3, 4)


class KittiCalib:
    """Parse ``calib/<seq>/calib.txt`` into per-camera K, translation-only
    extrinsics and the velodyne->camera ``Tr`` (KittiDataset.py:62-104).

    KITTI's P matrices are ``K [R|t]`` with R=I; the translation in metres
    is recovered as ``tz = P[2,3]``, ``tx = (P[0,3] - cx tz)/fx``,
    ``ty = (P[1,3] - cy tz)/fy``.
    """

    def __init__(self, root_path: str):
        self.matrices: Dict[int, Dict[str, np.ndarray]] = {}
        calib_dir = os.path.join(root_path, "calib")
        if not os.path.isdir(calib_dir):
            return
        for seq_name in sorted(os.listdir(calib_dir)):
            path = os.path.join(calib_dir, seq_name, "calib.txt")
            if not os.path.isfile(path):
                continue
            seq = int(seq_name)
            self.matrices[seq] = {}
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    key = line[:2]
                    mat = parse_calib_line(line[4:]).astype(np.float32)
                    if key == "Tr":
                        T = np.eye(4, dtype=np.float32)
                        T[:3, :] = mat
                        self.matrices[seq][key] = T
                    else:
                        K = mat[:3, :3]
                        self.matrices[seq][key + "_K"] = K
                        fx, fy = K[0, 0], K[1, 1]
                        cx, cy = K[0, 2], K[1, 2]
                        tz = mat[2, 3]
                        tx = (mat[0, 3] - cx * tz) / fx
                        ty = (mat[1, 3] - cy * tz) / fy
                        T = np.eye(4, dtype=np.float32)
                        T[:3, 3] = (tx, ty, tz)
                        self.matrices[seq][key] = T

    def get(self, seq: int, key: str) -> np.ndarray:
        return self.matrices[seq][key]


def make_kitti_split(root: str, data_color: str, data_velodyne: str,
                     mode: str) -> List[Tuple[str, str, int, int, str]]:
    """(img_folder, pc_folder, seq, frame, cam) tuples; train=seqs 0-8,
    val/test=9-10, val capped at 100 frames; P2+P3 per frame
    (KittiDataset.py:159-180)."""
    seqs = list(range(9)) if mode == "train" else [9, 10]
    entries = []
    for seq in seqs:
        img2 = os.path.join(root, data_color, "sequences/", "%02d" % seq,
                            "image_2")
        img3 = os.path.join(root, data_color, "sequences/", "%02d" % seq,
                            "image_3")
        pc_folder = os.path.join(root, data_velodyne, "sequences/",
                                 "%02d" % seq, "voxel0.1-SNr0.6")
        if not os.path.isdir(img2):
            continue
        num = len(os.listdir(img2))
        if mode == "val":
            num = min(num, 100)
        for i in range(num):
            entries.append((img2, pc_folder, seq, i, "P2"))
            entries.append((img3, pc_folder, seq, i, "P3"))
    return entries


class KittiDataset:
    """Map-style dataset; ``__getitem__(i)`` -> dict of numpy arrays."""

    def __init__(self, cfg: Config, mode: str, fps_fn=None, nn_fn=None):
        assert mode in ("train", "val", "test")
        self.cfg = cfg
        self.mode = mode
        self.fps_fn = fps_fn
        self.nn_fn = nn_fn
        self.entries = make_kitti_split(cfg.dataset_root, cfg.data_color,
                                        cfg.data_velodyne, mode)
        self.calib = KittiCalib(cfg.dataset_root)
        self._epoch_seed = 0

    def __len__(self) -> int:
        return len(self.entries)

    def set_epoch(self, epoch: int) -> None:
        self._epoch_seed = epoch

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        img_folder, pc_folder, seq, frame, cam = self.entries[index]
        rng = np.random.default_rng((cfg.seed, self._epoch_seed, index))

        img = np.load(os.path.join(img_folder, "%06d.npy" % frame))
        data = np.load(os.path.join(pc_folder, "%06d.npy" % frame))
        pc = data[0:3, :]

        # velodyne -> camera
        P_Tr = (self.calib.get(seq, cam) @ self.calib.get(seq, "Tr"))
        pc = (P_Tr[:3, :3] @ pc + P_Tr[:3, 3:]).T     # [N, 3]
        K = self.calib.get(seq, cam + "_K").copy()

        pc = pc[downsample_indices(rng, pc.shape[0], cfg.num_pt)]

        # half-res resize + K scale (KittiDataset.py:290-294)
        img = resize_image(img, 0.5)
        K = camera_matrix_scaling(K, 0.5)

        # crop to the training window + K crop (KittiDataset.py:297-309)
        if self.mode == "train":
            dx = int(rng.integers(0, img.shape[1] - cfg.cropped_img_w + 1))
            dy = int(rng.integers(0, img.shape[0] - cfg.cropped_img_h + 1))
        else:
            dx = (img.shape[1] - cfg.cropped_img_w) // 2
            dy = (img.shape[0] - cfg.cropped_img_h) // 2
        img = img[dy:dy + cfg.cropped_img_h, dx:dx + cfg.cropped_img_w]
        K = camera_matrix_cropping(K, dx=dx, dy=dy)
        K = camera_matrix_scaling(K, 0.25)  # PnP at 1/4 scale

        if self.mode == "train":
            img = color_jitter(rng, img)

        img = img.astype(np.float32) / 255.0

        return build_geometry_sample(
            rng, img, pc.astype(np.float64), K,
            num_node=cfg.num_node,
            circle_loss_num=cfg.circle_loss_num,
            t_amplitude=(cfg.p_tx_amplitude, cfg.p_ty_amplitude,
                         cfg.p_tz_amplitude),
            r_amplitude=(cfg.p_rx_amplitude, cfg.p_ry_amplitude,
                         cfg.p_rz_amplitude),
            nlabel=cfg.nlabel,
            fps_fn=self.fps_fn, nn_fn=self.nn_fn,
            knn_k=cfg.knn_k if cfg.use_gnn_embedding else 0)
