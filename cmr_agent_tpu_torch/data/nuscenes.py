"""NuScenes pre-dumped dataset (the port's copy of the JAX package's
``data/nuscenes.py``; reference dataset/NuScenesDataset.py:47-305).

Pre-dumped ``train|test/{PC,img,K}/%06d.npy`` triplets, intensity kept
through the downsample (``pc_intensity``), no crop (images are pre-cropped
to 160x320), K scaled straight to the 1/4 PnP scale, colour jitter in
train, val split capped at 400 samples; the per-sample generator is
``(seed, epoch, index, 1)``.

As in the JAX package, the reference's blocking
``o3d.visualization.draw_geometries`` call inside ``__getitem__``
(NuScenesDataset.py:252-255) is not reproduced, and the per-sample
amplitude menus (``T_list``/``R_list``, NuScenesDataset.py:63-70, defined
but never called in the committed ``__getitem__``) are exposed via
``use_amplitude_menu``; they drive the cost-volume labels.
"""

from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np

from ..config import Config
from .augment import color_jitter
from .pipeline import (build_geometry_sample, camera_matrix_scaling,
                       downsample_indices)

TRAIN_T_LIST = (0.5, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)
TRAIN_R_LIST = (0.9, 1.8, 3.6, 7.2, 14.4, 28.8, 57.6, 115.2, 180)
EVAL_T_LIST = (10.0,)
EVAL_R_LIST = (180.0,)


class NuScenesDataset:
    def __init__(self, cfg: Config, mode: str, use_amplitude_menu: bool = False,
                 fps_fn=None, nn_fn=None):
        assert mode in ("train", "val", "test")
        self.cfg = cfg
        self.mode = mode
        self.use_amplitude_menu = use_amplitude_menu
        self.fps_fn = fps_fn
        self.nn_fn = nn_fn
        sub = "train" if mode == "train" else "test"
        self.pc_path = os.path.join(cfg.dataset_root, sub, "PC")
        self.img_path = os.path.join(cfg.dataset_root, sub, "img")
        self.k_path = os.path.join(cfg.dataset_root, sub, "K")
        self.length = (len(os.listdir(self.pc_path))
                       if os.path.isdir(self.pc_path) else 0)
        if mode == "val":
            self.length = min(self.length, 400)
        self.t_list = TRAIN_T_LIST if mode == "train" else EVAL_T_LIST
        self.r_list = TRAIN_R_LIST if mode == "train" else EVAL_R_LIST
        self._epoch_seed = 0

    def __len__(self) -> int:
        return self.length

    def set_epoch(self, epoch: int) -> None:
        self._epoch_seed = epoch

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self._epoch_seed, index, 1))

        data = np.load(os.path.join(self.pc_path, "%06d.npy" % index))
        img = np.load(os.path.join(self.img_path, "%06d.npy" % index))
        K = np.load(os.path.join(self.k_path, "%06d.npy" % index)).astype(
            np.float64)

        pc = data[0:3, :].T                     # [N, 3]
        # intensity rides through the downsample with the same indices
        # (reference NuScenesDataset.py:100-111, which then drops it)
        intensity = (data[3, :] if data.shape[0] > 3
                     else np.zeros(pc.shape[0], data.dtype))
        idx = downsample_indices(rng, pc.shape[0], cfg.num_pt)
        pc = pc[idx]
        intensity = intensity[idx].astype(np.float32)

        K = camera_matrix_scaling(K, 0.25)
        if self.mode == "train":
            img = color_jitter(rng, img)
        img = img.astype(np.float32) / 255.0

        if self.use_amplitude_menu:
            t_amp = float(rng.choice(self.t_list))
            r_amp = float(rng.choice(self.r_list)) / 180.0 * math.pi
        else:
            t_amp = cfg.p_tx_amplitude
            r_amp = cfg.p_ry_amplitude

        sample = build_geometry_sample(
            rng, img, pc.astype(np.float64), K,
            num_node=cfg.num_node,
            circle_loss_num=cfg.circle_loss_num,
            t_amplitude=(t_amp, 0.0, t_amp),
            r_amplitude=(0.0, r_amp, 0.0),
            nlabel=cfg.nlabel,
            fps_fn=self.fps_fn, nn_fn=self.nn_fn,
            knn_k=cfg.knn_k if cfg.use_gnn_embedding else 0)
        sample["pc_intensity"] = intensity
        return sample
