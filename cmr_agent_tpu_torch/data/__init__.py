"""Host data pipelines (KITTI / NuScenes / synthetic), numpy and scipy
only (counterpart of the JAX package's ``data/__init__.py``, whose names
it exports); ``shard_batch`` puts a batch on the device (torch is imported
inside it).

The geometry lives in pure-numpy functions (:mod:`.pipeline`) shared by
every dataset; the image resize and colour jitter (:mod:`.augment`) are
numpy copies of OpenCV's and Pillow's arithmetic. Samples come out
channels-last (NHWC images); the caller moves batches to its device.
"""

from typing import Dict, Sequence

import numpy as np


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into one batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


from .pipeline import (  # noqa: E402
    downsample_indices,
    camera_matrix_scaling,
    camera_matrix_cropping,
    angles_to_rotation_matrix,
    random_transform,
    project_and_masks,
    sample_circle_loss_points,
    farthest_point_sample_np,
    nearest_assign_np,
    build_geometry_sample,
    cost_volume_labels,
)
from .kitti import KittiCalib, KittiDataset  # noqa: E402
from .nuscenes import NuScenesDataset  # noqa: E402
from .synthetic import SyntheticDataset, make_synthetic_raw  # noqa: E402
from .loader import DataLoader, shard_batch  # noqa: E402
from .label_mapping import load_label_mapping  # noqa: E402

__all__ = [
    "downsample_indices", "camera_matrix_scaling", "camera_matrix_cropping",
    "angles_to_rotation_matrix", "random_transform", "project_and_masks",
    "sample_circle_loss_points", "farthest_point_sample_np",
    "nearest_assign_np", "build_geometry_sample", "cost_volume_labels",
    "KittiCalib", "KittiDataset", "NuScenesDataset", "SyntheticDataset",
    "make_synthetic_raw", "DataLoader", "shard_batch", "collate",
    "load_label_mapping",
]
