"""Host-side data pipeline (numpy + scipy): synthetic KITTI-shaped samples."""

from typing import Dict, Sequence

import numpy as np

from .synthetic import SyntheticDataset


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into one batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


__all__ = ["SyntheticDataset", "collate"]
