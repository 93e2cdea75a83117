"""Positional encodings.

* 1-D sinusoid table for the ViT patch tokens (reference
  models/ImageViT.py:31-38).
* LoFTR-style 2-D sine encoding for the fused pixel map (reference
  utils/positional_embedding_2d.py:6-40) — computed from the config's
  ``image_h/image_w`` instead of the hardcoded ``(40, 128)`` buffer
  (reference models/IMGPCEnDecoder.py:56), so NuScenes works unmodified.
"""

from __future__ import annotations

import numpy as np


def sinusoid_table_1d(n_position: int, d_hid: int) -> np.ndarray:
    """``[n_position, d_hid]`` interleaved sin/cos table (ImageViT.py:31-38)."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    hid = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (hid // 2) / d_hid)
    table = np.array(angle)
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table.astype(np.float32)


def position_encoding_sine_2d(d_model: int, h: int, w: int) -> np.ndarray:
    """``[h, w, d_model]`` LoFTR 2-D sine encoding (NHWC).

    Channel layout matches the reference NCHW buffer
    (utils/positional_embedding_2d.py:22-31): channels 0::4 sin(x), 1::4
    cos(x), 2::4 sin(y), 3::4 cos(y); positions are 1-based (cumsum of ones).
    """
    pe = np.zeros((d_model, h, w), dtype=np.float64)
    y_pos = np.cumsum(np.ones((h, w)), axis=0)[None]
    x_pos = np.cumsum(np.ones((h, w)), axis=1)[None]
    div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float64)
                 * (-np.log(10000.0) / (d_model // 2)))[:, None, None]
    pe[0::4] = np.sin(x_pos * div)
    pe[1::4] = np.cos(x_pos * div)
    pe[2::4] = np.sin(y_pos * div)
    pe[3::4] = np.cos(y_pos * div)
    return np.transpose(pe, (1, 2, 0)).astype(np.float32)
