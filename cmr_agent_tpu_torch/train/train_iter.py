"""Cost-volume (IterModel) state assembly (PyTorch twin of the JAX
package's ``train/train_iter.py:24-50``). The train step is not ported
yet; serving and evaluation need only the state."""

from __future__ import annotations

from typing import Dict

import torch

_GEO_KEYS = ("pc_geo_feat", "img_geo_feat", "pc_overlap_pred",
             "pc_overlap_pred_standby", "pc_is_in_cam_scores",
             "img_overlap_pred", "matrix_accumulated")
_LABEL_KEYS = ("label_R", "label_T_x", "label_T_z")


def iter_model_state(geo_out: Dict[str, torch.Tensor],
                     batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The IterModel input state from the frozen geo outputs and the batch
    (``K`` and the protocol amplitudes that define the hypothesis grid).
    The decode labels come along when the batch has them; a serving
    client's batch has none."""
    state = {"pc_i": geo_out["pc"], "K": batch["K"],
             "R_amplitude": batch["R_amplitude"],
             "T_amplitude": batch["T_amplitude"]}
    state.update({k: geo_out[k] for k in _GEO_KEYS})
    state.update({k: batch[k] for k in _LABEL_KEYS if k in batch})
    return state
