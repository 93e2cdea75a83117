"""Cost-volume (IterModel) training (PyTorch twin of the JAX package's
``train/train_iter.py``): the IterModel input state from the frozen geo
outputs, the train state, the per-axis decode accuracies and the train
step, which optimises the scoring tower against the hypothesis-grid labels
with the geo model frozen. As in :mod:`.train_geo`, the step updates the
module and the optimizer in place where the JAX step returns a new
state."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..config import Config
from ..models.cost_volume import IterModel
from .optim import Optimizer

_GEO_KEYS = ("pc_geo_feat", "img_geo_feat", "pc_overlap_pred",
             "pc_overlap_pred_standby", "pc_is_in_cam_scores",
             "img_overlap_pred", "matrix_accumulated")
_LABEL_KEYS = ("label_R", "label_T_x", "label_T_z")
METRIC_KEYS = ("cost_volume_loss", "grid_accuracy", "acc_ry", "acc_ry_1bin",
               "acc_tx", "acc_tx_1bin", "acc_tz", "acc_tz_1bin")


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


@dataclasses.dataclass
class IterTrainState:
    model: IterModel
    optimizer: Optimizer

    @property
    def step(self) -> int:
        return self.optimizer.count


def create_iter_state(cfg: Config, device="cuda", seed: int = 0,
                      steps_per_epoch: int = 1000) -> IterTrainState:
    """An ``IterModel`` with random weights from a generator seeded with
    ``seed``, on ``device`` (CUDA unless asked otherwise), and its
    optimizer (JAX ``train/train_iter.py:62-75``)."""
    from ..serve import init_random_, resolve_device  # serve imports us
    model = IterModel(cfg)
    init_random_(model, torch.Generator().manual_seed(seed))
    model.to(resolve_device(device))
    return IterTrainState(model, Optimizer(cfg, model.parameters(),
                                           steps_per_epoch))


def per_axis_accuracy(cfg: Config, logits: torch.Tensor,
                      label: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Marginal per-axis decode accuracies (JAX ``train/train_iter.py:
    78-103``): the argmax of the softmax's ry / tx / tz marginals against
    the label's, exact (``acc_*``) and within one bin (``acc_*_1bin``).
    0-d f32 tensors."""
    nl = cfg.nlabel
    p = torch.softmax(logits.float(), dim=-1).reshape(-1, nl, nl, nl)
    l3 = label.float().reshape(-1, nl, nl, nl)
    out = {}
    for k, ax in (("acc_ry", (2, 3)), ("acc_tx", (1, 3)),
                  ("acc_tz", (1, 2))):
        pm = p.sum(dim=ax).argmax(dim=-1)
        lm = l3.sum(dim=ax).argmax(dim=-1)
        out[k] = (pm == lm).float().mean()
        out[k + "_1bin"] = ((pm - lm).abs() <= 1).float().mean()
    return out


def cost_volume_metrics(cfg: Config, out: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """``cost_volume_loss``, the joint ``grid_accuracy`` and the per-axis
    accuracies of an IterModel output with labels."""
    logits, label = out["cost_volume_logits"], out["cost_volume_label"]
    metrics = {"cost_volume_loss": out["cost_volume_loss"],
               "grid_accuracy": (logits.argmax(dim=-1)
                                 == label.argmax(dim=-1)).float().mean()}
    metrics.update(per_axis_accuracy(cfg, logits, label))
    return {k: v.detach() for k, v in metrics.items()}


def make_iter_train_step(cfg: Config, mesh=None) -> Callable:
    """``(state, iter_state_dict) -> metrics``: one optimizer step of the
    IterModel (JAX ``train/train_iter.py:106-150``). The geo outputs are
    detached, so only the tower takes gradients; the warp (kernel 7 on
    the card) takes none. ``cfg.cost_volume_remat`` rematerialises the
    forward's volume and first tower stage in the backward (see
    :meth:`..models.cost_volume.IterModel._score`; JAX wraps the whole
    forward in ``jax.checkpoint``), leaving the same running stats and
    parameters as a plain step. Metrics: :data:`METRIC_KEYS`, 0-d tensors
    (no host sync).

    With a :class:`..parallel.mesh.Mesh`, ``iter_state_dict`` holds this
    rank's dp rows of a global batch: the forward and the backward run
    under the mesh, so the tower's BatchNorm statistics (and running
    stats) are the global batch's, the recomputed segments of a remat
    step included (they recompute inside the backward, under the same
    mesh, and issue the same all-reduces in the same order on every
    rank); the gradients and the metrics are averaged over dp."""
    from ..parallel.mesh import average_gradients, mean_over, use_mesh

    def train_step(state: IterTrainState,
                   batch_state: Dict[str, torch.Tensor]):
        st = {k: v.detach() for k, v in batch_state.items()}
        state.model.train()
        state.optimizer.zero_grad()
        with use_mesh(mesh):
            out = state.model(st, with_loss=True)
            out["cost_volume_loss"].backward()
        if mesh is not None:
            average_gradients(state.model, mesh)
        state.optimizer.step()
        metrics = cost_volume_metrics(cfg, out)
        return metrics if mesh is None else mean_over(metrics, METRIC_KEYS,
                                                      mesh)

    return train_step
