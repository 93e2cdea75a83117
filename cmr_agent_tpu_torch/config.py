"""Frozen configuration dataclasses (the port's own copy).

The JAX package's ``Config`` fields and defaults: the 4-DoF and the 6-DoF
agent (``is_6_dof``), every eval raster (``raster_mode`` "megatopk",
"pack", "mega", "topk", "flat", "compact"), the full or the compacted 3-D
observation (``obs3d_source``) and the cost volume's rematerialised train
step (``cost_volume_remat``). An unknown ``raster_mode``, ``fused_stacks``
or ``obs3d_source`` raises ``ValueError``. Other differences:

* ``torch_dtype()`` replaces ``jnp_dtype()``, and there is no
  ``use_pallas`` switch: on the card the hand-written kernels always run,
  on the CPU their plain PyTorch versions do (the tensor's device decides,
  see :mod:`cmr_agent_tpu_torch.ops.kernels`);
* the port reads no environment variable. The JAX package's trace-time
  switches are fields: ``CMR_FUSED_STACKS`` is ``fused_stacks`` (unset is
  ``"off"``, ``"1"`` is ``"all"``: the geo model's and the agent's
  pointwise stacks run as fused dense chains in eval mode, and eval
  episodes hand the agent a channel-major observation; ``"agent"`` is
  ``"agent"``, the agent's stacks only), and ``CMR_OBS3D_CN=1`` is
  ``obs3d_cn`` (eval episodes hand an unfused agent the channel-major
  observation too, which it transposes back).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

# Discrete agent action tables (reference: config/KittiConfig.py:105-106).
_R_STEPS_DEG = (-62.5, -12.5, -2.5, -0.5, -0.1, 0.0, 0.1, 0.5, 2.5, 12.5, 62.5)
_T_STEPS = (-8.1, -2.7, -0.9, -0.3, -0.1, 0.0, 0.1, 0.3, 0.9, 2.7, 8.1)
RASTER_MODES = ("megatopk", "pack", "mega", "topk", "flat", "compact")
FUSED_STACKS = ("off", "all", "agent")
OBS3D_SOURCES = ("full", "compact")


@dataclasses.dataclass(frozen=True)
class Config:
    """Shared model / train / agent configuration (KITTI defaults)."""

    name: str = "kitti"

    # <----------- dataset ---------->
    dataset_root: str = ""
    data_velodyne: str = "data_odometry_velodyne_NWU/"
    data_color: str = "data_odometry_color_npy/"
    num_pt: int = 40960
    p_tx_amplitude: float = 10.0
    p_ty_amplitude: float = 0.0
    p_tz_amplitude: float = 10.0
    p_rx_amplitude: float = 0.0
    p_ry_amplitude: float = math.pi
    p_rz_amplitude: float = 0.0
    cropped_img_h: int = 160
    cropped_img_w: int = 512

    # <----------- train / eval ---------->
    seed: int = 2023
    train_batch_size: int = 8
    val_batch_size: int = 8
    val_interval: int = 500
    epoch: int = 64
    lr: float = 1e-3
    num_workers: int = 12
    optimizer: str = "ADAM"
    momentum: float = 0.98
    weight_decay: float = 1e-6
    lr_scheduler: str = "StepLR"
    scheduler_gamma: float = 0.6
    step_size: int = 4
    logdir: str = "log/"
    ckpt_dir: str = "checkpoint/"
    grad_clip_value: float = 1.0

    # <----------- image branch ---------->
    patch_size: int = 8
    embed_dim: int = 64
    mlp_dim: int = 1024
    embed_dropout: float = 0.1
    mlp_dropout: float = 0.1
    attention_dropout: float = 0.1
    num_sa_layer: int = 3
    num_head: int = 8

    # <----------- point branch ---------->
    point_feat_dim: int = 3
    num_node: int = 1280
    num_proxy: int = 256
    knn_k: int = 16
    use_gnn_embedding: bool = False

    # <----------- coarse cross-modal ---------->
    num_ca_layer_coarse: int = 6

    # <----------- fine fusion ---------->
    pt_sample_num: int = 65
    circle_loss_num: int = 512
    img_fuse_res_num: int = 2
    node_fuse_res_num: int = 2
    pt_head_res_num: int = 3
    linear_attention_num: int = 4
    la_head_num: int = 8

    # <----------- agent / RL ---------->
    # 6-DoF actions (roll, yaw, pitch + x, y, z steps) instead of the 4-DoF
    # yaw + x/z steps
    is_6_dof: bool = False
    action_num: int = 10
    r_steps_deg: Tuple[float, ...] = _R_STEPS_DEG
    t_steps: Tuple[float, ...] = _T_STEPS
    num_trajectory: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    alpha: float = 1.0
    clip_eps: float = 0.2
    w_value: float = 0.3
    w_entropy: float = 1e-3
    ppo_batch_size: int = 10

    # <----------- cost-volume (IterModel) ---------->
    # hypotheses per axis of the (yaw, x, z) grid: nlabel^3 poses
    nlabel: int = 9
    # Warp every point instead of the predicted-overlap subset (with its
    # standby fallback); the per-hypothesis frustum test still filters
    # geometrically. Removes the cost volume's dependence on the overlap
    # head where that head is blind (+-pi yaw on held-out scenes).
    cost_volume_unmasked: bool = False
    # Recompute the cost-volume forward during the train step's backward
    # (torch.utils.checkpoint) instead of holding its activations from the
    # forward to the backward. Eval paths are unaffected.
    cost_volume_remat: bool = False
    # Eval scores the pose grid in chunks of this many hypotheses (warp ->
    # stack -> tower per chunk, logits concatenated), exact because eval
    # BatchNorm reads running stats: the [B, P, H, W, 2F+2] volume never
    # exists for all P at once. 0 disables; ignored when it does not
    # divide nlabel^3.
    cost_volume_eval_chunk: int = 243

    # <----------- serving knobs ---------->
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    # The eval episode's observation raster:
    #   "megatopk" (default): ranked top-K compaction by in-camera score
    #     (lowest scores dropped beyond raster_topk), then the
    #     projection-fused raster kernel every step;
    #   "pack" / "mega": the streaming mask-pack kernel (first-index-first,
    #     highest indices dropped beyond raster_topk), then the
    #     projection-fused raster. In this package "mega" is an alias of
    #     "pack". (The JAX package gives "pack" another per-step raster;
    #     the name is kept so that its configs load.)
    #   "topk": the ranked top-K compaction, then the pixel-id raster of
    #     the compacted rows every step;
    #   "flat": no compaction; the pixel-id raster over the whole cloud
    #     every step (rows outside the frame or the overlap routed out);
    #   "compact": no compaction; the compacting raster kernel over the
    #     whole cloud every step (it packs each tile's valid rows itself,
    #     and drops none).
    # Training episodes take the ranked top-K and the pixel-id raster under
    # the first three (the pack kernel has no gradient).
    raster_mode: str = "megatopk"
    raster_topk: int = 20480
    # int8 observation raster: applies to bf16 episodes only (as in the
    # JAX package's episode gating); a no-op in f32 episodes.
    raster_int8: bool = True
    # The eval episode's 3-D observation: "full" (the whole cloud) or
    # "compact" (the episode's compacted top-K rows, moved about the FULL
    # cloud's centroid). Needs a compaction (raster_topk < num_pt); training
    # episodes always observe the full cloud.
    obs3d_source: str = "full"
    # Eval episodes hand an unfused agent the channel-major observation
    # (the JAX package's CMR_OBS3D_CN=1).
    obs3d_cn: bool = False
    # Feed the agent's point branch the cloud moved by the current pose
    # estimate instead of the static cloud (same 5 channels).
    pose_aware_observation: bool = False
    # Append the unit (x, z) bearing of the predicted-overlap sector's
    # centroid under the current estimate as two constant per-point
    # channels (7 channels in all).
    obs_bearing_channels: bool = False
    # Feed that bearing straight into the state the policy and value heads
    # read (needs obs_bearing_channels; widens the heads' input by 2).
    policy_aux_state: bool = False
    # Start every episode (rollout and eval) from the yaw that turns the
    # predicted-overlap sector's centroid onto the camera's +z axis,
    # instead of the identity.
    bearing_init: bool = False
    # Fused eval stacks (the JAX package's CMR_FUSED_STACKS, see the module
    # docstring): "off", "all" (geo model and agent) or "agent". Modules in
    # eval() mode fold BatchNorm into the preceding Dense and run each
    # pointwise stack as one fused dense chain; train() mode keeps the
    # layer-by-layer modules (batch statistics do not fold).
    fused_stacks: str = "off"

    def __post_init__(self):
        if self.raster_mode not in RASTER_MODES:
            raise ValueError(
                f"raster_mode {self.raster_mode!r} is not served by the "
                f"port; choose one of {RASTER_MODES}")
        if self.fused_stacks not in FUSED_STACKS:
            raise ValueError(f"fused_stacks {self.fused_stacks!r}: choose "
                             f"one of {FUSED_STACKS}")
        if self.obs3d_source not in OBS3D_SOURCES:
            raise ValueError(f"obs3d_source {self.obs3d_source!r}: choose "
                             f"one of {OBS3D_SOURCES}")

    @property
    def fused_geo(self) -> bool:
        """The geo model's pointwise stacks fuse in eval mode."""
        return self.fused_stacks == "all"

    @property
    def fused_agent(self) -> bool:
        """The agent's pointwise stacks fuse in eval mode."""
        return self.fused_stacks in ("all", "agent")

    @property
    def obs3d_channels(self) -> int:
        """3-D observation channels: xyz + overlap + in_cam (+2 bearing
        channels with ``obs_bearing_channels``)."""
        return 5 + (2 if self.obs_bearing_channels else 0)

    # <----------- derived geometry ---------->
    @property
    def image_h(self) -> int:
        """Fused feature-map height (1/4 of the cropped image)."""
        return int(self.cropped_img_h * 0.25)

    @property
    def image_w(self) -> int:
        """Fused feature-map width (1/4 of the cropped image)."""
        return int(self.cropped_img_w * 0.25)

    @property
    def h_proxy(self) -> int:
        return self.image_h // self.patch_size

    @property
    def w_proxy(self) -> int:
        return self.image_w // self.patch_size

    @property
    def num_img_proxy(self) -> int:
        return self.h_proxy * self.w_proxy

    @property
    def num_pixel(self) -> int:
        return self.image_h * self.image_w

    @property
    def num_steps(self) -> int:
        return len(self.r_steps_deg)

    @property
    def degree_r(self) -> int:
        return 3 if self.is_6_dof else 1

    @property
    def degree_t(self) -> int:
        return 3 if self.is_6_dof else 2

    def torch_dtype(self) -> torch.dtype:
        """Activation compute dtype (params stay float32)."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32

    def episode_raster_topk(self):
        """Top-K of the episode's one-off observation compaction, or None:
        always for "flat" and "compact", which raster the whole cloud, and
        where K would cover the whole cloud (the JAX package then rasters
        the full cloud; under the projection-fused modes the port compacts
        to ``num_pt`` rows instead, which gives the same pixels)."""
        if (self.raster_mode in ("topk", "pack", "mega", "megatopk")
                and 0 < self.raster_topk < self.num_pt):
            return self.raster_topk
        return None

    def r_steps_array(self) -> np.ndarray:
        return np.asarray(self.r_steps_deg, dtype=np.float32) * math.pi / 180.0

    def t_steps_array(self) -> np.ndarray:
        return np.asarray(self.t_steps, dtype=np.float32)


def kitti_config(data_root: str = "", **overrides) -> Config:
    """KITTI configuration (reference: config/KittiConfig.py)."""
    return Config(name="kitti", dataset_root=data_root, **overrides)


def nuscenes_config(data_root: str = "", **overrides) -> Config:
    """NuScenes configuration (reference: config/NuScenesConfig.py).

    Differences from KITTI (NuScenesConfig.py:23-49): narrower crop (320 px
    wide -> 40x80 fused map), val every 1000 steps, 30 epochs, StepLR step 2,
    16 loader workers. The cost-volume grid stays nlabel=9, as in the JAX
    package: the reference hardcodes 9 in IterModel (IterModel.py:28).
    """
    defaults = dict(
        name="nuscenes",
        dataset_root=data_root,
        cropped_img_w=320,
        val_interval=1000,
        epoch=30,
        step_size=2,
        num_workers=16,
    )
    defaults.update(overrides)
    return Config(**defaults)


def tiny_config(**overrides) -> Config:
    """Miniature config for tests: every architectural ratio of KITTI at
    1/8 the token counts."""
    defaults = dict(
        name="tiny", num_pt=2048, num_node=160, num_proxy=32,
        cropped_img_h=64, cropped_img_w=128, circle_loss_num=64, knn_k=8,
        num_sa_layer=1, num_ca_layer_coarse=2, linear_attention_num=2,
        mlp_dim=128, train_batch_size=2, val_batch_size=2,
    )
    defaults.update(overrides)
    return Config(**defaults)


def micro_config(**overrides) -> Config:
    """Smallest config that still exercises every code path."""
    defaults = dict(
        name="micro", num_pt=512, num_node=64, num_proxy=16,
        cropped_img_h=32, cropped_img_w=64, circle_loss_num=16, knn_k=4,
        embed_dim=32, num_head=4, la_head_num=4, num_sa_layer=1,
        num_ca_layer_coarse=1, linear_attention_num=1, img_fuse_res_num=1,
        node_fuse_res_num=1, pt_head_res_num=1, mlp_dim=64, action_num=3,
        num_trajectory=2, ppo_batch_size=4, nlabel=3, train_batch_size=2,
        val_batch_size=2,
    )
    defaults.update(overrides)
    return Config(**defaults)
