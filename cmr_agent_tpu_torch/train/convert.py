"""Weight bridges into the port's ``state_dict``: from the JAX package's
variables, and from the reference's own ``.pth`` checkpoints.

The port's modules are named after the reference's torch module tree, so
the name maps that the JAX package uses to load reference checkpoints
(``train/convert.py``: ``multihead_name_map``, ``agent_name_map``,
``itermodel_name_map``) also name every port parameter. This module keeps its own copy of those maps
and inverts their layout transforms:

* flax Dense kernel ``[I, O]`` -> ``Linear.weight [O, I]``
* flax NHWC conv kernel ``[kh, kw, I, O]`` -> ``Conv2d.weight [O, I, kh, kw]``
  (the cost volume's tower too: its reference ``Conv3d`` kernels are
  ``(1, 3, 3)``, which both packages run as 2-D convolutions, and the input
  axis keeps the volume's ``[img_geo | warped | occupancy | img_overlap]``
  channel order)
* BatchNorm scale/bias/mean/var and LayerNorm scale/bias copy as they are.

:func:`flax_to_state_dict` is total: it raises on any port key left
unassigned, any JAX leaf left unconsumed, or any shape mismatch.

The reference's checkpoints (``geo_feat.pth``, ``agent.pth``, an IterModel
``.pth``): the port's keys are the reference's names, so
:func:`convert_torch_multihead`, :func:`convert_torch_agent` and
:func:`convert_torch_itermodel` only undo the reference's layouts
(``Conv1d [O, I, 1]`` -> ``Linear [O, I]``, the IterModel tower's
``Conv3d [O, I, 1, kh, kw]`` -> ``Conv2d``), as the JAX package's
``convert_torch_*`` (``train/convert.py:364-399``) do into flax. They are
total too: a key the port needs and the file lacks raises, and so does a
key the file has and the port does not use, beyond the ones the JAX
package skips as well: ``num_batches_tracked``, the fixed
``position_embeddings`` and the image ``Embeddings``' alias keys, which
must equal the tensors they alias.

With ``use_gnn_embedding`` the geo map also names the EdgeConv embedding
(``mini_gnn``, ``pos_embed_0``, ``pos_embed_1``). The reference's branch is
dead upstream (PointViT.py:51-56), so no reference checkpoint holds these
parameters: the port names them itself, after the JAX package's modules.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import Config

T_DENSE = "dense"      # [O, I] <-> [I, O]
T_CONV2D = "conv2d"    # [O, I, kh, kw] <-> [kh, kw, I, O]
T_COPY = "copy"

Entry = Tuple[str, str, str, str]  # (torch_key, collection, flax_path, tag)


class _MapBuilder:
    def __init__(self):
        self.entries: List[Entry] = []

    def dense(self, tk: str, fp: str, bias: bool = True):
        self.entries.append((f"{tk}.weight", "params", f"{fp}/kernel", T_DENSE))
        if bias:
            self.entries.append((f"{tk}.bias", "params", f"{fp}/bias", T_COPY))

    def conv2d(self, tk: str, fp: str, bias: bool = True):
        self.entries.append((f"{tk}.weight", "params", f"{fp}/kernel", T_CONV2D))
        if bias:
            self.entries.append((f"{tk}.bias", "params", f"{fp}/bias", T_COPY))

    def bn(self, tk: str, fp: str):
        """fp points at the JAX BatchNorm wrapper; inner module is BatchNorm_0."""
        inner = f"{fp}/BatchNorm_0"
        self.entries += [
            (f"{tk}.weight", "params", f"{inner}/scale", T_COPY),
            (f"{tk}.bias", "params", f"{inner}/bias", T_COPY),
            (f"{tk}.running_mean", "batch_stats", f"{inner}/mean", T_COPY),
            (f"{tk}.running_var", "batch_stats", f"{inner}/var", T_COPY),
        ]

    def ln(self, tk: str, fp: str):
        self.entries += [
            (f"{tk}.weight", "params", f"{fp}/scale", T_COPY),
            (f"{tk}.bias", "params", f"{fp}/bias", T_COPY),
        ]

    # ---- composite blocks ----

    def mini_pointnet(self, tk: str, fp: str):
        """torch MiniPointNet layer_{1..3} -> our DenseBNLeaky_{0..2}."""
        for i in range(3):
            sub = f"{fp}/DenseBNLeaky_{i}"
            self.dense(f"{tk}.layer_{i+1}.0", f"{sub}/Dense_0")
            self.bn(f"{tk}.layer_{i+1}.1", f"{sub}/BatchNorm_0")

    def res_dense(self, tk: str, fp: str, shortcut: bool):
        """torch ConvBNReLURes1D -> our ResDenseBlock."""
        self.dense(f"{tk}.net.0", f"{fp}/Dense_0")
        self.bn(f"{tk}.net.1", f"{fp}/BatchNorm_0")
        self.dense(f"{tk}.net.3", f"{fp}/Dense_1")
        self.bn(f"{tk}.net.4", f"{fp}/BatchNorm_1")
        if shortcut:
            self.dense(f"{tk}.shortcut.0", f"{fp}/Dense_2")
            self.bn(f"{tk}.shortcut.1", f"{fp}/BatchNorm_2")

    def res_block2d(self, tk: str, fp: str, shortcut: bool):
        """torch ResidualBlock -> our ResidualBlock2D."""
        self.conv2d(f"{tk}.conv_layers.0", f"{fp}/Conv_0")
        self.bn(f"{tk}.conv_layers.1", f"{fp}/BatchNorm_0")
        self.conv2d(f"{tk}.conv_layers.3", f"{fp}/Conv_1")
        self.bn(f"{tk}.conv_layers.4", f"{fp}/BatchNorm_1")
        if shortcut:
            self.conv2d(f"{tk}.shortcut.0", f"{fp}/Conv_2")
            self.bn(f"{tk}.shortcut.1", f"{fp}/BatchNorm_2")

    def vit_attention(self, tk: str, fp: str):
        for n in ("query", "key", "value", "out"):
            self.dense(f"{tk}.{n}", f"{fp}/{n}")

    def vit_mlp(self, tk: str, fp: str):
        self.dense(f"{tk}.fc1", f"{fp}/Dense_0")
        self.dense(f"{tk}.fc2", f"{fp}/Dense_1")

    def sa_block(self, tk: str, fp: str):
        """torch self-attention Block -> our ViTBlock (auto-named LNs)."""
        self.ln(f"{tk}.attention_norm", f"{fp}/LayerNorm_0")
        self.ln(f"{tk}.ffn_norm", f"{fp}/LayerNorm_1")
        self.vit_attention(f"{tk}.attn", f"{fp}/ViTAttention_0")
        self.vit_mlp(f"{tk}.ffn", f"{fp}/ViTMlp_0")

    def cross_block(self, tk: str, fp: str):
        """torch two-input Block -> our ViTCrossBlock (named LNs)."""
        self.ln(f"{tk}.attention_norm", f"{fp}/attention_norm")
        self.ln(f"{tk}.ffn_norm", f"{fp}/ffn_norm")
        self.vit_attention(f"{tk}.attn", f"{fp}/ViTAttention_0")
        self.vit_mlp(f"{tk}.ffn", f"{fp}/ViTMlp_0")

    def group_pt(self, tk: str, fp: str):
        self.dense(f"{tk}.fc1_0", f"{fp}/fc1_points")
        self.dense(f"{tk}.fc1_1", f"{fp}/fc1_nodes")
        self.dense(f"{tk}.fc2", f"{fp}/fc2")
        self.dense(f"{tk}.fc_delta.0", f"{fp}/fc_delta_0")
        self.dense(f"{tk}.fc_delta.2", f"{fp}/fc_delta_1")
        self.dense(f"{tk}.fc_gamma.0", f"{fp}/fc_gamma_0")
        self.dense(f"{tk}.fc_gamma.2", f"{fp}/fc_gamma_1")
        self.dense(f"{tk}.w_qs", f"{fp}/w_q", bias=False)
        self.dense(f"{tk}.w_ks", f"{fp}/w_k", bias=False)
        self.dense(f"{tk}.w_vs", f"{fp}/w_v", bias=False)

    def knn_pt(self, tk: str, fp: str):
        self.dense(f"{tk}.fc1", f"{fp}/fc1")
        self.dense(f"{tk}.fc2", f"{fp}/fc2")
        self.dense(f"{tk}.fc_delta.0", f"{fp}/fc_delta_0")
        self.dense(f"{tk}.fc_delta.2", f"{fp}/fc_delta_1")
        self.dense(f"{tk}.fc_gamma.0", f"{fp}/fc_gamma_0")
        self.dense(f"{tk}.fc_gamma.2", f"{fp}/fc_gamma_1")
        self.dense(f"{tk}.w_qs", f"{fp}/w_q", bias=False)
        self.dense(f"{tk}.w_ks", f"{fp}/w_k", bias=False)
        self.dense(f"{tk}.w_vs", f"{fp}/w_v", bias=False)

    def dense_bn(self, tk: str, fp: str):
        """torch ``DenseBN`` (Linear, BN, LReLU) -> our DenseBNLeaky."""
        self.dense(f"{tk}.0", f"{fp}/Dense_0")
        self.bn(f"{tk}.1", f"{fp}/BatchNorm_0")

    def mini_gnn(self, tk: str, fp: str):
        """our MiniGNN: embed_0/1, edge_convs.<i> (JAX edge_<i>), final."""
        self.dense_bn(f"{tk}.embed_0", f"{fp}/embed_0")
        self.dense_bn(f"{tk}.embed_1", f"{fp}/embed_1")
        for i in range(5):
            self.dense(f"{tk}.edge_convs.{i}.layer.0", f"{fp}/edge_{i}/Dense_0")
            self.bn(f"{tk}.edge_convs.{i}.layer.1",
                    f"{fp}/edge_{i}/BatchNorm_0")
        self.dense_bn(f"{tk}.final", f"{fp}/final")

    def linear_attention(self, tk: str, fp: str):
        for n in ("q_proj", "k_proj", "v_proj", "merge"):
            self.dense(f"{tk}.{n}", f"{fp}/{n}", bias=False)
        self.dense(f"{tk}.mlp.0", f"{fp}/mlp_0", bias=False)
        self.dense(f"{tk}.mlp.3", f"{fp}/mlp_1", bias=False)
        self.ln(f"{tk}.norm1", f"{fp}/norm1")
        self.ln(f"{tk}.norm2", f"{fp}/norm2")


def multihead_name_map(cfg: Config) -> List[Entry]:
    """Full key map for MultiHeadModel (geo_feat.pth)."""
    b = _MapBuilder()
    ed, enc = "encoder_decoder", "encoder_decoder/encoder"

    # ---- image transformer ----
    it_t, it_f = "encoder_decoder.encoder.img_transformer", f"{enc}/img_transformer"
    for i in range(6):
        # MiniResNet: shortcut convs exist for block 0 (3->64 channels) and
        # the stride-2 blocks (2 and 4)
        b.res_block2d(f"{it_t}.embeddings.mini_resnet.residual_learning.{i}",
                      f"{it_f}/mini_resnet/ResidualBlock2D_{i}",
                      shortcut=i in (0, 2, 4))
    b.conv2d(f"{it_t}.embeddings.patch_embeddings", f"{it_f}/patch_embed")
    for i in range(cfg.num_sa_layer):
        b.sa_block(f"{it_t}.sa_encoder_layers.{i}", f"{it_f}/sa_{i}")

    # ---- point transformer ----
    pt_t, pt_f = "encoder_decoder.encoder.pt_transformer", f"{enc}/pt_transformer"
    emb = f"{pt_t}.embeddings"
    b.mini_pointnet(f"{emb}.raw_point_mlp", f"{pt_f}/raw_point_mlp")
    b.group_pt(f"{emb}.group_transformer_0", f"{pt_f}/group_0")
    b.mini_pointnet(f"{emb}.point_mlp_0", f"{pt_f}/point_mlp_0")
    b.group_pt(f"{emb}.group_transformer_1", f"{pt_f}/group_1")
    b.mini_pointnet(f"{emb}.point_mlp_1", f"{pt_f}/point_mlp_1")
    b.group_pt(f"{emb}.group_transformer_node", f"{pt_f}/group_node")
    for i in range(3):
        b.knn_pt(f"{emb}.knn_transformers.{i}", f"{pt_f}/knn_{i}")
    b.group_pt(f"{emb}.group_transformer_proxy", f"{pt_f}/group_proxy")
    if cfg.use_gnn_embedding:
        b.mini_gnn(f"{emb}.mini_gnn", f"{pt_f}/mini_gnn")
        b.dense_bn(f"{emb}.pos_embed_0", f"{pt_f}/pos_embed_0")
        b.dense(f"{emb}.pos_embed_1", f"{pt_f}/pos_embed_1")
    for i in range(cfg.num_sa_layer):
        b.sa_block(f"{pt_t}.sa_encoder_layers.{i}", f"{pt_f}/sa_{i}")

    # ---- coarse interleave ----
    for i in range(cfg.num_ca_layer_coarse):
        b.cross_block(f"encoder_decoder.encoder.p2i_ca_layers.{i}",
                      f"{enc}/p2i_{i}")
        b.cross_block(f"encoder_decoder.encoder.i2p_ca_layers.{i}",
                      f"{enc}/i2p_{i}")
        b.cross_block(f"encoder_decoder.encoder.img_sa_layers.{i}",
                      f"{enc}/img_sa_{i}")
        b.cross_block(f"encoder_decoder.encoder.pt_sa_layers.{i}",
                      f"{enc}/pt_sa_{i}")

    # ---- fine fusion ----
    for i in range(cfg.node_fuse_res_num):
        b.res_dense(f"encoder_decoder.node_fuse_convs.{i}",
                    f"{ed}/node_fuse_{i}", shortcut=i == 0)
    for i in range(cfg.img_fuse_res_num):
        b.res_block2d(f"encoder_decoder.img_fuse_convs.{i}",
                      f"{ed}/img_fuse_{i}", shortcut=i == 0)
    for i in range(cfg.linear_attention_num):
        b.linear_attention(f"encoder_decoder.pixel_to_node_LA.{i}",
                           f"{ed}/p2n_{i}")
        b.linear_attention(f"encoder_decoder.node_to_pixel_LA.{i}",
                           f"{ed}/n2p_{i}")
        b.linear_attention(f"encoder_decoder.node_self_LA.{i}",
                           f"{ed}/node_self_{i}")
        b.linear_attention(f"encoder_decoder.pixel_self_LA.{i}",
                           f"{ed}/pixel_self_{i}")

    # ---- heads ----
    for head_t, head_f, cdim in (("overlap_head", "overlap_head", 32),
                                 ("geo_head", "geo_head", cfg.embed_dim)):
        for i in range(cfg.pt_head_res_num):
            b.res_dense(f"{head_t}.point_fuse_convs.{i}",
                        f"{head_f}/point_fuse_{i}", shortcut=i == 0)
        pc_name = ("pc_overlap_head" if head_t == "overlap_head"
                   else "pc_geo_head")
        img_name = ("img_overlap_head" if head_t == "overlap_head"
                    else "img_geo_head")
        b.dense(f"{head_t}.{pc_name}.0", f"{head_f}/pc_head_0")
        b.dense(f"{head_t}.{pc_name}.2", f"{head_f}/pc_head_1")
        for i in range(cfg.img_fuse_res_num):
            b.res_block2d(f"{head_t}.img_res_convs.{i}",
                          f"{head_f}/img_res_{i}", shortcut=False)
        b.conv2d(f"{head_t}.{img_name}.0", f"{head_f}/img_head_0")
        b.conv2d(f"{head_t}.{img_name}.2", f"{head_f}/img_head_1")

    return b.entries


def agent_name_map(cfg: Config) -> List[Entry]:
    """Full key map for CMRAgent (agent.pth). The names do not depend on
    the observation settings: ``obs_bearing_channels`` widens the first
    point block's input to 7 and ``policy_aux_state`` the heads' input by
    2, which the shape check of :func:`flax_to_state_dict` holds."""
    b = _MapBuilder()
    for i in range(4):
        # shortcut projections exist where in != out: (5|7->f), (2f->f),
        # (2f->f); the last block is (2f->2f) with an identity shortcut
        b.res_dense(f"state_3d_embed.{i}", f"state3d_{i}", shortcut=i != 3)

    conv_map = [(0, "conv0_0"), (3, "conv0_1"), (6, "conv1_0"),
                (9, "conv1_1"), (12, "conv2_0"), (15, "conv2_1"),
                (18, "conv3_0"), (21, "conv3_1"), (24, "conv4_0"),
                (26, "conv4_1")]
    bn_map = [(1, "bn0"), (7, "bn1"), (13, "bn2"), (19, "bn3")]
    for ti, fn in conv_map:
        b.conv2d(f"state_2d_embed.{ti}", fn)
    for ti, fn in bn_map:
        b.bn(f"state_2d_embed.{ti}", fn)

    for head in ("policy_r", "policy_t", "value"):
        b.dense(f"{head}.0", f"{head}_0")
        b.dense(f"{head}.2", f"{head}_1")
        b.dense(f"{head}.4", f"{head}_out")
    return b.entries


def itermodel_name_map(cfg: Config) -> List[Entry]:
    """Key map for IterModel's scoring tower (``cost_volume_convs``)."""
    b = _MapBuilder()
    conv_map = [(0, "cv_conv0_0"), (3, "cv_conv0_1"), (6, "cv_conv1_0"),
                (9, "cv_conv1_1"), (12, "cv_conv2_0"), (15, "cv_conv2_1"),
                (18, "cv_conv3_0"), (21, "cv_conv3_1"),
                (24, "cv_head_0"), (26, "cv_head_1")]
    bn_map = [(1, "cv_bn0"), (7, "cv_bn1"), (13, "cv_bn2"), (19, "cv_bn3")]
    for ti, fn in conv_map:
        b.conv2d(f"cost_volume_convs.{ti}", fn)
    for ti, fn in bn_map:
        b.bn(f"cost_volume_convs.{ti}", fn)
    return b.entries


def pointnet_name_map(module: torch.nn.Module) -> List[Entry]:
    """Name map of a PointNet++ module of :mod:`..models.pointnet` (an SA,
    MSG SA or FP layer): flax names each ``_GroupMLP`` ``_GroupMLP_0``
    (``scale_i`` in the MSG layer) and its layers ``mlp_i`` / ``bn_i``."""
    b = _MapBuilder()
    for name, child in module.named_children():
        fp = "_GroupMLP_0" if name == "group_mlp" else name
        for i in range(child.depth):
            b.dense(f"{name}.mlp_{i}", f"{fp}/mlp_{i}")
            b.bn(f"{name}.bn_{i}", f"{fp}/bn_{i}")
    return b.entries


def _invert_transform(tag: str, w: np.ndarray) -> np.ndarray:
    """Inverse of the JAX package's ``_apply_transform`` for the port's
    layouts (``Linear`` and ``Conv2d``)."""
    if tag == T_DENSE:
        return np.ascontiguousarray(w.T)
    if tag == T_CONV2D:
        return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))
    if tag == T_COPY:
        return np.asarray(w)
    raise ValueError(f"no port layout for transform {tag!r}")


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, p))
        else:
            out[p] = v
    return out


def _model(cfg: Config, which):
    """``(name map, fresh module)`` of ``which``; a PointNet++ module
    (built with its own arguments, not from ``cfg``) is its own target."""
    if isinstance(which, torch.nn.Module):
        return pointnet_name_map(which), which
    from ..models.agent import CMRAgent
    from ..models.cost_volume import IterModel
    from ..models.multi_head import MultiHeadModel
    if which == "multihead":
        return multihead_name_map(cfg), MultiHeadModel(cfg)
    if which == "agent":
        return agent_name_map(cfg), CMRAgent(cfg)
    if which == "itermodel":
        return itermodel_name_map(cfg), IterModel(cfg)
    raise ValueError("which must be 'multihead', 'agent' or "
                     f"'itermodel', got {which!r}")


def entries_to_state_dict(entries: List[Entry], target, variables
                          ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` that the name map ``entries`` makes of the JAX
    ``{"params", "batch_stats"}`` tree ``variables`` for a module whose
    ``state_dict()`` is ``target``; total (see the module docstring)."""
    flat = {c: _flatten(variables.get(c, {}))
            for c in ("params", "batch_stats")}
    out: Dict[str, torch.Tensor] = {}
    consumed = set()
    for tk, coll, fp, tag in entries:
        if fp not in flat[coll]:
            raise KeyError(f"JAX leaf missing: {coll}:{fp}")
        if tk not in target:
            raise KeyError(f"port has no parameter {tk}")
        w = _invert_transform(tag, np.asarray(flat[coll][fp], np.float32))
        if tuple(w.shape) != tuple(target[tk].shape):
            raise ValueError(f"shape mismatch {coll}:{fp} -> {tk}: "
                             f"{w.shape} vs {tuple(target[tk].shape)}")
        out[tk] = torch.from_numpy(w.copy())
        consumed.add((coll, fp))
    unassigned = sorted(set(target) - set(out))
    if unassigned:
        raise KeyError(f"unassigned port keys: {unassigned[:8]} "
                       f"(+{max(0, len(unassigned) - 8)} more)")
    leftover = sorted(f"{c}:{p}" for c in flat for p in flat[c]
                      if (c, p) not in consumed)
    if leftover:
        raise KeyError(f"unconsumed JAX leaves: {leftover[:8]} "
                       f"(+{max(0, len(leftover) - 8)} more)")
    return out


def flax_to_state_dict(cfg: Config, variables, which="multihead"
                       ) -> Dict[str, torch.Tensor]:
    """Turn the JAX package's ``{"params", "batch_stats"}`` (numpy leaves)
    of a ``MultiHeadModel`` (``which="multihead"``), a ``CMRAgent``
    (``which="agent"``), an ``IterModel`` (``which="itermodel"``) or a
    PointNet++ layer (``which`` the port's module of it, ``cfg`` unused)
    into a ``state_dict`` of the port's module."""
    entries, module = _model(cfg, which)
    return entries_to_state_dict(entries, module.state_dict(), variables)


# --------------------------------------------------------------------------
# The reference's .pth checkpoints
# --------------------------------------------------------------------------

IMAGE_EMBEDDINGS = "encoder_decoder.encoder.img_transformer.embeddings."
ALIAS_PREFIX = IMAGE_EMBEDDINGS + "embedding_layers."
ALIASED = ("mini_resnet.", "patch_embeddings.")


def _reference_layout(tag: str, w: torch.Tensor) -> torch.Tensor:
    """A reference tensor in the port's layout: ``Conv1d [O, I, 1]`` ->
    ``Linear [O, I]``, ``Conv3d [O, I, 1, kh, kw]`` -> ``Conv2d``."""
    if tag == T_DENSE and w.ndim == 3 and w.shape[2] == 1:
        return w[:, :, 0]
    if tag == T_CONV2D and w.ndim == 5 and w.shape[2] == 1:
        return w[:, :, 0]
    return w


def _check_aliases(sd: Dict[str, torch.Tensor]) -> None:
    """Each ``embeddings.embedding_layers.<j>.<rest>`` key of the reference
    (its ModuleList registers the MiniResNet and the patchify conv a second
    time, ImageViT.py:15-23) must equal the one original it aliases,
    ``embeddings.mini_resnet.<rest>`` or ``embeddings.patch_embeddings.
    <rest>``."""
    for key, value in sd.items():
        if not key.startswith(ALIAS_PREFIX):
            continue
        rest = key[len(ALIAS_PREFIX):].split(".", 1)[-1]
        found = [IMAGE_EMBEDDINGS + a + rest for a in ALIASED
                 if IMAGE_EMBEDDINGS + a + rest in sd]
        if len(found) != 1:
            raise KeyError(f"alias key {key} names no single original "
                           f"(found {found})")
        if not torch.equal(value, sd[found[0]]):
            raise ValueError(f"alias key {key} differs from {found[0]}")


def _skipped(key: str) -> bool:
    return (key.startswith(ALIAS_PREFIX) or key.endswith("num_batches_tracked")
            or "position_embeddings" in key)


def torch_to_state_dict(cfg: Config, state_dict_or_path, which: str
                        ) -> Dict[str, torch.Tensor]:
    """A reference ``state_dict`` (or the ``.pth`` file holding one, read
    with ``torch.load(weights_only=True)``) of ``which`` as a ``state_dict``
    of the port's module, in f32 on the CPU."""
    if isinstance(state_dict_or_path, (str, os.PathLike)):
        sd = torch.load(state_dict_or_path, map_location="cpu",
                        weights_only=True)
    else:
        sd = state_dict_or_path
    entries, module = _model(cfg, which)
    target = module.state_dict()
    _check_aliases(sd)
    out: Dict[str, torch.Tensor] = {}
    for tk, _, _, tag in entries:
        if tk not in sd:
            raise KeyError(f"torch key missing from checkpoint: {tk}")
        w = _reference_layout(tag, torch.as_tensor(sd[tk]))
        if tuple(w.shape) != tuple(target[tk].shape):
            raise ValueError(f"shape mismatch {tk}: {tuple(w.shape)} vs "
                             f"{tuple(target[tk].shape)}")
        out[tk] = w.detach().to("cpu", torch.float32).contiguous().clone()
    surplus = sorted(k for k in sd if k not in out and not _skipped(k))
    if surplus:
        raise KeyError(f"unconsumed torch keys: {surplus[:8]} "
                       f"(+{max(0, len(surplus) - 8)} more)")
    unassigned = sorted(set(target) - set(out))
    if unassigned:
        raise KeyError(f"unassigned port keys: {unassigned[:8]} "
                       f"(+{max(0, len(unassigned) - 8)} more)")
    return out


def convert_torch_multihead(cfg: Config, state_dict_or_path
                            ) -> Dict[str, torch.Tensor]:
    """``geo_feat.pth`` (path or loaded dict) -> ``MultiHeadModel`` state."""
    return torch_to_state_dict(cfg, state_dict_or_path, "multihead")


def convert_torch_agent(cfg: Config, state_dict_or_path
                        ) -> Dict[str, torch.Tensor]:
    """``agent.pth`` (path or loaded dict) -> ``CMRAgent`` state."""
    return torch_to_state_dict(cfg, state_dict_or_path, "agent")


def convert_torch_itermodel(cfg: Config, state_dict_or_path
                            ) -> Dict[str, torch.Tensor]:
    """An IterModel ``.pth`` (path or loaded dict) -> ``IterModel`` state."""
    return torch_to_state_dict(cfg, state_dict_or_path, "itermodel")
