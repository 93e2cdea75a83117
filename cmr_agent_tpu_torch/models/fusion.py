"""Cross-modal fusion: coarse proxy interleave + fine linear-attention stage
(PyTorch twin of the JAX package's ``models/fusion.py``; reference
IMGPCEncoder.py:105-164 and IMGPCEnDecoder.py:19-119)."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import Config
from ..ops.pe import position_encoding_sine_2d
from ..ops.sampling import index_points
from .image_encoder import ImageTransformer
from .layers import Dropout, ResDenseBlock, ResidualBlock2D, ViTCrossBlock
from .linear_attention import LinearAttention
from .point_encoder import PointTransformer


class IMGPCEncoder(nn.Module):
    """Both branch encoders + interleaved coarse cross/self attention."""

    def __init__(self, cfg: Config):
        super().__init__()
        dt = cfg.torch_dtype()
        self.img_transformer = ImageTransformer(cfg)
        self.pt_transformer = PointTransformer(cfg)

        def blocks():
            return nn.ModuleList(
                ViTCrossBlock(cfg.embed_dim, cfg.num_head, cfg.mlp_dim, dt,
                              cfg.attention_dropout, cfg.mlp_dropout)
                for _ in range(cfg.num_ca_layer_coarse))
        self.p2i_ca_layers = blocks()
        self.i2p_ca_layers = blocks()
        self.img_sa_layers = blocks()
        self.pt_sa_layers = blocks()

    def forward(self, img, pc, node, pt2node):
        img_proxy, feat_q, feat_h, feat_f = self.img_transformer(img)
        pt_proxy, node2proxy, pt_feat, node_feat = self.pt_transformer(
            pc, node, pt2node)
        for p2i, i2p, isa, psa in zip(self.p2i_ca_layers, self.i2p_ca_layers,
                                      self.img_sa_layers, self.pt_sa_layers):
            img_proxy = p2i(img_proxy, pt_proxy)
            pt_proxy = i2p(pt_proxy, img_proxy)
            img_proxy = isa(img_proxy, img_proxy)
            pt_proxy = psa(pt_proxy, pt_proxy)
        return {"img_proxy": img_proxy, "pt_proxy": pt_proxy,
                "img_feat_2": feat_q,          # NCHW, 1/4 scale
                "node2proxy": node2proxy, "pt_feat": pt_feat,
                "node_feat": node_feat}


class IMGPCEnDecoder(nn.Module):
    """Coarse encoder + fine pixel<->node linear-attention fusion.

    Returns the encoder dict plus ``fused_img_feat [B,H,W,F]`` (NHWC) and
    ``fused_node_feat [B,M,F]``.
    """

    def __init__(self, cfg: Config):
        super().__init__()
        dt = cfg.torch_dtype()
        f = cfg.embed_dim
        self.cfg = cfg
        self.encoder = IMGPCEncoder(cfg)
        self.node_fuse_convs = nn.ModuleList(
            ResDenseBlock(2 * f if i == 0 else f, f, dt, cfg.fused_geo)
            for i in range(cfg.node_fuse_res_num))
        self.img_fuse_convs = nn.ModuleList(
            ResidualBlock2D(2 * f if i == 0 else f, f, 1, dt)
            for i in range(cfg.img_fuse_res_num))

        def las():
            return nn.ModuleList(LinearAttention(f, cfg.la_head_num, dtype=dt)
                                 for _ in range(cfg.linear_attention_num))
        self.pixel_to_node_LA = las()
        self.node_to_pixel_LA = las()
        self.node_self_LA = las()
        self.pixel_self_LA = las()
        pe = position_encoding_sine_2d(f, cfg.image_h, cfg.image_w)
        self.register_buffer("pe", torch.from_numpy(pe).permute(2, 0, 1),
                             persistent=False)              # [F, H, W]
        self.dropout = Dropout(0.1)     # hard-coded (JAX fusion.py:97,115)

    def forward(self, img, pc, node, pt2node):
        cfg = self.cfg
        f = cfg.embed_dim
        enc = self.encoder(img, pc, node, pt2node)

        proxy_at_node = index_points(enc["pt_proxy"], enc["node2proxy"])
        node_fused = torch.cat([enc["node_feat"], proxy_at_node], dim=-1)
        for blk in self.node_fuse_convs:
            node_fused = blk(node_fused)
        node_fused = self.dropout(node_fused)

        b = img.shape[0]
        hp, wp, p = cfg.h_proxy, cfg.w_proxy, cfg.patch_size
        proxy_map = enc["img_proxy"].transpose(1, 2).reshape(b, f, hp, wp)
        proxy_up = proxy_map.repeat_interleave(p, dim=2).repeat_interleave(
            p, dim=3)
        img_fused = torch.cat([enc["img_feat_2"], proxy_up], dim=1)
        img_fused = self.img_fuse_convs[0](img_fused)
        img_fused = img_fused + self.pe.to(img_fused.dtype)[None]
        for blk in self.img_fuse_convs[1:]:
            img_fused = blk(img_fused)
        img_fused = self.dropout(img_fused)

        pixels = img_fused.flatten(2).transpose(1, 2)       # [B, H*W, F]
        for p2n, n2p, ns, ps in zip(self.pixel_to_node_LA,
                                    self.node_to_pixel_LA, self.node_self_LA,
                                    self.pixel_self_LA):
            node_fused = p2n(node_fused, pixels)
            pixels = n2p(pixels, node_fused)
            node_fused = ns(node_fused, node_fused)
            pixels = ps(pixels, pixels)

        out = dict(enc)
        out["fused_img_feat"] = pixels.reshape(b, cfg.image_h, cfg.image_w, f)
        out["fused_node_feat"] = node_fused
        return out
