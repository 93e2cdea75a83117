"""Image branch: pyramid CNN + ViT over patch tokens (PyTorch twin of the
JAX package's ``models/image_encoder.py``; reference ImageResNet.py:43-65,
ImageViT.py:8-181)."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import Config
from ..ops.pe import sinusoid_table_1d
from .layers import Conv2d, Dropout, ResidualBlock2D, ViTBlock


class MiniResNet(nn.Module):
    """6 residual blocks, strides (1,1,2,1,2,1): NCHW features at 1/4,
    1/2 and 1/1 scale (ImageResNet.py:58-65)."""

    def __init__(self, cin: int, features: int, dtype=None):
        super().__init__()
        strides = (1, 1, 2, 1, 2, 1)
        self.residual_learning = nn.ModuleList(
            ResidualBlock2D(cin if i == 0 else features, features, s, dtype)
            for i, s in enumerate(strides))

    def forward(self, img: torch.Tensor):
        rl = self.residual_learning
        x = rl[0](img)
        feat_full = rl[1](x)
        feat_half = rl[3](rl[2](feat_full))
        feat_quarter = rl[5](rl[4](feat_half))
        return feat_quarter, feat_half, feat_full


class Embeddings(nn.Module):
    def __init__(self, cfg: Config, dtype=None):
        super().__init__()
        f, p = cfg.embed_dim, cfg.patch_size
        self.mini_resnet = MiniResNet(3, f, dtype)
        self.patch_embeddings = Conv2d(f, f, p, p, 0, dtype)


class ImageTransformer(nn.Module):
    """MiniResNet -> strided patchify -> + sinusoid PE -> SA blocks.

    ``img [B, H, W, 3]`` -> ``(proxy tokens [B, P, F], feat_quarter,
    feat_half, feat_full)``, the feature maps NCHW (ImageViT.py:161-181).
    """

    def __init__(self, cfg: Config):
        super().__init__()
        dt = cfg.torch_dtype()
        self.dtype = dt
        self.embeddings = Embeddings(cfg, dt)
        self.dropout = Dropout(cfg.embed_dropout)
        self.sa_encoder_layers = nn.ModuleList(
            ViTBlock(cfg.embed_dim, cfg.num_head, cfg.mlp_dim, dt,
                     cfg.attention_dropout, cfg.mlp_dropout)
            for _ in range(cfg.num_sa_layer))
        self.register_buffer("pe", torch.from_numpy(sinusoid_table_1d(
            cfg.num_img_proxy, cfg.embed_dim)), persistent=False)

    def forward(self, img: torch.Tensor):
        x = img.to(self.dtype).permute(0, 3, 1, 2)
        feat_q, feat_h, feat_f = self.embeddings.mini_resnet(x)
        tokens = self.embeddings.patch_embeddings(feat_q)     # [B, F, hp, wp]
        tokens = tokens.flatten(2).transpose(1, 2)            # [B, P, F]
        tokens = self.dropout(tokens + self.pe.to(tokens.dtype)[None])
        for blk in self.sa_encoder_layers:
            tokens = blk(tokens)
        return tokens, feat_q, feat_h, feat_f
