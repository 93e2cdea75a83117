"""Shared building blocks (eval forward).

PyTorch twins of the JAX package's ``models/layers.py`` (its unfused
branches), named after the reference's torch module tree so the weight
bridge (:mod:`cmr_agent_tpu_torch.train.convert`) maps names one to one:

* pointwise stacks are ``Linear`` layers on channels-last ``[B, N, C]``
  (the reference's ``Conv1d(k=1)``);
* 2-D blocks are ``Conv2d`` on NCHW inside the module; callers convert at
  their boundaries and public outputs stay NHWC as in the JAX package;
* BatchNorm evaluates from running stats (eps 1e-5), in f32, and casts back.

Parameters stay f32. Every layer computes in its ``dtype`` (the config's
compute dtype): inputs, weights and biases are cast to it, as flax does
for ``nn.Dense(dtype=...)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def leaky(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (None: the input's dtype)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (NCHW) computing in ``dtype`` (None: the input's)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in f32 and cast to ``dtype`` (flax semantics)."""

    def __init__(self, features: int, eps: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(features, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype or x.dtype)


class BatchNorm(nn.Module):
    """Eval BatchNorm over channel axis ``dim`` from running statistics.

    Holds the torch BatchNorm state names (``weight``, ``bias``,
    ``running_mean``, ``running_var``); computes in f32 and casts back to
    the input dtype, like the JAX package's ``BatchNorm``.
    """

    def __init__(self, features: int, dim: int = -1, eps: float = 1e-5):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.ndim
        shape[self.dim] = -1
        s = (self.weight / torch.sqrt(self.running_var + self.eps))
        y = (x.float() - self.running_mean.view(shape)) * s.view(shape) \
            + self.bias.view(shape)
        return y.to(x.dtype)


class DenseBN(nn.Sequential):
    """``Linear`` + ``BatchNorm`` + LeakyReLU(0.2): one layer of a
    MiniPointNet (the reference's ``layer_i`` = Conv1d, BN1d, LReLU)."""

    def __init__(self, cin: int, cout: int, dtype=None):
        super().__init__(Linear(cin, cout, dtype=dtype), BatchNorm(cout),
                         nn.LeakyReLU(0.2))


class MiniPointNet(nn.Module):
    """3 x (Dense-BN-LeakyReLU(0.2)) shared point MLP (PointNN.py:96-123)."""

    def __init__(self, cin: int, features: int, dtype=None):
        super().__init__()
        self.layer_1 = DenseBN(cin, features, dtype)
        self.layer_2 = DenseBN(features, features, dtype)
        self.layer_3 = DenseBN(features, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_3(self.layer_2(self.layer_1(x)))


class ResDenseBlock(nn.Module):
    """Residual pointwise block, the reference's ConvBNReLURes1D
    (PointNN.py:260-282): Dense-BN-LReLU-Dense-BN plus an identity or
    projected (Dense-BN) shortcut, LReLU(0.2) after the sum."""

    def __init__(self, cin: int, features: int, dtype=None):
        super().__init__()
        self.net = nn.Sequential(Linear(cin, cin, dtype=dtype), BatchNorm(cin),
                                 nn.LeakyReLU(0.2),
                                 Linear(cin, features, dtype=dtype),
                                 BatchNorm(features))
        self.shortcut = (None if cin == features else nn.Sequential(
            Linear(cin, features, dtype=dtype), BatchNorm(features)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x if self.shortcut is None else self.shortcut(x)
        return leaky(self.net(x) + s)


class ResidualBlock2D(nn.Module):
    """3x3-conv residual block on NCHW (reference ImageResNet.py:5-40):
    shortcut identity, 1x1 conv (channel change) or strided 3x3 conv."""

    def __init__(self, cin: int, features: int, stride: int = 1, dtype=None):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {stride}")
        self.conv_layers = nn.Sequential(
            Conv2d(cin, cin, 3, stride, 1, dtype), BatchNorm(cin, dim=1),
            nn.LeakyReLU(0.2), Conv2d(cin, features, 3, 1, 1, dtype),
            BatchNorm(features, dim=1))
        if stride == 2:
            sc = Conv2d(cin, features, 3, 2, 1, dtype)
        elif cin != features:
            sc = Conv2d(cin, features, 1, 1, 0, dtype)
        else:
            sc = None
        self.shortcut = (None if sc is None
                         else nn.Sequential(sc, BatchNorm(features, dim=1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x if self.shortcut is None else self.shortcut(x)
        return leaky(self.conv_layers(x) + s)


class ViTAttention(nn.Module):
    """Multi-head softmax attention of ``x`` over ``y`` with an output
    projection, written as explicit matmul + softmax (reference
    ImageViT.py:61-108, IMGPCEncoder.py:14-55)."""

    def __init__(self, d: int, num_heads: int, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.query = Linear(d, d, dtype=dtype)
        self.key = Linear(d, d, dtype=dtype)
        self.value = Linear(d, d, dtype=dtype)
        self.out = Linear(d, d, dtype=dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        hd = d // self.num_heads

        def split(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.num_heads, hd).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(y)), split(self.value(y))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1)
        ctx = (probs @ v).transpose(1, 2).reshape(x.shape)
        return self.out(ctx)


class ViTMlp(nn.Module):
    """Exact-GELU MLP (reference ImageViT.py:111-133)."""

    def __init__(self, d: int, hidden: int, dtype=None):
        super().__init__()
        self.fc1 = Linear(d, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, d, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-norm transformer block (self-attention)."""

    def __init__(self, d: int, num_heads: int, mlp_dim: int, dtype=None):
        super().__init__()
        self.attention_norm = LayerNorm(d, 1e-6, dtype)
        self.ffn_norm = LayerNorm(d, 1e-6, dtype)
        self.attn = ViTAttention(d, num_heads, dtype)
        self.ffn = ViTMlp(d, mlp_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attention_norm(x)
        x = x + self.attn(h, h)
        return x + self.ffn(self.ffn_norm(x))


class ViTCrossBlock(ViTBlock):
    """Pre-norm cross-attention block. Normalises the query and the
    key/value streams with the SAME LayerNorm, the reference's quirk
    (IMGPCEncoder.py:91-95)."""

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attention_norm(x), self.attention_norm(y))
        return x + self.ffn(self.ffn_norm(x))
