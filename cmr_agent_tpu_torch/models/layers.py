"""Shared building blocks.

PyTorch twins of the JAX package's ``models/layers.py`` (its unfused
branches), named after the reference's torch module tree so the weight
bridge (:mod:`cmr_agent_tpu_torch.train.convert`) maps names one to one:

* pointwise stacks are ``Linear`` layers on channels-last ``[B, N, C]``
  (the reference's ``Conv1d(k=1)``);
* 2-D blocks are ``Conv2d`` on NCHW inside the module; callers convert at
  their boundaries and public outputs stay NHWC as in the JAX package;
* BatchNorm follows flax, not ``torch.nn.BatchNorm``: in ``train()`` mode
  it normalises with the biased batch variance and updates the running
  stats as ``0.9 old + 0.1 batch`` (the running variance biased too); in
  ``eval()`` mode it uses the running stats; in f32 (f64 inputs stay f64,
  as flax promotes), cast back;
* :class:`Dropout` scales kept values by ``1/(1-p)`` as flax does and
  draws its masks from the generator :func:`set_dropout_generator` gives
  it (a train step passes its own), so a step is reproducible from a
  seed.

Parameters stay f32. Every layer computes in its ``dtype`` (the config's
compute dtype): inputs, weights and biases are cast to it, as flax does
for ``nn.Dense(dtype=...)``.

Fused eval stacks (JAX ``layers.py:66-269``): a :class:`MiniPointNet` or
:class:`ResDenseBlock` built with ``fused=True`` runs, in ``eval()`` mode,
as one :func:`..ops.kernels.dense_chain` (the chain kernel, row- or
channel-major, with its gradient) with each BatchNorm folded into the
preceding Dense at every forward (:func:`fold_dense_bn`, so weight updates
are seen). ``train()`` mode keeps
the layer-by-layer modules, whose batch statistics do not fold. The
parameter tree is the same either way.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import kernels
from ..parallel import mesh as _mesh


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


def set_dropout_rate(module: nn.Module, p: float) -> None:
    """Set the rate of every :class:`Dropout` under ``module`` (0 turns
    dropout off in ``train()`` mode, as the parity comparisons need)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.p = p


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Every :class:`Dropout` under ``module`` draws its masks from
    ``generator`` (on the activations' device; None: the device's default
    generator)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in ``train()`` mode keep each element with
    probability ``1 - p`` and scale it by ``1/(1-p)``; identity in
    ``eval()`` mode or at ``p == 0``. Masks come from ``generator``."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        # under a mesh the tensor is this rank's shard of a global one:
        # draw the global mask (the generator is seeded alike on every
        # rank) and keep this rank's part, as JAX draws one mask for the
        # whole sharded batch
        shards = _mesh.row_shards()
        shape = list(x.shape)
        for axis, _, count in shards:
            shape[axis] *= count
        mask = torch.rand(shape, generator=self.generator,
                          device=x.device) < keep
        for axis, index, _ in shards:
            mask = mask.narrow(axis, index * x.shape[axis], x.shape[axis])
        return torch.where(mask, x / keep, torch.zeros_like(x))


_FROZEN_STATS = [False]


@contextlib.contextmanager
def running_stats_frozen():
    """Within it, :class:`BatchNorm` in ``train()`` mode still normalises
    with the batch's statistics but leaves its running stats alone: the
    recomputation of a checkpointed forward (``torch.utils.checkpoint``)
    runs in it, so a rematerialised step moves the running stats once, as
    the JAX package's ``jax.checkpoint`` of a forward that returns its
    mutated ``batch_stats`` does."""
    saved = _FROZEN_STATS[0]
    _FROZEN_STATS[0] = True
    try:
        yield
    finally:
        _FROZEN_STATS[0] = saved


class BatchNorm(nn.Module):
    """BatchNorm over channel axis ``dim`` with flax semantics.

    Holds the torch BatchNorm state names (``weight``, ``bias``,
    ``running_mean``, ``running_var``); computes in f32 and casts back to
    the input dtype, like the JAX package's ``BatchNorm``. In ``train()``
    mode the statistics are the batch's over every other axis, with the
    variance ``E[x^2] - E[x]^2`` clipped at 0 (biased; flax's fast
    variance), and the running stats move by momentum 0.9. Under a mesh
    whose ``dp`` spans several ranks (:func:`..parallel.mesh.use_mesh`)
    the sums, sums of squares and counts are all-reduced over ``dp``
    (differentiably) first, so the statistics, and the running stats on
    every rank, are the global batch's.
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
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            axes = [d for d in range(x.ndim) if d != self.dim % x.ndim]
            dp = _mesh.axis_group("dp")
            if dp is None:
                mean = xf.mean(dim=axes)
                var = ((xf * xf).mean(dim=axes) - mean * mean).clamp_min(0.0)
            else:
                from torch.distributed.nn.functional import all_reduce
                c = xf.shape[self.dim]
                count = xf.new_full((1,), xf.numel() // c)
                sums = all_reduce(torch.cat([xf.sum(dim=axes),
                                             (xf * xf).sum(dim=axes), count]),
                                  group=dp[0])
                mean = sums[:c] / sums[2 * c]
                var = (sums[c:2 * c] / sums[2 * c]
                       - mean * mean).clamp_min(0.0)
            if not _FROZEN_STATS[0]:
                with torch.no_grad():
                    self.running_mean.copy_(0.9 * self.running_mean
                                            + 0.1 * mean)
                    self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        s = (self.weight / torch.sqrt(var + self.eps))
        y = (xf - mean.view(shape)) * s.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class GlobalMean(nn.Module):
    """Mean over H, W of NCHW keeping dims (the reference's
    AvgPool(H/8, W/8))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=True)


def fold_dense_bn(linear: nn.Linear, bn: BatchNorm):
    """Eval-mode BatchNorm folded into the preceding Dense, in f32 (JAX
    ``layers.py:128-136``): ``BN(x W + b) = x (W s) + ((b - mean) s +
    beta)`` with ``s = scale / sqrt(var + eps)``. Returns ``(W [in, out],
    b [out])``."""
    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return linear.weight.t() * s[None, :], (linear.bias - bn.running_mean) \
        * s + bn.bias


class DenseBN(nn.Sequential):
    """``Linear`` + ``BatchNorm`` + LeakyReLU(0.2): one layer of a
    MiniPointNet (the reference's ``layer_i`` = Conv1d, BN1d, LReLU)."""

    def __init__(self, cin: int, cout: int, dtype=None):
        super().__init__(Linear(cin, cout, dtype=dtype), BatchNorm(cout),
                         nn.LeakyReLU(0.2))


class MiniPointNet(nn.Module):
    """3 x (Dense-BN-LeakyReLU(0.2)) shared point MLP (PointNN.py:96-123);
    one fused dense chain in eval mode when built with ``fused``."""

    def __init__(self, cin: int, features: int, dtype=None,
                 fused: bool = False):
        super().__init__()
        self.dtype, self.fused = dtype, fused
        self.layer_1 = DenseBN(cin, features, dtype)
        self.layer_2 = DenseBN(features, features, dtype)
        self.layer_3 = DenseBN(features, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fused or self.training:
            return self.layer_3(self.layer_2(self.layer_1(x)))
        ws, bs = zip(*(fold_dense_bn(layer[0], layer[1]) for layer in
                       (self.layer_1, self.layer_2, self.layer_3)))
        return kernels.dense_chain(
            x.to(self.dtype or x.dtype).contiguous(), ws, bs,
            slopes=(0.2, 0.2, 0.2))


class ResDenseBlock(nn.Module):
    """Residual pointwise block, the reference's ConvBNReLURes1D
    (PointNN.py:260-282): Dense-BN-LReLU-Dense-BN plus an identity or
    projected (Dense-BN) shortcut, LReLU(0.2) after the sum. Built with
    ``fused``, eval mode runs it as one fused dense chain, on channels-last
    ``x [B,N,C]`` or, with ``cn=True``, channel-major ``x [B,C,N]``."""

    def __init__(self, cin: int, features: int, dtype=None,
                 fused: bool = False):
        super().__init__()
        self.dtype, self.fused = dtype, fused
        self.net = nn.Sequential(Linear(cin, cin, dtype=dtype), BatchNorm(cin),
                                 nn.LeakyReLU(0.2),
                                 Linear(cin, features, dtype=dtype),
                                 BatchNorm(features))
        self.shortcut = (None if cin == features else nn.Sequential(
            Linear(cin, features, dtype=dtype), BatchNorm(features)))

    @property
    def fusing(self) -> bool:
        return self.fused and not self.training

    def forward(self, x: torch.Tensor, cn: bool = False) -> torch.Tensor:
        if not self.fusing:
            if cn:
                raise ValueError("the channel-major layout needs the fused "
                                 "eval path")
            s = x if self.shortcut is None else self.shortcut(x)
            return leaky(self.net(x) + s)
        w0, b0 = fold_dense_bn(self.net[0], self.net[1])
        w1, b1 = fold_dense_bn(self.net[3], self.net[4])
        rw = rb = None
        if self.shortcut is not None:
            rw, rb = fold_dense_bn(self.shortcut[0], self.shortcut[1])
        return kernels.dense_chain(
            x.to(self.dtype or x.dtype).contiguous(), (w0, w1), (b0, b1),
            rw, rb, slopes=(0.2, None),
            residual="identity" if rw is None else "proj", final_slope=0.2,
            cn=cn)


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
    ImageViT.py:61-108, IMGPCEncoder.py:14-55); dropout on the attention
    probabilities and on the output (JAX ``layers.py:337,341``)."""

    def __init__(self, d: int, num_heads: int, dtype=None,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.query = Linear(d, d, dtype=dtype)
        self.key = Linear(d, d, dtype=dtype)
        self.value = Linear(d, d, dtype=dtype)
        self.out = Linear(d, d, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        hd = d // self.num_heads

        def split(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.num_heads, hd).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(y)), split(self.value(y))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        probs = self.dropout(torch.softmax(scores, dim=-1))
        ctx = (probs @ v).transpose(1, 2).reshape(x.shape)
        return self.dropout(self.out(ctx))


class ViTMlp(nn.Module):
    """Exact-GELU MLP (reference ImageViT.py:111-133), dropout after the
    GELU and after the output (JAX ``layers.py:359,363``)."""

    def __init__(self, d: int, hidden: int, dtype=None, dropout: float = 0.0):
        super().__init__()
        self.fc1 = Linear(d, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, d, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.fc2(self.dropout(F.gelu(self.fc1(x)))))


class ViTBlock(nn.Module):
    """Pre-norm transformer block (self-attention)."""

    def __init__(self, d: int, num_heads: int, mlp_dim: int, dtype=None,
                 attention_dropout: float = 0.0, mlp_dropout: float = 0.0):
        super().__init__()
        self.attention_norm = LayerNorm(d, 1e-6, dtype)
        self.ffn_norm = LayerNorm(d, 1e-6, dtype)
        self.attn = ViTAttention(d, num_heads, dtype, attention_dropout)
        self.ffn = ViTMlp(d, mlp_dim, dtype, mlp_dropout)

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
