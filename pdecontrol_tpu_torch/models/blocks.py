"""NN building blocks for the PDE surrogates (port of
``pdecontrol_tpu/models/blocks.py``; reference ``surrogates/models/cnn.py``).

1-D conv / deconv / NVAE-style residual blocks over ``[B, C, H]`` tensors,
with **circular padding** on the convolutions for the periodic domain and a
LayerNorm over the spatial axis, and the fully connected ``LinearBlock`` /
``MLP`` of the LSTM and delay families.  Two layout points carry the JAX
parameters over exactly (see ``convert.py``):

  * flax's ``padding="CIRCULAR"`` wraps ``((k-1)//2, k//2)`` points onto the
    two ends and then runs a VALID convolution, at any stride; so does
    ``CircularConv1d`` here;
  * flax's ``ConvTranspose(padding="SAME")`` is zero-padded, not circular,
    and correlates with its kernel unflipped.  ``DeConvBlock`` stores the
    kernel flipped in torch's transposed-convolution layout and keeps the
    ``stride * H`` outputs that line up with flax's.

Modules are built with their input channels and spatial size, which flax
infers at ``init``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Activation = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init: truncated normal at two standard
    deviations, variance ``1 / fan_in`` after the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std)


class SpatialLayerNorm(nn.Module):
    """LayerNorm over the spatial axis of ``[B, C, H]`` with learned scale
    and bias along it (reference ``nn.LayerNorm(spatial)``, cnn.py:60,72,93);
    population variance, epsilon 1e-5."""

    def __init__(self, size: int, epsilon: float = 1e-5):
        super().__init__()
        self.size, self.epsilon = size, epsilon
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (self.size,), self.weight, self.bias, self.epsilon)


class CircularConv1d(nn.Module):
    """Convolution with flax's circular padding: wrap ``(k-1)//2`` points on
    the left and ``k//2`` on the right, then a VALID strided convolution."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        lecun_normal_(self.weight, in_channels * kernel_size)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        if k > 1:
            x = F.pad(x, ((k - 1) // 2, k // 2), mode="circular")
        return F.conv1d(x, self.weight, self.bias, stride=self.stride)

    @staticmethod
    def out_size(size: int, stride: int) -> int:
        return (size - 1) // stride + 1


class ConvBlock(nn.Module):
    """Circular conv -> activation -> optional spatial LayerNorm
    (reference ``ConvBlock``, cnn.py:6-41)."""

    def __init__(self, in_channels: int, features: int, size: int,
                 kernel_size: int = 3, stride: int = 1, use_bias: bool = True,
                 activation: Activation = F.silu, layernorm: bool = False):
        super().__init__()
        self.conv = CircularConv1d(in_channels, features, kernel_size, stride, use_bias)
        self.activation = activation
        self.out_size = CircularConv1d.out_size(size, stride)
        self.norm = SpatialLayerNorm(self.out_size) if layernorm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.activation(self.conv(x))
        return self.norm(y) if self.norm is not None else y


def _same_transpose_offset(kernel_size: int, stride: int) -> int:
    """Where flax's ``SAME`` transposed-convolution outputs start inside
    torch's full ``(H-1)*stride + k`` output (lax ``_conv_transpose_padding``)."""
    pad_len = kernel_size + stride - 2
    if stride > kernel_size - 1:
        pad_a = kernel_size - 1
    else:
        pad_a = int(math.ceil(pad_len / 2))
    return kernel_size - 1 - pad_a


class DeConvBlock(nn.Module):
    """Stride-2 transposed conv upsampling (reference ``DeConvolutionBlock``,
    cnn.py:44-70; output length = stride * input length), zero-padded as
    flax's ``SAME``.  ``weight`` is ``[in, out, k]``, the flax kernel
    flipped along k."""

    def __init__(self, in_channels: int, features: int, size: int,
                 kernel_size: int = 3, stride: int = 2, use_bias: bool = True,
                 activation: Activation = F.silu, layernorm: bool = False):
        super().__init__()
        self.stride = stride
        self.offset = _same_transpose_offset(kernel_size, stride)
        self.weight = nn.Parameter(torch.empty(in_channels, features, kernel_size))
        lecun_normal_(self.weight, in_channels * kernel_size)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.activation = activation
        self.out_size = size * stride
        self.norm = SpatialLayerNorm(self.out_size) if layernorm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x, self.weight, self.bias, stride=self.stride)
        y = y[..., self.offset : self.offset + self.stride * x.shape[-1]]
        y = self.activation(y)
        return self.norm(y) if self.norm is not None else y


class ResidualBlock(nn.Module):
    """NVAE-style 1-D residual cell with circular padding (reference
    ``ResidualBlock``, cnn.py:73-145): two k-convs (act + norm each), a 1x1
    strided skip, and a post-addition norm."""

    def __init__(self, in_channels: int, features: int, size: int,
                 kernel_size: int = 3, stride: int = 2, use_bias: bool = False,
                 activation: Activation = F.silu, layernorm: bool = False):
        super().__init__()
        self.activation = activation
        self.out_size = CircularConv1d.out_size(size, stride)
        self.skip = CircularConv1d(in_channels, features, 1, stride, use_bias)
        self.conv_l1 = CircularConv1d(in_channels, features, kernel_size, stride, use_bias)
        self.conv_l2 = CircularConv1d(features, features, kernel_size, 1, use_bias)
        if layernorm:
            self.norm_l1 = SpatialLayerNorm(self.out_size)
            self.norm_l2 = SpatialLayerNorm(self.out_size)
            self.norm_skip = SpatialLayerNorm(self.out_size)
        self.layernorm = layernorm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity_ = self.skip(x)
        out = self.activation(self.conv_l1(x))
        if self.layernorm:
            out = self.norm_l1(out)
        out = self.activation(self.conv_l2(out))
        if self.layernorm:
            out = self.norm_l2(out)
        out = out + identity_
        if self.layernorm:
            out = self.norm_skip(out)
        return out


class ConvNet(nn.Module):
    """Stack of blocks with per-layer parameter lists (reference ``ConvNet``,
    cnn.py:148-173).  Missing per-layer values fall back to block defaults.
    ``[B, in_channels, size] -> [B, features[-1], out_size]``."""

    def __init__(self, blocks: Sequence[type], features: Sequence[int],
                 in_channels: int, size: int,
                 kernel_size: Sequence[int] = (), stride: Sequence[int] = (),
                 activation: Sequence[Activation] = (),
                 layernorm: Sequence[bool] = ()):
        super().__init__()

        def get(seq, idx, default):
            return seq[idx] if idx < len(seq) else default

        layers = []
        channels = in_channels
        for i, block_cls in enumerate(blocks):
            layer = block_cls(
                channels, features[i], size,
                kernel_size=get(kernel_size, i, 3),
                stride=get(stride, i, 1 if block_cls is ConvBlock else 2),
                activation=get(activation, i, F.silu),
                layernorm=get(layernorm, i, False),
            )
            layers.append(layer)
            channels, size = features[i], layer.out_size
        self.blocks = nn.ModuleList(layers)
        self.out_channels, self.out_size = channels, size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class LinearBlock(nn.Module):
    """Flatten -> Linear -> activation -> reshape (reference ``LinearBlock``,
    fcnn.py:5-29).  ``[B, Cin, Hin] -> [B, out_channels, out_size]``;
    ``in_features = Cin * Hin``.  Initialised as flax's ``Dense``: LeCun
    normal weight, zero bias."""

    def __init__(self, in_features: int, out_channels: int, out_size: int,
                 activation: Activation = F.silu):
        super().__init__()
        self.out_channels, self.out_size = out_channels, out_size
        self.linear = nn.Linear(in_features, out_channels * out_size)
        lecun_normal_(self.linear.weight, in_features)
        nn.init.zeros_(self.linear.bias)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        y = self.activation(self.linear(x.reshape(b, -1)))
        return y.reshape(b, self.out_channels, self.out_size)


class MLP(nn.Module):
    """Sequence of LinearBlocks; ``sizes`` holds ``(out_channels, out_size)``
    per layer.  ``[B, in_channels, size] -> [B, *sizes[-1]]``."""

    def __init__(self, in_channels: int, size: int,
                 sizes: Sequence[Tuple[int, int]], activations: Sequence[Activation]):
        super().__init__()
        layers = []
        features = in_channels * size
        for (c, h), act in zip(sizes, activations):
            layers.append(LinearBlock(features, c, h, act))
            features = c * h
        self.layers = nn.ModuleList(layers)
        self.out_channels, self.out_size = sizes[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class IdentityModule(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def batched_apply(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Fold time into batch for per-frame modules (reference
    ``BatchingWrapper``, surrogates/utils.py:35-47): [B, T, C, H] -> module
    over [B*T, C, H] -> [B, T, C', H']."""
    b, t = x.shape[:2]
    y = module(x.reshape((b * t,) + tuple(x.shape[2:])))
    return y.reshape((b, t) + tuple(y.shape[1:]))
