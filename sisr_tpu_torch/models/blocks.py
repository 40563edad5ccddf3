"""Shared building blocks for the SR model zoo (PyTorch port of sisr_tpu's
``models/blocks.py``).

Module and attribute names follow the reference's torch modules
(ref: Code/SISR/models/advanced/common.py, advanced/architectures.py:13-122), so a
model's ``state_dict`` has the reference's key names and sisr_tpu's
``convert_torch_state_dict`` reads it directly.

* activations are NCHW tensors in ``torch.channels_last`` memory format;
* parameters are float32 and initialised with torch's Conv2d default scheme
  (uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) for kernel and bias) from an explicit
  ``torch.Generator``;
* bf16 compute is ``torch.autocast`` around the forward, as in the handler.
"""
import math

import torch
from torch import nn

from ..ops.channel_attention import fused_channel_attention


def torch_default_init_(module, generator):
    """Re-draw every Conv2d of ``module`` as U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    kernel then bias, in module order, from ``generator``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
    return module


def conv(in_features, features, kernel_size, use_bias=True):
    """Conv with k//2 padding (ref: common.py:5-8 ``default_conv``)."""
    if features <= 0 or in_features <= 0:
        raise ValueError('conv: zero-width layer (features=%d, in_features=%d)'
                         % (features, in_features))
    return nn.Conv2d(in_features, features, kernel_size, padding=kernel_size // 2,
                     bias=use_bias)


class Upsampler(nn.Sequential):
    """conv + PixelShuffle chain for power-of-2 / x3 scales (ref: common.py:20-45)."""

    def __init__(self, scale, n_feat, use_bias=True):
        layers = []
        if (scale & (scale - 1)) == 0:
            for _ in range(int(math.log2(scale))):
                layers += [conv(n_feat, 4 * n_feat, 3, use_bias), nn.PixelShuffle(2)]
        elif scale == 3:
            layers += [conv(n_feat, 9 * n_feat, 3, use_bias), nn.PixelShuffle(3)]
        else:
            raise NotImplementedError('Upsampler supports 2^n and 3 scales only')
        super().__init__(*layers)


class CALayer(nn.Module):
    """Squeeze-and-excite channel attention (ref: advanced/architectures.py:13-44).

    GAP -> 1x1 reduce -> ReLU -> 1x1 expand -> sigmoid -> scale, run as one
    :func:`fused_channel_attention` call (the CUDA kernel on the card) on the NHWC view
    of the channels_last activation.  ``conv_du`` keeps the reference's layout."""

    def __init__(self, channel, reduction=16):
        super().__init__()
        if channel < reduction:
            raise ValueError('CALayer: channel (%d) < reduction (%d)' % (channel, reduction))
        self.conv_du = nn.Sequential(
            nn.Conv2d(channel, channel // reduction, 1, padding=0, bias=True),
            nn.ReLU(inplace=True),
            nn.Conv2d(channel // reduction, channel, 1, padding=0, bias=True),
            nn.Sigmoid())

    def forward(self, x):
        reduce, expand = self.conv_du[0], self.conv_du[2]
        cr, c = reduce.out_channels, reduce.in_channels
        out = fused_channel_attention(
            x.permute(0, 2, 3, 1), reduce.weight.view(cr, c).t(), reduce.bias,
            expand.weight.view(c, cr).t(), expand.bias)
        return out.permute(0, 3, 1, 2)


class RCAB(nn.Module):
    """Residual channel attention block (ref: advanced/architectures.py:48-71)."""

    def __init__(self, n_feat, kernel_size=3, reduction=16):
        super().__init__()
        self.body = nn.Sequential(conv(n_feat, n_feat, kernel_size), nn.ReLU(inplace=True),
                                  conv(n_feat, n_feat, kernel_size),
                                  CALayer(n_feat, reduction))

    def forward(self, x):
        return self.body(x) + x


class ResidualGroup(nn.Module):
    """Group of RCABs + trailing conv with group residual
    (ref: advanced/architectures.py:94-110)."""

    def __init__(self, n_feat, kernel_size=3, reduction=16, n_resblocks=20):
        super().__init__()
        self.body = nn.Sequential(
            *[RCAB(n_feat, kernel_size, reduction) for _ in range(n_resblocks)],
            conv(n_feat, n_feat, kernel_size))

    def forward(self, x):
        return self.body(x) + x
