"""SRCNN and VDSR (PyTorch port of sisr_tpu's ``models/basic.py``; ref:
Code/SISR/models/basic/architectures.py).

Both are Y-channel models on a pre-upscaled input: they take the bicubic-upscaled LR
luminance, (N, 1, H, W), and give the restored luminance at that size.  The convs are
``layer_dict.conv_<i>``, as the reference names them (the keys sisr_tpu's
``convert_srcnn`` and ``convert_vdsr`` read).
"""
from torch import nn
from torch.nn import functional as F


class SRCNN(nn.Module):
    """A plain conv stack with a ReLU after every conv but the last (ref:
    basic/architectures.py:6-60).  Default pattern: kernels [9, 5, 5], channels
    [1, 64, 32, 1]; ``padding`` 'same' pads each conv by k // 2, anything else pads
    none (the output then shrinks by the kernels' reach)."""

    default_kernels = (9, 5, 5)
    default_channels = (1, 64, 32, 1)

    def __init__(self, kernel_pattern=None, channel_pattern=None, padding='same'):
        super().__init__()
        kernels = list(kernel_pattern or self.default_kernels)
        channels = list(channel_pattern or self.default_channels)
        if len(channels) != len(kernels) + 1:
            raise ValueError('channel_pattern needs one more entry than kernel_pattern '
                             '(%d kernels, %d channels)' % (len(kernels), len(channels)))
        self.padding = padding
        self.layer_dict = nn.ModuleDict(
            ('conv_%d' % i, nn.Conv2d(channels[i], channels[i + 1], k,
                                      padding=k // 2 if padding == 'same' else 0))
            for i, k in enumerate(kernels))

    def body(self, x):
        convs = list(self.layer_dict.values())
        for i, layer in enumerate(convs):
            x = layer(x)
            if i != len(convs) - 1:
                x = F.relu(x)
        return x

    def forward(self, x, metadata=None):
        return self.body(x)


class VDSR(SRCNN):
    """SRCNN made deep with a global residual (ref: basic/architectures.py:63-77):
    ``body(x) + x``.  Default: 20 3x3 convs of 64 channels."""

    default_kernels = (3,) * 20
    default_channels = (1,) + (64,) * 19 + (1,)

    def forward(self, x, metadata=None):
        return self.body(x) + x
