"""EDSR, RCAN, HAN and SRMD (PyTorch port of sisr_tpu's ``models/advanced.py``).
HAN's holistic-attention blocks, LAM and CSAM (ref: advanced/HAN_blocks.py), live
here too, with their math as functions
(:func:`layer_attention`, :func:`channel_spatial_attention`) that the int8 programs
of ``ops/quantization.py`` share."""
import torch
from torch import nn
from torch.nn import functional as F

from .blocks import ResBlock, ResidualGroup, Upsampler, conv


class EDSR(nn.Module):
    """(ref: advanced/architectures.py:183-241).  Paper-standard EDSR: 256 feats / 32
    blocks / res_scale 0.1; framework default 64/16.

    Keys: ``head.0``, ``body.<i>.body.{0,2}``, ``body.<num_blocks>``, ``tail.0.<2i>``,
    ``tail.1``."""

    def __init__(self, net_features=64, num_blocks=16, scale=4, res_scale=0.1, in_features=3,
                 out_features=3):
        super().__init__()
        n = net_features
        self.num_blocks = num_blocks
        self.res_scale = res_scale
        self.head = nn.Sequential(conv(in_features, n, 3))
        self.body = nn.Sequential(*[ResBlock(n, 3, res_scale) for _ in range(num_blocks)],
                                  conv(n, n, 3))
        self.tail = nn.Sequential(Upsampler(scale, n), conv(n, out_features, 3))

    def forward(self, x):
        x = self.head(x)
        res = self.body(x) + x
        return self.tail(res)


class RCAN(nn.Module):
    """(ref: advanced/architectures.py:126-180).  10 groups x 20 RCABs by default.

    Keys: ``head.0``, ``body.<g>.body.<b>.body.{0,2}``,
    ``body.<g>.body.<b>.body.3.conv_du.{0,2}``, ``body.<g>.body.<n_resblocks>``,
    ``body.<n_resgroups>``, ``tail.0.<2i>``, ``tail.1``."""

    def __init__(self, n_resblocks=20, n_resgroups=10, n_feats=64, in_feats=3, out_feats=3,
                 scale=4, reduction=16):
        super().__init__()
        self.n_resblocks = n_resblocks
        self.n_resgroups = n_resgroups
        self.head = nn.Sequential(conv(in_feats, n_feats, 3))
        self.body = nn.Sequential(
            *[ResidualGroup(n_feats, 3, reduction, n_resblocks) for _ in range(n_resgroups)],
            conv(n_feats, n_feats, 3))
        self.tail = nn.Sequential(Upsampler(scale, n_feats), conv(n_feats, out_feats, 3))

    def forward(self, x):
        x = self.head(x)
        res = self.body(x) + x
        return self.tail(res)


def layer_attention(rows, gamma):
    """LAM's math (ref: HAN_blocks.py:7-37) on N maps held as image rows, ``rows`` of
    shape (B, H, N, W, C): ``gamma * softmax(max(E) - E) @ flat + flat`` with the
    gram ``E = flat @ flatT`` of each image's (N, D) matrix over D = H*W*C, returned
    as (B, H, W, N*C) in layer-major channel order (the reference's
    ``view(B, N*C, H, W)``, which ``last_conv``'s weights assume).

    The gram and the softmax are f32 whatever the maps' type: D is about 1e6 at the
    eval shapes, so the energies reach 1e6 and more, and bf16 would round them by
    thousands inside a softmax of their differences.  The gram is a batch of one
    product per image row, summed over the rows: one (N, D) @ (D, N) product a
    image would leave most of the card idle.  The attention is rounded to the maps'
    type and ``attention @ flat`` summed in f32 (bf16 products are exact in f32:
    sisr_tpu's ``preferred_element_type=float32``), then rounded."""
    b, h, n, w, c = rows.shape
    with torch.autocast(rows.device.type, enabled=False):
        rows32 = rows.float().view(b * h, n, w * c)
        energy = torch.bmm(rows32, rows32.transpose(1, 2)).view(b, h, n, n).sum(dim=1)
        attention = torch.softmax(energy.amax(dim=-1, keepdim=True) - energy, dim=-1)
        out = torch.matmul(attention.to(rows.dtype)[:, None], rows.view(b, h, n, w * c))
        out = gamma.to(rows.dtype) * out.view(b, h, n, w, c) + rows
    return out.transpose(2, 3).reshape(b, h, w, n * c)


def csam_weight(weight, channels):
    """The reference's CSAM kernel, (1, 1, 3, 3, 3) over (C, H, W), as the Conv2d
    weight (C, C, 3, 3) that computes the same 3-D conv on an NCHW map: output
    channel c takes input channels c - 1, c and c + 1 (none past either end: the
    3-D conv's zero padding), each through one 3x3 slice of the kernel."""
    ones = weight.new_ones(channels)
    bands = torch.stack([torch.diag(ones[abs(d):], d) for d in (-1, 0, 1)])
    return torch.einsum('dij,dhw->ijhw', bands, weight[0, 0])


def channel_spatial_attention(x, weight, bias, gamma):
    """CSAM's math (ref: HAN_blocks.py:40-76) on an NCHW map: a 3x3x3 conv (padding
    1) over the (C, H, W) volume, sigmoid, ``x * (gamma * att) + x``, in x's type
    (sisr_tpu's module casts the kernel to its dtype).  ``weight`` and ``bias`` are
    the reference's ``csa.conv`` parameters; the conv runs as the equal Conv2d
    (:func:`csam_weight`) on x as it is, where cuDNN's one-channel Conv3d on the
    volume took 20 times as long on an H100 (PERF.md)."""
    kernel = csam_weight(weight, x.shape[1]).to(x.dtype)
    att = torch.sigmoid(F.conv2d(x, kernel, bias.to(x.dtype).expand(x.shape[1]), padding=1))
    return x * (gamma.to(x.dtype) * att) + x


class LAM(nn.Module):
    """Layer attention over the residual groups' outputs (ref: HAN_blocks.py:7-37).
    Key ``gamma`` (initialised to 0, as in the reference: LAM starts as the
    identity)."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, maps):
        """``maps``: N channels_last (B, C, H, W) maps, newest first -> the
        channels_last (B, N*C, H, W) map of :func:`layer_attention`."""
        rows = torch.stack([m.permute(0, 2, 3, 1) for m in maps], dim=2)
        return layer_attention(rows, self.gamma).permute(0, 3, 1, 2)


class CSAM(nn.Module):
    """Channel-spatial attention (ref: HAN_blocks.py:40-76).  Keys ``conv.weight``
    (1, 1, 3, 3, 3), ``conv.bias`` and ``gamma`` (initialised to 0)."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))
        self.conv = nn.Conv3d(1, 1, 3, 1, 1)

    def forward(self, x):
        return channel_spatial_attention(x, self.conv.weight, self.conv.bias, self.gamma)


def holistic_fusion(model, group_outputs, x):
    """HAN's and Q-HAN's end after the residual groups (ref:
    advanced/architectures.py:357-377): the body tail conv (``model.body[-1]``);
    LAM over every group's output and the body tail's, newest first, into
    ``last_conv``; CSAM on the body tail's output; both concatenated into ``last``;
    plus ``x``, the head's output; then the upsampler and the tail."""
    res = model.body[-1](group_outputs[-1])
    layers = model.last_conv(model.la([res] + group_outputs[::-1]))
    res = model.last(torch.cat([model.csa(res), layers], dim=1)) + x
    return model.tail(res)


class HAN(nn.Module):
    """RCAN body + layer attention + channel-spatial attention
    (ref: advanced/architectures.py:314-377).

    Keys: RCAN's (``head.0``, ``body.<g>.body.<b>...``, ``body.<n_resgroups>``,
    ``tail.0.<2i>``, ``tail.1``), and ``la.gamma``, ``csa.conv.{weight,bias}``,
    ``csa.gamma``, ``last_conv`` ((n_resgroups + 1) * n_feats -> n_feats) and
    ``last`` (2 * n_feats -> n_feats)."""

    def __init__(self, n_resgroups=10, n_resblocks=20, n_feats=64, reduction=16, scale=4,
                 n_colors=3):
        super().__init__()
        self.n_resgroups = n_resgroups
        self.n_resblocks = n_resblocks
        self.head = nn.Sequential(conv(n_colors, n_feats, 3))
        self.body = nn.Sequential(
            *[ResidualGroup(n_feats, 3, reduction, n_resblocks) for _ in range(n_resgroups)],
            conv(n_feats, n_feats, 3))
        self.csa = CSAM()
        self.la = LAM()
        self.last_conv = conv(n_feats * (n_resgroups + 1), n_feats, 3)
        self.last = conv(n_feats * 2, n_feats, 3)
        self.tail = nn.Sequential(Upsampler(scale, n_feats), conv(n_feats, n_colors, 3))

    def forward(self, x):
        x = self.head(x)
        outs, res = [], x
        for group in self.body[:-1]:
            res = group(res)
            outs.append(res)
        return holistic_fusion(self, outs, x)


class SRMD(nn.Module):
    """A plain conv chain over RGB concatenated with per-pixel degradation maps (ref:
    advanced/architectures.py:380-425, KAIR's SRMD).  The handler concatenates the
    maps (``BaseHandler.network_input``): the module sees one (N, in_nc, H, W) input.
    ``nb`` convs of ``nc`` features with a ReLU after each but the last, which makes
    ``out_nc * scale^2`` channels for the pixel shuffle.

    Keys: KAIR's one Sequential, ``model.<2i>`` for conv i (the ReLUs at the odd
    indices, the shuffle at ``model.<2 nb - 1>``)."""

    def __init__(self, in_nc=13, out_nc=3, nc=128, nb=12, scale=4):
        super().__init__()
        layers = [conv(in_nc, nc, 3), nn.ReLU(inplace=True)]
        for _ in range(nb - 2):
            layers += [conv(nc, nc, 3), nn.ReLU(inplace=True)]
        layers += [conv(nc, out_nc * scale ** 2, 3), nn.PixelShuffle(scale)]
        self.nb = nb
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)
