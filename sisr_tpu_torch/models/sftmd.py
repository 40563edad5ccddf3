"""SFTMD and its SFT-layer variants (PyTorch port of sisr_tpu's ``models/sftmd.py``;
ref: Code/SISR/models/SFTMD_variants/architectures.py).

The SFT (spatial feature transform) layers take per-pixel metadata maps; the
optional q-injection ParaCALayers take the flat (N, M) vector.  :class:`SFTMD` takes
the vector and broadcasts it to maps once a forward, in the features' type (sisr_tpu
casts the maps to the features' type before each concat: the same values), laid out
channels_last like the features, so each concat and the conv after it stay in that
layout.

Module names follow the reference, so ``state_dict`` keys are those sisr_tpu's
``convert_sftmd`` reads (after its ``sftmd_legacy_switch``): ``conv1``..``conv3``,
``SFT-residual<i>.{conv1, conv2, sft1.sft_module.*, sft2.sft_module.*, q_1, q_2}``,
``sft.sft_module.*``, ``final_injection``, ``conv_mid``, ``upscale.<k>`` and
``conv_output``.  ``SFT-residual<i>`` holds a hyphen: it is registered with
``add_module`` and reached with ``getattr``.
"""
import torch
from torch import nn
from torch.nn import functional as F

from .blocks import conv
from .q_layers import ParaCALayer

SFT_TYPES = ('none', 'weak', 'concat', 'standard')


class ConcatSft(nn.Module):
    """(ref: SFTMD_variants/architectures.py:8-14)  One conv over the features and the
    maps concatenated.  Key ``conv``."""

    def __init__(self, nf=64, para=1):
        super().__init__()
        self.conv = conv(nf + para, nf, 3)

    def forward(self, feature_maps, para_maps):
        return self.conv(torch.cat([feature_maps, para_maps.to(feature_maps.dtype)], 1))


class StandardSft(nn.Module):
    """Multiplicative and additive branches (ref: SFTMD_variants/architectures.py:25-56):
    ``feature * sigmoid(mul) + add``, each branch two 3x3 convs (32 features between,
    a LeakyReLU of 0.2) over the features and the maps concatenated.  ``mask_para``
    leaves the maps out; ``repeats`` tiles them that many times along the channels.
    Keys ``mul_conv1``, ``mul_conv2``, ``add_conv1``, ``add_conv2``."""

    def __init__(self, nf=64, para=1, mask_para=False, repeats=None):
        super().__init__()
        self.mask_para, self.repeats = mask_para, repeats
        cin = nf + (0 if mask_para else para * (repeats or 1))
        self.mul_conv1 = conv(cin, 32, 3)
        self.mul_conv2 = conv(32, nf, 3)
        self.add_conv1 = conv(cin, 32, 3)
        self.add_conv2 = conv(32, nf, 3)

    def forward(self, feature_maps, para_maps):
        if self.mask_para:
            cat = feature_maps
        else:
            if self.repeats is not None:
                para_maps = para_maps.repeat(1, self.repeats, 1, 1)
            cat = torch.cat([feature_maps, para_maps.to(feature_maps.dtype)], 1)
        mul = torch.sigmoid(self.mul_conv2(F.leaky_relu(self.mul_conv1(cat), 0.2)))
        add = self.add_conv2(F.leaky_relu(self.add_conv1(cat), 0.2))
        return feature_maps * mul + add


class SFTLayer(nn.Module):
    """The SFT type's layer (ref: SFTMD_variants/architectures.py:59-76): ``none``
    passes the features, ``weak`` multiplies them by the maps (no parameters),
    ``concat`` is :class:`ConcatSft` and ``standard`` :class:`StandardSft`, each as
    ``sft_module``."""

    def __init__(self, sft_type='standard', nf=64, para=1, mask_para=False, repeats=None):
        super().__init__()
        if sft_type not in SFT_TYPES:
            raise NotImplementedError('Unknown SFT type %s' % sft_type)
        self.sft_type = sft_type
        if sft_type == 'concat':
            self.sft_module = ConcatSft(nf, para)
        elif sft_type == 'standard':
            self.sft_module = StandardSft(nf, para, mask_para, repeats)

    def forward(self, feature_maps, para_maps):
        if self.sft_type == 'none':
            return feature_maps
        if self.sft_type == 'weak':
            return feature_maps * para_maps.to(feature_maps.dtype)
        return self.sft_module(feature_maps, para_maps)


class SFTResidualBlock(nn.Module):
    """(ref: SFTMD_variants/architectures.py:79-104)  sft1, ReLU, [q_1], conv1, sft2,
    ReLU, [q_2], conv2, plus the input.  With ``q_injection`` each ``q_<k>`` is a
    ParaCALayer (a ReLU between its ``q_layers`` layers) gating on the metadata vector
    (the reference feeds it the maps, on which the pointwise layers give the same gate
    at every pixel; sisr_tpu passes the vector, as here)."""

    def __init__(self, nf=64, para=1, sft_type='standard', mask_para=False, repeats=None,
                 q_injection=False, q_layers=2):
        super().__init__()
        self.q_injection = q_injection
        self.sft1 = SFTLayer(sft_type, nf, para, mask_para, repeats)
        self.conv1 = conv(nf, nf, 3)
        self.sft2 = SFTLayer(sft_type, nf, para, mask_para, repeats)
        self.conv2 = conv(nf, nf, 3)
        if q_injection:
            self.q_1 = ParaCALayer(nf, para, nonlinearity=True, num_layers=q_layers)
            self.q_2 = ParaCALayer(nf, para, nonlinearity=True, num_layers=q_layers)

    def forward(self, feature_maps, para_maps, q_meta):
        fea1 = torch.relu(self.sft1(feature_maps, para_maps))
        if self.q_injection:
            fea1 = self.q_1(fea1, q_meta)
        fea2 = torch.relu(self.sft2(self.conv1(fea1), para_maps))
        if self.q_injection:
            fea2 = self.q_2(fea2, q_meta)
        return feature_maps + self.conv2(fea2)


def para_maps_like(metadata, features):
    """The (N, M) metadata broadcast to (N, M, H, W) maps of ``features``' size and
    type, materialised channels_last (one copy a forward)."""
    n, _, h, w = features.shape
    maps = metadata.to(features.dtype)[:, :, None, None].expand(n, metadata.shape[1], h, w)
    return maps.contiguous(memory_format=torch.channels_last)


class SFTMD(nn.Module):
    """(ref: SFTMD_variants/architectures.py:107-176)  Three convs (LeakyReLUs of 0.2
    between), ``num_blocks`` :class:`SFTResidualBlock`, a long skip, a last SFT layer
    (and a ParaCALayer with ``q_injection``), ``conv_mid``, the upscale (two conv +
    x2 shuffle + LeakyReLU stages at 4x, one stage otherwise) and a 9x9
    ``conv_output``; the output clamped to [0, 1], as the reference does.

    ``forward(x, metadata)``: x the NCHW input (with the handler's ``concat_strategy``
    its metadata maps already concatenated), ``metadata`` the (N, M) vector."""

    def __init__(self, in_nc=3, out_nc=3, num_features=64, num_blocks=16, scale=4,
                 input_para=1, sft_type='standard', mask_para=False, repeats=None,
                 q_injection=False, q_layers=2):
        super().__init__()
        nf = num_features
        self.num_blocks, self.scale = num_blocks, scale
        self.sft_type, self.mask_para, self.repeats = sft_type, mask_para, repeats
        self.q_injection = q_injection
        self.conv1 = conv(in_nc, nf, 3)
        self.conv2 = conv(nf, nf, 3)
        self.conv3 = conv(nf, nf, 3)
        for i in range(1, num_blocks + 1):
            self.add_module('SFT-residual%d' % i, SFTResidualBlock(
                nf, input_para, sft_type, mask_para, repeats, q_injection, q_layers))
        self.sft = SFTLayer(sft_type, nf, input_para, mask_para, repeats)
        if q_injection:
            self.final_injection = ParaCALayer(nf, input_para, nonlinearity=True,
                                               num_layers=q_layers)
        self.conv_mid = conv(nf, nf, 3)
        if scale == 4:
            self.upscale = nn.Sequential(
                conv(nf, nf * 4, 3), nn.PixelShuffle(2), nn.LeakyReLU(0.2, inplace=True),
                conv(nf, nf * 4, 3), nn.PixelShuffle(2), nn.LeakyReLU(0.2, inplace=True))
        else:
            self.upscale = nn.Sequential(
                conv(nf, nf * scale ** 2, 3), nn.PixelShuffle(scale),
                nn.LeakyReLU(0.2, inplace=True))
        self.conv_output = conv(nf, out_nc, 9)

    def blocks(self):
        return [getattr(self, 'SFT-residual%d' % i) for i in range(1, self.num_blocks + 1)]

    def forward(self, x, metadata):
        fea = F.leaky_relu(self.conv1(x), 0.2)
        fea = F.leaky_relu(self.conv2(fea), 0.2)
        fea_bef = self.conv3(fea)
        maps = para_maps_like(metadata, fea_bef)
        fea_in = fea_bef
        for block in self.blocks():
            fea_in = block(fea_in, maps, metadata)
        fea_fin = self.sft(fea_in + fea_bef, maps)
        if self.q_injection:
            fea_fin = self.final_injection(fea_fin, metadata)
        out = self.conv_output(self.upscale(self.conv_mid(fea_fin)))
        return out.clamp(0.0, 1.0)
