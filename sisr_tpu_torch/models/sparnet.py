"""SPARNet and Q-SPARNet face-SR networks (PyTorch port of sisr_tpu's
``models/sparnet.py``; ref: Code/SISR/models/SPARNet/{blocks,architectures}.py).

An encoder of stride-2 residual blocks, a residual body and a decoder of nearest-x2
residual blocks, each block gated by an hourglass spatial-attention map; Q-SPARNet adds
a ParaCALayer on the metadata after every block (after the encoder's only, with
``metadata_encoder_only``).  The models take the LR image pre-upscaled to HR size
(``im_input = 'interp'``).

The normalisations keep sisr_tpu's (flax's) numerics, which differ from torch's stock
modules:

* ``bn``: :class:`FlaxBatchNorm2d`.  Train mode normalises by the batch's biased
  statistics in f32 (flax's E[x^2] - E[x]^2) and updates the running variance from
  that **biased** variance (``torch.nn.BatchNorm2d`` takes the unbiased one), with
  weight 0.1 on the new value; eval mode uses the running statistics;
* ``in``: per image and channel over H, W, epsilon 1e-5, affine;
* ``gn``: 32 groups, epsilon 1e-6 (flax's default; torch's is 1e-5);
* ``layer``: over the channels only, epsilon 1e-6 (flax's LayerNorm on NHWC);
* ``pixel``: ``x / sqrt(sum_c x^2 + 1e-12)``.

Two resize and pad rules are jax's: the hourglass's odd-side resize is
``nearest-exact`` (``jax.image.resize``'s 'nearest'; torch's 'nearest' picks other
pixels), and the reflect pad of a map whose side is not longer than the pad repeats
reflections as ``jnp.pad(mode='reflect')`` does (a one-pixel side repeats its value;
``F.pad`` raises there).

Module names follow the reference, so ``state_dict`` keys are those sisr_tpu's
``convert_sparnet`` walks: ``encoder.<i>``, ``res_layers.<i>``, ``decoder.<i>``,
``out_conv``; within them ``conv2d``, ``norm.norm``, ``relu.func``, ``shortcut_func``,
``preact_func.<0|1>``, ``conv1``, ``conv2``, ``att_func.{b1_, b2_, b2_plus_, b3_}<l>``,
``att_func.out_block.0`` and ``metadata_attention.attribute_integrator.<k>``.
"""
import math

import torch
from torch import nn
from torch.nn import functional as F

from .q_layers import ParaCALayer

NORM_TYPES = ('bn', 'in', 'gn', 'pixel', 'layer', 'none')
RELU_TYPES = ('relu', 'leakyrelu', 'prelu', 'selu', 'none')


def _affine(x, mean, var, weight, bias, eps):
    """flax's ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in
    f32 (mean, var broadcast over x; weight, bias per channel), in x's dtype."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight.float().view(shape)
    y = (x.float() - mean) * mul
    if bias is not None:
        y = y + bias.float().view(shape)
    return y.to(x.dtype)


def _fast_stats(x, dims):
    """flax's ``_compute_stats`` (``use_fast_variance``): the f32 mean and the biased
    variance ``max(0, E[x^2] - E[x]^2)`` over ``dims``, kept for broadcasting."""
    x = x.float()
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.clamp((x * x).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
    return mean, var


def _global_stats(x):
    """:func:`_fast_stats` over (N, H, W) of the batch of every rank: one all-reduce
    of each channel's sum and sum of squares and the pixel count, whose backward
    all-reduces the gradients (``torch.distributed.nn.functional.all_reduce``)."""
    from torch.distributed.nn.functional import all_reduce
    x = x.float()
    c = x.shape[1]
    count = x.new_full((1,), x.numel() / c)
    sums = all_reduce(torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)), count]))
    mean = (sums[:c] / sums[-1]).view(1, c, 1, 1)
    var = torch.clamp(sums[c:2 * c].view(1, c, 1, 1) / sums[-1] - mean * mean, min=0.0)
    return mean, var


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's numerics (``nn.BatchNorm(momentum=0.9)``, epsilon 1e-5):
    in train mode the batch's biased f32 statistics normalise, and the running
    statistics move by ``0.9 * running + 0.1 * batch`` with the biased variance; in
    eval mode the running statistics normalise.  The buffers are torch's
    (``running_mean``, ``running_var``, ``num_batches_tracked``), so a reference
    checkpoint loads strictly.

    With ``sync_stats`` (``BaseHandler.set_mesh`` sets it over more than one rank) the
    train-mode statistics are the global batch's, as sisr_tpu's ``jnp.mean`` over a
    batch sharded by GSPMD is: the per-channel sum, sum of squares and count are summed
    over the ranks by an all-reduce that carries autograd."""

    def __init__(self, channels):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.sync_stats = False

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        mean, var = _global_stats(x) if self.sync_stats else _fast_stats(x, (0, 2, 3))
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean.flatten())
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var.flatten())
            self.num_batches_tracked.add_(1)
        return _affine(x, mean, var, self.weight, self.bias, self.eps)


class InstanceNorm(nn.Module):
    """sisr_tpu's ``in``: per image and channel over H, W (two-pass variance), epsilon
    1e-5, an affine ``weight`` and ``bias`` per channel."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
        return _affine(x, mean, var, self.weight, self.bias, 1e-5)


class GroupNorm(nn.Module):
    """flax's ``GroupNorm(num_groups=32)``: statistics over H, W and each group's
    channels (fast variance), epsilon 1e-6, ``weight`` and ``bias`` per channel."""

    def __init__(self, channels, groups=32):
        super().__init__()
        if channels % groups:
            raise ValueError('GroupNorm: %d channels do not split into %d groups'
                             % (channels, groups))
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        n, c, h, w = x.shape
        mean, var = _fast_stats(x.reshape(n, self.groups, c // self.groups, h, w), (2, 3, 4))
        mean = mean.reshape(n, self.groups, 1, 1).repeat_interleave(c // self.groups, dim=1)
        var = var.reshape(n, self.groups, 1, 1).repeat_interleave(c // self.groups, dim=1)
        return _affine(x, mean, var, self.weight, self.bias, 1e-6)


class ChannelLayerNorm(nn.Module):
    """flax's ``LayerNorm`` on an NHWC map: statistics over the channels of each pixel
    (fast variance), epsilon 1e-6, ``weight`` and ``bias`` per channel."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean, var = _fast_stats(x, (1,))
        return _affine(x, mean, var, self.weight, self.bias, 1e-6)


class NormLayer(nn.Module):
    """(ref: SPARNet/blocks.py:10-36)  One of ``NORM_TYPES``; the ones with parameters
    hold them in ``norm``."""

    _MODULES = {'bn': FlaxBatchNorm2d, 'in': InstanceNorm, 'gn': GroupNorm,
                'layer': ChannelLayerNorm}

    def __init__(self, channels, norm_type='bn'):
        super().__init__()
        self.norm_type = norm_type.lower()
        if self.norm_type not in NORM_TYPES:
            raise ValueError('Norm type %s not supported' % norm_type)
        if self.norm_type in self._MODULES:
            self.norm = self._MODULES[self.norm_type](channels)

    def forward(self, x):
        if self.norm_type == 'pixel':
            xf = x.float()
            return (xf * torch.rsqrt((xf * xf).sum(dim=1, keepdim=True) + 1e-12)).to(x.dtype)
        if self.norm_type == 'none':
            return x
        return self.norm(x)


class ReluLayer(nn.Module):
    """(ref: SPARNet/blocks.py:39-67)  One of ``RELU_TYPES``: ``prelu`` is one slope per
    channel starting at 0.25 (key ``func.weight``), ``leakyrelu`` a slope of 0.2."""

    def __init__(self, channels, relu_type='relu'):
        super().__init__()
        self.relu_type = relu_type.lower()
        if self.relu_type not in RELU_TYPES:
            raise ValueError('Relu type %s not supported' % relu_type)
        if self.relu_type == 'prelu':
            self.func = nn.PReLU(channels, init=0.25)

    def forward(self, x):
        rt = self.relu_type
        if rt == 'relu':
            return F.relu(x)
        if rt == 'leakyrelu':
            return F.leaky_relu(x, 0.2)
        if rt == 'prelu':
            return F.prelu(x, self.func.weight.to(x.dtype))
        if rt == 'selu':
            return F.selu(x)
        return x


def _reflect_index(n, p, device):
    """The source index of each of ``n + 2p`` positions of ``jnp.pad(mode='reflect')``
    along a side of ``n``: reflections repeat past the edge, a side of 1 repeats."""
    if n == 1:
        return torch.zeros(n + 2 * p, dtype=torch.long, device=device)
    period = 2 * (n - 1)
    idx = torch.arange(-p, n + p, device=device).remainder(period)
    return torch.where(idx < n, idx, period - idx)


def reflect_pad(x, p):
    """Reflect-pad the NCHW map ``x`` by ``p`` on each spatial side as
    ``jnp.pad(mode='reflect')`` does.  Where every side is longer than ``p``: one copy
    of the map into a padded tensor of x's memory format, then its border rows and
    columns from inside it (CUDA's ``F.pad`` reflect kernel takes and gives NCHW, which
    costs a channels_last map two layout copies).  Else an index gather with jnp's
    rule."""
    n, c, h, w = x.shape
    if p == 0:
        return x
    if not (p < h and p < w):
        x = x.index_select(2, _reflect_index(h, p, x.device))
        return x.index_select(3, _reflect_index(w, p, x.device))
    fmt = torch.channels_last if x.is_contiguous(memory_format=torch.channels_last) \
        else torch.contiguous_format
    out = torch.empty((n, c, h + 2 * p, w + 2 * p), dtype=x.dtype, device=x.device,
                      memory_format=fmt)
    out[:, :, p:p + h, p:p + w] = x
    for i in range(1, p + 1):
        out[:, :, p - i, p:p + w] = x[:, :, i]
        out[:, :, p + h - 1 + i, p:p + w] = x[:, :, h - 1 - i]
    for i in range(1, p + 1):
        out[:, :, :, p - i] = out[:, :, :, p + i]
        out[:, :, :, p + w - 1 + i] = out[:, :, :, p + w - 1 - i]
    return out


def nearest_resize(x, size):
    """``jax.image.resize(..., 'nearest')`` of an NCHW map to ``size`` (h, w): torch's
    'nearest-exact' (half-pixel centres), in x's type (a copy of pixels: CUDA's
    autocast would give it float32)."""
    with torch.autocast(x.device.type, enabled=False):
        return F.interpolate(x, size=tuple(size), mode='nearest-exact')


class ConvLayer(nn.Module):
    """Reflect-pad conv with an optional stride-2 ``down`` or nearest-x2 ``up``, then
    the norm and the activation (ref: SPARNet/blocks.py:70-103).  The conv has a bias
    only under the ``pixel`` and ``none`` norms.  Keys ``conv2d``, ``norm``, ``relu``."""

    def __init__(self, in_channels, out_channels, kernel_size=3, scale='none',
                 norm_type='none', relu_type='none', use_pad=True):
        super().__init__()
        self.scale, self.use_pad, self.pad = scale, use_pad, kernel_size // 2
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                stride=2 if scale == 'down' else 1,
                                bias=norm_type in ('pixel', 'none'))
        self.norm = NormLayer(out_channels, norm_type)
        self.relu = ReluLayer(out_channels, relu_type)

    def forward(self, x):
        if self.scale == 'up':
            x = nearest_resize(x, (2 * x.shape[2], 2 * x.shape[3]))
        if self.use_pad:
            x = reflect_pad(x, self.pad)
        return self.relu(self.norm(self.conv2d(x)))


class HourGlassBlock(nn.Module):
    """Hourglass spatial attention (ref: SPARNet/blocks.py:181-240): ``depth`` levels
    of a full-size branch ``b1_<l>`` beside a stride-2 branch ``b2_<l>`` (the next level,
    or ``b2_plus_1`` at the bottom) brought back by ``b3_<l>``; the sum, where an odd
    side makes the two disagree, takes the branch's nearest resize first.  The map is
    ``sigmoid(out_block)``, and the block returns ``x`` times it (``x`` itself at depth
    0)."""

    def __init__(self, depth, c_in, c_out, c_mid=64, norm_type='bn', relu_type='prelu'):
        super().__init__()
        self.depth = depth
        kw = dict(norm_type=norm_type, relu_type=relu_type)

        def generate(lv):  # the reference's registration order
            c1 = c_in if lv == depth else c_mid
            self.add_module('b1_%d' % lv, ConvLayer(c1, c_mid, 3, **kw))
            self.add_module('b2_%d' % lv, ConvLayer(c1, c_mid, 3, scale='down', **kw))
            if lv > 1:
                generate(lv - 1)
            else:
                self.add_module('b2_plus_1', ConvLayer(c_mid, c_mid, 3, **kw))
            self.add_module('b3_%d' % lv, ConvLayer(c_mid, c_mid, 3, scale='up', **kw))

        if depth:
            generate(depth)
            self.out_block = nn.Sequential(ConvLayer(c_mid, c_out, 3), nn.Sigmoid())

    def _level(self, lv, x):
        up1 = getattr(self, 'b1_%d' % lv)(x)
        low1 = getattr(self, 'b2_%d' % lv)(x)
        low2 = self._level(lv - 1, low1) if lv > 1 else self.b2_plus_1(low1)
        up2 = getattr(self, 'b3_%d' % lv)(low2)
        if up1.shape[2:] != up2.shape[2:]:
            up2 = nearest_resize(up2, up1.shape[2:])
        return up1 + up2

    def forward(self, x):
        if self.depth == 0:
            return x
        return x * self.out_block(self._level(self.depth, x))


class ResidualBlock(nn.Module):
    """Pre-activation residual block with hourglass attention (ref:
    SPARNet/blocks.py:106-178): ``shortcut_func(x) + att_func(conv2(conv1(
    preact_func(x))))``, the shortcut a plain conv where the scale or the width
    changes; with ``include_metadata`` (Q-SPARNet) a ParaCALayer gate on the metadata
    after it.  ``att_name`` 'spar' gives one attention channel, 'spar3d' one per
    channel."""

    def __init__(self, c_in, c_out, relu_type='prelu', norm_type='bn', scale='none',
                 hg_depth=2, att_name='spar', include_metadata=None):
        super().__init__()
        kw = dict(norm_type=norm_type, relu_type=relu_type)
        self.identity = scale == 'none' and c_in == c_out
        if not self.identity:
            self.shortcut_func = ConvLayer(c_in, c_out, 3, scale)
        self.preact_func = nn.Sequential(NormLayer(c_in, norm_type),
                                         ReluLayer(c_in, relu_type))
        scales = {'down': ('none', 'down'), 'up': ('up', 'none'),
                  'none': ('none', 'none')}[scale]
        self.conv1 = ConvLayer(c_in, c_out, 3, scales[0], **kw)
        self.conv2 = ConvLayer(c_out, c_out, 3, scales[1], norm_type=norm_type,
                               relu_type='none')
        if att_name.lower() not in ('spar', 'spar3d'):
            raise ValueError('Attention type %s not implemented' % att_name)
        c_attn = 1 if att_name.lower() == 'spar' else c_out
        self.att_func = HourGlassBlock(hg_depth, c_out, c_attn, **kw)
        if include_metadata is not None:
            self.metadata_attention = ParaCALayer(c_out, include_metadata,
                                                  nonlinearity=True)

    def forward(self, x, metadata=None):
        identity = x if self.identity else self.shortcut_func(x)
        out = self.conv2(self.conv1(self.preact_func(x)))
        out = identity + self.att_func(out)
        if hasattr(self, 'metadata_attention'):
            out = self.metadata_attention(out, metadata)
        return out


class SPARNet(nn.Module):
    """(ref: SPARNet/architectures.py:7-75)  Q-SPARNet is this with
    ``metadata_count`` set (ref: architectures.py:78-154): each residual block then
    takes the (N, M) metadata through its ParaCALayer, the encoder's only with
    ``metadata_encoder_only``.  The input's sides must be multiples of
    ``2 ** log2(in_size // min_feat_size)`` for the output to match them, as in
    sisr_tpu."""

    def __init__(self, min_ch=32, max_ch=128, in_size=128, out_size=128, min_feat_size=16,
                 res_depth=10, relu_type='leakyrelu', norm_type='bn', att_name='spar',
                 bottleneck_size=4, metadata_count=None, metadata_encoder_only=False):
        super().__init__()
        ch_clip = lambda v: max(min_ch, min(v, max_ch))
        down_steps = int(math.log2(in_size // min_feat_size))
        up_steps = int(math.log2(out_size // min_feat_size))
        n_ch = ch_clip(max_ch // (down_steps + 1))
        nr = dict(norm_type=norm_type, relu_type=relu_type, att_name=att_name)
        body_meta = None if metadata_encoder_only else metadata_count
        self.metadata_count = metadata_count

        encoder = [ConvLayer(3, n_ch, 3)]
        hg_depth = int(math.log2(64 / bottleneck_size))
        for _ in range(down_steps):
            encoder.append(ResidualBlock(ch_clip(n_ch), ch_clip(n_ch * 2), scale='down',
                                         hg_depth=hg_depth,
                                         include_metadata=metadata_count, **nr))
            n_ch, hg_depth = n_ch * 2, hg_depth - 1
        hg_depth += 1
        self.encoder = nn.Sequential(*encoder)
        self.res_layers = nn.Sequential(*(
            ResidualBlock(ch_clip(n_ch), ch_clip(n_ch), hg_depth=hg_depth,
                          include_metadata=body_meta, **nr)
            for _ in range(res_depth + 3 - down_steps)))
        decoder = []
        for _ in range(up_steps):
            hg_depth += 1
            decoder.append(ResidualBlock(ch_clip(n_ch), ch_clip(n_ch // 2), scale='up',
                                         hg_depth=hg_depth, include_metadata=body_meta,
                                         **nr))
            n_ch //= 2
        self.decoder = nn.Sequential(*decoder)
        self.out_conv = ConvLayer(ch_clip(n_ch), 3, 3)

    def forward(self, x, metadata=None):
        out = self.encoder[0](x)
        for block in (*self.encoder[1:], *self.res_layers, *self.decoder):
            out = block(out, metadata)
        return self.out_conv(out)


# Q-SPARNet is SPARNet with metadata_count set (ref: SPARNet/architectures.py:78-154)
QSPARNet = SPARNet
