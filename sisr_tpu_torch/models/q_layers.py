"""Meta-attention layers: ParaCALayer, QCALayer and PALayer (PyTorch port of
sisr_tpu's ``models/q_layers.py``; ref: Code/SISR/models/attention_manipulators/
q_layer.py and architectures.py:13-141).

Metadata arrives as a flat (N, M) float tensor.  The layers that act on pooled or
metadata vectors keep the reference's 1x1 ``Conv2d`` modules and key names, so a
model's ``state_dict`` reads directly into sisr_tpu's converter; they run as f32
products on the vectors (autocast off), as the CA kernel's excite does.

Which :class:`QCALayer` styles run through the hand-written CA kernel
(:func:`~sisr_tpu_torch.ops.channel_attention.fused_channel_attention`) is decided by
the style alone:

* ``standard``, ``max_concat`` and ``modulate`` are the CA with the metadata
  concatenated onto the pooled vector (``meta``) or multiplied into the attention
  (``gate``): one kernel launch each;
* ``mini_concat``, ``softmax`` and ``extended_attention`` change the excite's shape
  (metadata after the first product, a softmax over channels, four products) and run
  as plain torch ops, on the card too, as XLA ran every style in sisr_tpu.

``gate`` also carries a QRCAB's ``q_node`` (:meth:`ParaCALayer.gate`, a sigmoid of
the metadata alone), so the block's whole tail is one launch.

Under bucketed eval (``ops/masking.py``) every style pools the valid extent only: the
kernel styles hand it to the kernel, the others take :func:`masked_global_mean`.
"""
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.channel_attention import KERNEL_STYLES, fused_channel_attention
from ..ops.masking import masked_global_mean, valid_extent

STYLES = KERNEL_STYLES + ('mini_concat', 'softmax', 'extended_attention')


def _f32(device):
    """Autocast off: the vector products stay f32 under a bf16 forward."""
    return torch.autocast(device.type, enabled=False)


def _dense(v, layer):
    """A 1x1 Conv2d applied to (N, I) vectors, in f32."""
    weight = layer.weight.view(layer.out_channels, layer.in_channels)
    return F.linear(v.float(), weight.float(), layer.bias.float())


def _vector_weights(layer):
    """(kernel (I, O), bias) of a 1x1 Conv2d, as the CA kernel takes them (a view)."""
    return layer.weight.view(layer.out_channels, layer.in_channels).t(), layer.bias


class ParaCALayer(nn.Module):
    """Metadata -> channel-attention vector (ref: q_layer.py:4-49).

    ``num_layers`` 1x1 convs step the metadata size up to ``network_channels`` (with
    more than 15 metadata entries the widths interpolate between the two), with a
    ReLU between them when ``nonlinearity``, then a sigmoid.  Keys:
    ``attribute_integrator.<k>``."""

    def __init__(self, network_channels, num_metadata, nonlinearity=False, num_layers=2):
        super().__init__()
        multiplier = num_layers
        sizes = [num_metadata]
        for _ in range(num_layers):
            if num_metadata > 15:
                sizes.append((network_channels - num_metadata) // multiplier + num_metadata)
            else:
                sizes.append(network_channels // multiplier)
            multiplier -= 1
        layers = []
        multiplier = num_layers
        for i in range(num_layers):
            layers.append(nn.Conv2d(sizes[i], sizes[i + 1], 1))
            if nonlinearity and multiplier != 1:
                layers.append(nn.ReLU(inplace=True))
            multiplier -= 1
        layers.append(nn.Sigmoid())
        self.attribute_integrator = nn.Sequential(*layers)

    def gate(self, attributes):
        """The (N, C) f32 attention vector of (N, M) ``attributes``."""
        y = attributes
        with _f32(attributes.device):
            for layer in self.attribute_integrator:
                y = _dense(y, layer) if isinstance(layer, nn.Conv2d) else layer(y)
        return y

    def forward(self, x, attributes):
        """``x`` (N, C, H, W) times the gate, in x's dtype."""
        return x * self.gate(attributes)[:, :, None, None].to(x.dtype)


class PALayer(nn.Module):
    """Pixel attention (ref: attention_manipulators/architectures.py:13-30): two plain
    1x1 convs on the map, as XLA ran them.  Keys ``pa.{0,2}``."""

    def __init__(self, channel):
        super().__init__()
        self.pa = nn.Sequential(nn.Conv2d(channel, channel // 8, 1), nn.ReLU(inplace=True),
                                nn.Conv2d(channel // 8, 1, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.pa(x)


class QCALayer(nn.Module):
    """Channel attention fused with metadata, six styles
    (ref: attention_manipulators/architectures.py:34-127):

    * ``modulate``           standard CA, the attention multiplied by the metadata;
    * ``mini_concat``        metadata concatenated onto the reduced inner vector;
    * ``max_concat``         metadata concatenated onto the pooled vector;
    * ``softmax``            max_concat with a softmax over the channels at the end;
    * ``extended_attention`` four products, metadata re-injected before each of the
      first three;
    * ``standard``           plain channel attention, metadata ignored.

    Keys: ``conv_du.{0,2}`` (modulate, standard, max_concat, softmax);
    ``pre_concat`` and ``conv_du.1`` (mini_concat); ``feature_convs.<i>.0`` and
    ``final_conv.0`` (extended_attention).  :meth:`forward` takes an optional ``gate``
    (N, C) that multiplies the attention, fused into the kernel's launch for the
    kernel styles."""

    def __init__(self, channel, style='modulate', reduction=16, num_metadata=1):
        super().__init__()
        # reference-parity guard, condition kept verbatim (ref: attention_
        # manipulators/architectures.py:58-59 rejects reduction < 16 — despite the
        # message, it guards SMALL values; large ones hit the channel<reduction
        # zero-width check instead)
        if reduction < 16:
            raise RuntimeError('Using an extreme channel attention reduction value')
        if channel < reduction:
            raise ValueError('QCALayer: channel (%d) < reduction (%d)' % (channel, reduction))
        if style not in STYLES:
            raise NotImplementedError('Unknown QCALayer style %s' % style)
        self.style = style
        c, c_red, m = channel, channel // reduction, num_metadata
        if style in ('modulate', 'standard', 'max_concat', 'softmax'):
            c_in = c + m if style in ('max_concat', 'softmax') else c
            self.conv_du = nn.Sequential(nn.Conv2d(c_in, c_red, 1), nn.ReLU(inplace=True),
                                         nn.Conv2d(c_red, c, 1), nn.Sigmoid())
        elif style == 'mini_concat':
            self.pre_concat = nn.Conv2d(c, c_red, 1)
            self.conv_du = nn.Sequential(nn.ReLU(inplace=True), nn.Conv2d(c_red + m, c, 1),
                                         nn.Sigmoid())
        else:
            fractions = [(c + m, c // 2), (c // 2 + m, c // 4), (c // 4 + m, c_red)]
            self.feature_convs = nn.ModuleList(
                nn.Sequential(nn.Conv2d(i, o, 1), nn.ReLU(inplace=True)) for i, o in fractions)
            self.final_conv = nn.Sequential(nn.Conv2d(c_red, c, 1), nn.Sigmoid())

    def forward(self, x, metadata, gate=None):
        """``x`` (N, C, H, W) channels_last, ``metadata`` (N, M) (for ``modulate`` the
        handler's (N, C) expansion), ``gate`` (N, C) or None."""
        style = self.style
        if style in KERNEL_STYLES:
            (w1, b1), (w2, b2) = (_vector_weights(self.conv_du[i]) for i in (0, 2))
            meta = metadata if style == 'max_concat' else None
            if style == 'modulate':
                gate = metadata if gate is None else metadata * gate
            out = fused_channel_attention(x.permute(0, 2, 3, 1), w1, b1, w2, b2,
                                          meta=meta, gate=gate,
                                          valid_hw=valid_extent(x.shape[2], x.shape[3]))
            return out.permute(0, 3, 1, 2)
        with _f32(x.device):
            y = masked_global_mean(x)
            meta = metadata.float()
            if style == 'softmax':
                y = torch.cat([y, meta], dim=1)
                y = torch.sigmoid(_dense(torch.relu(_dense(y, self.conv_du[0])),
                                         self.conv_du[2]))
                y = torch.softmax(y, dim=-1)
            elif style == 'mini_concat':
                y = torch.relu(torch.cat([_dense(y, self.pre_concat), meta], dim=1))
                y = torch.sigmoid(_dense(y, self.conv_du[1]))
            else:
                for feature in self.feature_convs:
                    y = torch.relu(_dense(torch.cat([y, meta], dim=1), feature[0]))
                y = torch.sigmoid(_dense(y, self.final_conv[0]))
            if gate is not None:
                y = y * gate.float()
        return x * y[:, :, None, None].to(x.dtype)
