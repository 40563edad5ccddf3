"""Meta-attention model family: QRCAN, QEDSR, QSAN and QHAN (PyTorch port of sisr_tpu's
``models/qmodels.py``; ref: Code/SISR/models/attention_manipulators/architectures.py).

Every module takes ``(x, metadata)`` explicitly.  Module and attribute names follow
the reference's torch modules, so ``state_dict`` keys are those sisr_tpu's
``convert_qrcan``, ``convert_qedsr``, ``convert_qsan`` and ``convert_qhan`` read.
"""
import torch
from torch import nn

from .advanced import CSAM, LAM, holistic_fusion
from .blocks import Upsampler, conv
from .q_layers import PALayer, ParaCALayer, QCALayer
from .san import SOCA, NonlocalCA, san_body


class QRCAB(nn.Module):
    """Residual channel attention block with metadata fusion
    (ref: attention_manipulators/architectures.py:145-204).

    Keys: ``body.{0,2}`` (the convs), ``final_body`` (the :class:`QCALayer`),
    ``pa_node.pa.{0,2}`` with ``pa``, ``q_node.attribute_integrator.<k>`` with
    ``q_layer``.  Without ``pa`` the q_node's gate, which depends on the metadata
    alone, is handed to the QCALayer, so the CA kernel applies it in the same launch;
    with ``pa`` the pixel attention sits between the two and the gate is applied
    after it."""

    def __init__(self, n_feat, kernel_size=3, reduction=16, style='modulate', pa=False,
                 q_layer=False, num_metadata=1):
        super().__init__()
        self.body = nn.Sequential(conv(n_feat, n_feat, kernel_size), nn.ReLU(inplace=True),
                                  conv(n_feat, n_feat, kernel_size))
        self.final_body = QCALayer(n_feat, style, reduction, num_metadata)
        self.pa = pa
        self.q_layer = q_layer
        if pa:
            self.pa_node = PALayer(n_feat)
        if q_layer:
            # 'modulate' metadata arrives expanded to n_feat by the handler
            q_meta_width = n_feat if style == 'modulate' else num_metadata
            self.q_node = ParaCALayer(n_feat, q_meta_width, nonlinearity=True)

    def forward(self, x, metadata):
        res = self.body(x)
        gate = self.q_node.gate(metadata) if self.q_layer and not self.pa else None
        res = self.final_body(res, metadata, gate)
        if self.pa:
            res = self.pa_node(res)
            if self.q_layer:
                res = self.q_node(res, metadata)
        return res + x


class QResidualGroup(nn.Module):
    """(ref: attention_manipulators/architectures.py:208-243).  ``num_q_layers`` limits
    how many leading blocks get a q_node (None = all).  Keys ``body.<b>`` (the
    blocks) and ``final_body`` (the group's tail conv)."""

    def __init__(self, n_feat, kernel_size=3, reduction=16, n_resblocks=20,
                 style='modulate', num_metadata=1, pa=False, q_layer=False,
                 num_q_layers=None):
        super().__init__()
        self.body = nn.ModuleList(
            QRCAB(n_feat, kernel_size, reduction, style, pa,
                  q_layer if num_q_layers is None or index < num_q_layers else False,
                  num_metadata)
            for index in range(n_resblocks))
        self.final_body = conv(n_feat, n_feat, kernel_size)

    def forward(self, x, metadata):
        res = x
        for block in self.body:
            res = block(res, metadata)
        return self.final_body(res) + x


class QRCAN(nn.Module):
    """RCAN with metadata-fused channel attention
    (ref: attention_manipulators/architectures.py:246-329).

    Keys: ``head.0``, ``body.<g>`` (:class:`QResidualGroup`), ``final_body``,
    ``tail.0.<2i>``, ``tail.1``."""

    def __init__(self, n_resblocks=20, n_resgroups=10, n_feats=64, in_feats=3, out_feats=3,
                 scale=4, reduction=16, style='modulate', num_metadata=1,
                 include_pixel_attention=False, include_q_layer=False,
                 selective_meta_blocks=None, num_q_layers_inner_residual=None):
        super().__init__()
        if selective_meta_blocks is not None and len(selective_meta_blocks) != n_resgroups:
            raise ValueError('selective_meta_blocks needs one entry per residual group '
                             '(%d given, n_resgroups=%d).'
                             % (len(selective_meta_blocks), n_resgroups))
        self.n_resblocks = n_resblocks
        self.n_resgroups = n_resgroups
        self.head = nn.Sequential(conv(in_feats, n_feats, 3))
        self.body = nn.ModuleList(
            QResidualGroup(n_feats, 3, reduction, n_resblocks, style, num_metadata,
                           include_pixel_attention,
                           include_q_layer if selective_meta_blocks is None
                           or selective_meta_blocks[i] else False,
                           num_q_layers_inner_residual)
            for i in range(n_resgroups))
        self.final_body = conv(n_feats, n_feats, 3)
        self.tail = nn.Sequential(Upsampler(scale, n_feats), conv(n_feats, out_feats, 3))

    def forward(self, x, metadata):
        x = self.head(x)
        res = x
        for group in self.body:
            res = group(res, metadata)
        res = self.final_body(res) + x
        return self.tail(res)


class ParamResBlock(nn.Module):
    """EDSR ResBlock + ParaCALayer (ref: attention_manipulators/architectures.py:332-356):
    ``gate(metadata) * (body(x) * res_scale) + x``, the gate applied after the res_scale
    multiply.  Keys ``body.{0,2}`` and ``attention_layer.attribute_integrator.<k>``."""

    def __init__(self, n_feats, n_params, kernel_size=3, res_scale=1.0,
                 q_layer_nonlinearity=False):
        super().__init__()
        self.body = nn.Sequential(conv(n_feats, n_feats, kernel_size), nn.ReLU(inplace=True),
                                  conv(n_feats, n_feats, kernel_size))
        self.res_scale = res_scale
        self.attention_layer = ParaCALayer(n_feats, n_params,
                                           nonlinearity=q_layer_nonlinearity)

    def forward(self, x, metadata):
        return self.attention_layer(self.body(x) * self.res_scale, metadata) + x


class QEDSR(nn.Module):
    """EDSR with a ParaCALayer in every block (ref: attention_manipulators/
    architectures.py:359-399).

    Keys: ``head``, ``body.<i>`` (:class:`ParamResBlock`), ``final_body``,
    ``tail.0.<2i>``, ``tail.1``."""

    def __init__(self, num_features=64, num_blocks=16, scale=4, res_scale=0.1, in_features=3,
                 out_features=3, input_para=1, q_layer_nonlinearity=False):
        super().__init__()
        n = num_features
        self.num_blocks = num_blocks
        self.res_scale = res_scale
        self.q_layer_nonlinearity = q_layer_nonlinearity
        self.head = conv(in_features, n, 3)
        self.body = nn.ModuleList(
            ParamResBlock(n, input_para, 3, res_scale, q_layer_nonlinearity)
            for _ in range(num_blocks))
        self.final_body = conv(n, n, 3)
        self.tail = nn.Sequential(Upsampler(scale, n), conv(n, out_features, 3))

    def forward(self, x, metadata):
        x = self.head(x)
        res = x
        for block in self.body:
            res = block(res, metadata)
        res = self.final_body(res) + x
        return self.tail(res)


class QRB(nn.Module):
    """SAN's residual block with a ParaCALayer gate on the metadata (ref:
    qsan_blocks.py:9-34): ``gate(metadata) * conv_first(x) + x``.  Keys
    ``conv_first.{0,2}`` and ``q_layer.attribute_integrator.{0,2}`` (a ReLU between
    the gate's two layers)."""

    def __init__(self, n_feat, kernel_size=3, num_metadata=1):
        super().__init__()
        self.conv_first = nn.Sequential(conv(n_feat, n_feat, kernel_size), nn.ReLU(inplace=True),
                                        conv(n_feat, n_feat, kernel_size))
        self.q_layer = ParaCALayer(n_feat, num_metadata, nonlinearity=True, num_layers=2)

    def forward(self, x, metadata):
        return self.q_layer(self.conv_first(x), metadata) + x


class QLSRAG(nn.Module):
    """Meta-enhanced LSRAG (ref: qsan_blocks.py:37-85): QRBs, SOCA, ``conv_last``, plus
    the group's input.  Keys ``rcab.<b>``, ``soca``, ``conv_last``."""

    def __init__(self, n_feat, kernel_size=3, reduction=16, n_resblocks=10, num_metadata=1):
        super().__init__()
        self.rcab = nn.ModuleList(QRB(n_feat, kernel_size, num_metadata)
                                  for _ in range(n_resblocks))
        self.soca = SOCA(n_feat, reduction)
        self.conv_last = conv(n_feat, n_feat, kernel_size)

    def forward(self, x, metadata):
        flow = x
        for block in self.rcab:
            flow = block(flow, metadata)
        return x + self.conv_last(self.soca(flow))


class QSAN(nn.Module):
    """SAN with meta-attention groups (ref: attention_manipulators/architectures.py:
    402-467): SAN's head, shared non-local block, ``gamma`` and tail around
    :class:`QLSRAG` groups.  Keys SAN's (``head.0``, ``non_local.non_local.*``,
    ``RG.<g>.{rcab.<b>, soca, conv_last}``, ``tail``, ``gamma``) with each block's
    ``q_layer``."""

    def __init__(self, n_resgroups=20, n_resblocks=10, n_feats=64, reduction=16, scale=4,
                 n_colors=3, input_para=1):
        super().__init__()
        self.n_resgroups = n_resgroups
        self.n_resblocks = n_resblocks
        self.gamma = nn.Parameter(torch.zeros(1))
        self.head = nn.Sequential(conv(n_colors, n_feats, 3))
        self.non_local = NonlocalCA(n_feats, n_feats // 8)
        self.RG = nn.ModuleList(QLSRAG(n_feats, 3, reduction, n_resblocks, input_para)
                                for _ in range(n_resgroups))
        self.tail = nn.Sequential(Upsampler(scale, n_feats), conv(n_feats, n_colors, 3))

    def forward(self, x, metadata):
        return san_body(self, x, lambda group, xx: group(xx, metadata))


class QHAN(nn.Module):
    """HAN with meta-attention residual groups
    (ref: attention_manipulators/architectures.py:470-540): every group a
    :class:`QResidualGroup` of QRCABs with the ``standard`` QCALayer (which ignores
    the metadata) and a q_node (the metadata enters through its gate alone, fused
    into each block's CA launch), then HAN's LAM / CSAM fusion.

    Keys: ``head.0``, ``body.<g>`` (:class:`QResidualGroup`), ``body.<n_resgroups>``
    (the body tail conv; Q-RCAN's is ``final_body``), ``la.gamma``,
    ``csa.conv.{weight,bias}``, ``csa.gamma``, ``last_conv``, ``last``,
    ``tail.0.<2i>``, ``tail.1``."""

    def __init__(self, n_resgroups=10, n_resblocks=20, n_feats=64, reduction=16,
                 num_metadata=1, scale=4, n_colors=3, num_q_layers_inner_residual=None):
        super().__init__()
        self.n_resgroups = n_resgroups
        self.n_resblocks = n_resblocks
        self.head = nn.Sequential(conv(n_colors, n_feats, 3))
        self.body = nn.ModuleList(
            [QResidualGroup(n_feats, 3, reduction, n_resblocks, 'standard', num_metadata,
                            pa=False, q_layer=True,
                            num_q_layers=num_q_layers_inner_residual)
             for _ in range(n_resgroups)] + [conv(n_feats, n_feats, 3)])
        self.csa = CSAM()
        self.la = LAM()
        self.last_conv = conv(n_feats * (n_resgroups + 1), n_feats, 3)
        self.last = conv(n_feats * 2, n_feats, 3)
        self.tail = nn.Sequential(Upsampler(scale, n_feats), conv(n_feats, n_colors, 3))

    def forward(self, x, metadata):
        x = self.head(x)
        outs, res = [], x
        for group in self.body[:-1]:
            res = group(res, metadata)
            outs.append(res)
        return holistic_fusion(self, outs, x)
