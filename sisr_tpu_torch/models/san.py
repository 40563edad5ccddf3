"""SAN: the second-order attention network (PyTorch port of sisr_tpu's
``models/san.py``; ref: Code/SISR/models/advanced/SAN_blocks.py,
advanced/architectures.py:244-311).

* :class:`SOCA`, second-order channel attention: the population covariance of the
  channels over the pixels (``E[xx^T] - mean mean^T``, two products, not the
  reference's M x M centring matrix), its square root by five Newton-Schulz
  iterations, the row mean, and a reduce / expand MLP with a sigmoid gate;
* :class:`NonLocalBlock2D`, the embedded-gaussian non-local block, and
  :class:`NonlocalCA`, which runs one shared block on each image quadrant;
* :class:`RB`, :class:`LSRAG` (local-source residual attention groups) and
  :class:`SAN`.

Their math lives in functions (:func:`second_order_pool`, :func:`embedded_gaussian`,
:func:`max_pool2`) that the int8 programs of ``ops/quantization.py`` share.  Both
attentions compute in float32 whatever the forward's type: the covariance, the
Newton-Schulz products and the non-local logits run with autocast off on float32
tensors (the covariance cancels, and bf16 would round the logits inside the softmax),
as sisr_tpu's ``preferred_element_type=float32`` products do; only the softmax's
output is cast to the map's type.  The products use no TF32 unless the caller turned
it on (``torch.backends.cuda.matmul.allow_tf32``, False by default).  Training
differentiates through the iterations with autograd: the matrices are (B, C, C), a few
hundred kB a step, so nothing is recomputed.

Module and attribute names follow the reference's, so ``state_dict`` keys are those
sisr_tpu's ``convert_san`` reads: ``head.0``, ``non_local.non_local.{g.0, theta, phi.0,
W}``, ``RG.<g>.rcab.<b>.conv_first.{0,2}``, ``RG.<g>.soca.conv_du.{0,2}``,
``RG.<g>.conv_last``, ``tail.0.<2i>``, ``tail.1`` and ``gamma``.  Like sisr_tpu, the
port does not build the parameters the reference registers and its forward never uses
(the top-level ``conv_last``, each ``RG.<g>.gamma`` and ``non_local.soca.*``);
``tools.convert_weights.drop_dead_reference_keys`` drops them from a reference
checkpoint.
"""
import torch
from torch import nn
from torch.nn import functional as F

from .blocks import Upsampler, conv

SOCA_CROP = 1000  # SOCA pools at most the centre 1000 x 1000 pixels (ref: SAN_blocks.py)
COV_ROWS = 256  # pixels a product of covariance_pool's batch


def covariance_pool(x):
    """(B, H, W, C) -> (B, C, C) float32 population covariance over the pixels.

    The second moment is a batch of products over COV_ROWS pixels each (the pixels
    zero-padded to a multiple), summed: one (C, M) x (M, C) product an image, M about
    16k at the eval shapes, ran on a few of the card's SMs."""
    b, h, w, c = x.shape
    m = h * w
    flat = x.reshape(b, m, c).float()
    mean = flat.mean(dim=1)
    parts = -(-m // COV_ROWS)
    if parts * COV_ROWS > m:
        flat = F.pad(flat, (0, 0, 0, parts * COV_ROWS - m))
    chunks = flat.view(b * parts, COV_ROWS, c)
    second = torch.bmm(chunks.transpose(1, 2), chunks).view(b, parts, c, c).sum(dim=1) / m
    return second - mean[:, :, None] * mean[:, None, :]


def newton_schulz_sqrt(a, num_iters=5):
    """Matrix square root of (B, D, D) ``a`` by Newton-Schulz iteration (ref:
    mpncov.py:49-76): normalised by the trace, iterated, scaled back by its square
    root."""
    dim = a.shape[-1]
    i3 = 3.0 * torch.eye(dim, dtype=a.dtype, device=a.device)
    norm_a = a.diagonal(dim1=1, dim2=2).sum(dim=-1)
    a_n = a / norm_a[:, None, None]
    zy = 0.5 * (i3 - a_n)
    y = torch.bmm(a_n, zy)
    z = zy
    for _ in range(num_iters - 2):
        zy = 0.5 * (i3 - torch.bmm(z, y))
        y, z = torch.bmm(y, zy), torch.bmm(zy, z)
    zy = 0.5 * torch.bmm(y, i3 - torch.bmm(z, y))
    return zy * torch.sqrt(norm_a)[:, None, None]


def second_order_pool(x):
    """SOCA's pooled (B, C) float32 vector of an NHWC map: the covariance of its centre
    crop (at most SOCA_CROP square; the crop is static, fixed by the shape), its
    square root, the mean of each column."""
    b, h, w, c = x.shape
    hs = 0 if h < SOCA_CROP else (h - SOCA_CROP) // 2
    ws = 0 if w < SOCA_CROP else (w - SOCA_CROP) // 2
    x_sub = x[:, hs:hs + min(h, SOCA_CROP), ws:ws + min(w, SOCA_CROP), :]
    with torch.autocast(x.device.type, enabled=False):
        return newton_schulz_sqrt(covariance_pool(x_sub)).mean(dim=1)


def max_pool2(x):
    """2 x 2 max-pool, stride 2, of an NHWC map (odd sizes floor)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def embedded_gaussian(theta, phi, g):
    """The non-local block's attention on NHWC maps: ``softmax(theta phi^T) g``, theta
    (B, H, W, I) at every pixel, phi and g pooled.  The logits and the softmax are
    float32; the attention is cast to g's type for its product with g.  Returns
    (B, H, W, I) in g's type."""
    b, h, w, i = theta.shape
    with torch.autocast(theta.device.type, enabled=False):
        f = torch.bmm(theta.reshape(b, h * w, i).float(),
                      phi.reshape(b, -1, i).float().transpose(1, 2))
        f = torch.softmax(f, dim=-1).to(g.dtype)
        y = torch.bmm(f, g.reshape(b, -1, i))
    return y.view(b, h, w, i)


def quadrants(fn, x, h_axis, w_axis):
    """``fn`` on each quadrant of x (split at h // 2 and w // 2, so odd sizes give
    quadrants that differ by a row or a column), stitched back: NonlocalCA's split
    (ref: SAN_blocks.py:305-336)."""
    h1, w1 = x.shape[h_axis] // 2, x.shape[w_axis] // 2

    def part(hs, ws):
        return fn(x.narrow(h_axis, *hs).narrow(w_axis, *ws))

    top = (0, h1), (h1, x.shape[h_axis] - h1)
    left = (0, w1), (w1, x.shape[w_axis] - w1)
    rows = [torch.cat([part(hs, ws) for ws in left], dim=w_axis) for hs in top]
    return torch.cat(rows, dim=h_axis)


class SOCA(nn.Module):
    """Second-order channel attention (ref: SAN_blocks.py:244-302): x times
    ``sigmoid(expand(relu(reduce(second_order_pool(x)))))``, the MLP in float32.  Keys
    ``conv_du.{0,2}``."""

    def __init__(self, channel, reduction=8):
        super().__init__()
        if channel < reduction:
            raise ValueError('SOCA: channel (%d) < reduction (%d)' % (channel, reduction))
        self.conv_du = nn.Sequential(
            nn.Conv2d(channel, channel // reduction, 1, padding=0, bias=True),
            nn.ReLU(inplace=True),
            nn.Conv2d(channel // reduction, channel, 1, padding=0, bias=True),
            nn.Sigmoid())

    def gate(self, x):
        """The (B, C) float32 attention of an NCHW map."""
        pooled = second_order_pool(x.permute(0, 2, 3, 1))
        reduce, expand = self.conv_du[0], self.conv_du[2]
        with torch.autocast(x.device.type, enabled=False):
            y = F.linear(pooled, reduce.weight.flatten(1), reduce.bias)
            return torch.sigmoid(F.linear(torch.relu(y), expand.weight.flatten(1),
                                          expand.bias))

    def forward(self, x):
        return x * self.gate(x).to(x.dtype)[:, :, None, None]


class NonLocalBlock2D(nn.Module):
    """Embedded-gaussian non-local block (ref: SAN_blocks.py:11-148, the mode SAN
    uses): ``W(softmax(theta(x) phi(x)^T) g(x)) + x``.

    The reference's 2-D branch rebinds its ``sub_sample`` flag to a class, which is
    truthy, so g and phi are always 2 x 2 max-pooled (``g.0``/``phi.0`` are the convs);
    the output conv ``W`` starts at zero, so the block starts as the identity (it has
    ``zero_init``, which :func:`~sisr_tpu_torch.models.blocks.torch_default_init_`
    honours)."""

    def __init__(self, in_channels, inter_channels):
        super().__init__()
        self.g = nn.Sequential(nn.Conv2d(in_channels, inter_channels, 1), nn.MaxPool2d(2))
        self.theta = nn.Conv2d(in_channels, inter_channels, 1)
        self.phi = nn.Sequential(nn.Conv2d(in_channels, inter_channels, 1), nn.MaxPool2d(2))
        self.W = nn.Conv2d(inter_channels, in_channels, 1)
        self.W.zero_init = True
        with torch.no_grad():
            self.W.weight.zero_()
            self.W.bias.zero_()

    def forward(self, x):
        nhwc = [t.permute(0, 2, 3, 1) for t in (self.theta(x), self.phi(x), self.g(x))]
        return self.W(embedded_gaussian(*nhwc).permute(0, 3, 1, 2)) + x


class NonlocalCA(nn.Module):
    """One shared non-local block on each image quadrant (ref: SAN_blocks.py:305-336;
    the reference's memory workaround for the (HW)^2 attention, kept for its output).
    Key ``non_local``."""

    def __init__(self, in_feat=64, inter_feat=8):
        super().__init__()
        self.non_local = NonLocalBlock2D(in_feat, inter_feat)

    def forward(self, x):
        return quadrants(self.non_local, x, 2, 3)


class RB(nn.Module):
    """conv-relu-conv + x (ref: SAN_blocks.py:339-363).  Keys ``conv_first.{0,2}``."""

    def __init__(self, n_feat, kernel_size=3):
        super().__init__()
        self.conv_first = nn.Sequential(conv(n_feat, n_feat, kernel_size), nn.ReLU(inplace=True),
                                        conv(n_feat, n_feat, kernel_size))

    def forward(self, x):
        return self.conv_first(x) + x


class LSRAG(nn.Module):
    """Local-source residual attention group (ref: SAN_blocks.py:366-411): the blocks,
    SOCA, ``conv_last``, plus the group's input.  Keys ``rcab.<b>``, ``soca``,
    ``conv_last``."""

    def __init__(self, n_feat, kernel_size=3, reduction=8, n_resblocks=10):
        super().__init__()
        self.rcab = nn.ModuleList(RB(n_feat, kernel_size) for _ in range(n_resblocks))
        self.soca = SOCA(n_feat, reduction)
        self.conv_last = conv(n_feat, n_feat, kernel_size)

    def forward(self, x):
        res = x
        for block in self.rcab:
            res = block(res)
        return self.conv_last(self.soca(res)) + x


def san_body(model, x, group_call):
    """SAN's and Q-SAN's forward after the module's own arguments: the head, the shared
    non-local block, the groups (``group_call(group, xx)``) each plus ``gamma`` times
    the non-local output, the non-local block again, plus the head's output, the
    tail."""
    x = model.head(x)
    xx = model.non_local(x)
    residual = xx
    for group in model.RG:
        xx = group_call(group, xx) + model.gamma.to(xx.dtype) * residual
    return model.tail(model.non_local(xx) + x)


class SAN(nn.Module):
    """(ref: advanced/architectures.py:244-311).  20 LSRAG x 10 RB, 64 features,
    reduction 16 by default.  ``gamma`` starts at 0, as in the reference."""

    def __init__(self, n_resgroups=20, n_resblocks=10, n_feats=64, reduction=16, scale=4,
                 n_colors=3):
        super().__init__()
        self.n_resgroups = n_resgroups
        self.n_resblocks = n_resblocks
        self.gamma = nn.Parameter(torch.zeros(1))
        self.head = nn.Sequential(conv(n_colors, n_feats, 3))
        self.non_local = NonlocalCA(n_feats, n_feats // 8)
        self.RG = nn.ModuleList(LSRAG(n_feats, 3, reduction, n_resblocks)
                                for _ in range(n_resgroups))
        self.tail = nn.Sequential(Upsampler(scale, n_feats), conv(n_feats, n_colors, 3))

    def forward(self, x):
        return san_body(self, x, lambda group, xx: group(xx))
