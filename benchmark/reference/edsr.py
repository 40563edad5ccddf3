"""Plain float32 EDSR (Lim et al., CVPR Workshops 2017), written from the paper.  Keys
are those of the reference implementation's torch modules.

A head conv; ``num_blocks`` residual blocks ``x + res_scale * conv(relu(conv(x)))``
with no batch norm; a body-tail conv and the long skip; the x4 upsampler and a last
conv.  Departures from the paper: no mean shift (the framework has none) and inputs
in [0, 1], as the framework feeds them.
"""
from .common import conv2d, exact, upsample_x4


def param_shapes(sizes):
    """[(key, shape, fan_in)] of every parameter, in the module's order."""
    c = sizes['num_features']
    out = []

    def conv(name, cin, cout, k=3):
        out.append((name + '.weight', (cout, cin, k, k), cin * k * k))
        out.append((name + '.bias', (cout,), cin * k * k))

    conv('head.0', 3, c)
    for b in range(sizes['num_blocks']):
        conv('body.%d.body.0' % b, c, c)
        conv('body.%d.body.2' % b, c, c)
    conv('body.%d' % sizes['num_blocks'], c, c)
    conv('tail.0.0', c, 4 * c)
    conv('tail.0.2', c, 4 * c)
    conv('tail.1', c, 3)
    return out


def forward(p, x, meta, sizes, conv=conv2d, carry=exact):
    """SR of an NCHW float32 LR batch ``x`` (``meta`` is not used).  ``conv`` and
    ``carry`` (applied to the residual stream after every add) are the arithmetic of
    a lower-precision control (``quant.py``)."""
    def c(name, v):
        return conv(v, p[name + '.weight'], p[name + '.bias'], name)

    x = carry(c('head.0', x))
    res = x
    for b in range(sizes['num_blocks']):
        blk = 'body.%d.body.' % b
        res = carry(res + sizes['res_scale'] * c(blk + '2', c(blk + '0', res).relu()))
    res = carry(c('body.%d' % sizes['num_blocks'], res) + x)
    return c('tail.1', upsample_x4(p, 'tail.0', res, conv))
