"""Plain float32 Q-RCAN: RCAN (Zhang et al., ECCV 2018) with a meta-attention layer in
every residual channel attention block (Aquilina et al., IEEE SPL 2021), written from
the papers.  Keys are those of the reference implementation's torch modules.

Block b of group g: ``res = conv(relu(conv(x)))``; ``res`` times its channel attention
(the ``standard`` style: the metadata takes no part in the pooled vector) and times the
meta-attention gate ``sigmoid(W2 relu(W1 m + b1) + b2)`` of the image's degradation
vector m (widths M -> C/2 -> C); then ``x + res``.  A group ends in a conv and its own
skip; the body ends in a conv and the long skip; the x4 upsampler and a last conv.
Departures from the papers: none of RCAN's mean shift (the framework has none) and
inputs in [0, 1], as the framework feeds them.
"""
from .common import channel_attention, conv2d, dense, exact, upsample_x4


def param_shapes(sizes):
    """[(key, shape, fan_in)] of every parameter, in the module's order."""
    c, r, m = sizes['n_feats'], sizes['n_feats'] // sizes['reduction'], sizes['num_metadata']
    out = []

    def conv(name, cin, cout, k=3):
        out.append((name + '.weight', (cout, cin, k, k), cin * k * k))
        out.append((name + '.bias', (cout,), cin * k * k))

    conv('head.0', 3, c)
    for g in range(sizes['n_resgroups']):
        for b in range(sizes['n_resblocks']):
            blk = 'body.%d.body.%d' % (g, b)
            conv(blk + '.body.0', c, c)
            conv(blk + '.body.2', c, c)
            conv(blk + '.final_body.conv_du.0', c, r, 1)
            conv(blk + '.final_body.conv_du.2', r, c, 1)
            conv(blk + '.q_node.attribute_integrator.0', m, c // 2, 1)
            conv(blk + '.q_node.attribute_integrator.2', c // 2, c, 1)
        conv('body.%d.final_body' % g, c, c)
    conv('final_body', c, c)
    conv('tail.0.0', c, 4 * c)
    conv('tail.0.2', c, 4 * c)
    conv('tail.1', c, 3)
    return out


def forward(p, x, meta, sizes, conv=conv2d, carry=exact):
    """SR of an NCHW float32 LR batch ``x`` with its (N, M) metadata.  ``conv`` and
    ``carry`` (applied to the residual stream after every add) are the arithmetic of
    a lower-precision control (``quant.py``)."""
    def c(name, v):
        return conv(v, p[name + '.weight'], p[name + '.bias'], name)

    x = carry(c('head.0', x))
    res = x
    for g in range(sizes['n_resgroups']):
        skip = res
        for b in range(sizes['n_resblocks']):
            blk = 'body.%d.body.%d' % (g, b)
            y = c(blk + '.body.2', c(blk + '.body.0', res).relu())
            q = blk + '.q_node.attribute_integrator.'
            gate = dense(dense(meta, p[q + '0.weight'], p[q + '0.bias']).relu(),
                         p[q + '2.weight'], p[q + '2.bias']).sigmoid()
            ca = blk + '.final_body.conv_du.'
            y = channel_attention(y, p[ca + '0.weight'], p[ca + '0.bias'],
                                  p[ca + '2.weight'], p[ca + '2.bias'], gate)
            res = carry(res + y)
        res = carry(c('body.%d.final_body' % g, res) + skip)
    res = carry(c('final_body', res) + x)
    return c('tail.1', upsample_x4(p, 'tail.0', res, conv))
