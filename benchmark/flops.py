"""The benchmark's frozen arithmetic: forward FLOPs (2 x MACs) of each model family,
the convs a forward runs with their shapes, the FLOPs of a training step, and the bytes
of a channel-attention call.

``edsr_flops_per_image``, ``rcan_flops_per_image`` and ``qrcan_flops_per_image`` are
copies of ``sisr_tpu_torch/tools/flops.py`` (which held them within 0.1% of the FLOPs of
every Conv2d the port's modules run); a test holds the copies equal to it at the
cells' shapes.  They live here so that no later change to the program moves the
yardstick.
"""


def _conv(hw, cin, cout, k=3):
    return 2.0 * hw * hw * cin * cout * k * k


def _upsampler(hw, feats, scale):
    total = 0.0
    if scale == 3:
        return _conv(hw, feats, feats * 9), hw * 3
    s = scale
    while s > 1:
        total += _conv(hw, feats, feats * 4)
        hw *= 2
        s //= 2
    return total, hw


def edsr_flops_per_image(lr=128, feats=64, blocks=16, scale=4):
    """EDSR: head + residual body (2 convs/block) + body-tail + upsampler + tail."""
    total = _conv(lr, 3, feats)
    total += blocks * 2 * _conv(lr, feats, feats)
    total += _conv(lr, feats, feats)
    up, hw = _upsampler(lr, feats, scale)
    total += up + _conv(hw, feats, 3)
    return total


def rcan_flops_per_image(lr=128, feats=64, groups=10, blocks=20, scale=4, reduction=16):
    """RCAN: head + groups x (blocks x RCAB + group-tail conv) + body-tail + upsampler +
    tail; an RCAB is 2 convs and the CA's two 1x1 denses on the pooled vector."""
    ca = 2.0 * 2 * feats * (feats // reduction)
    rcab = 2 * _conv(lr, feats, feats) + ca
    total = _conv(lr, 3, feats)
    total += groups * (blocks * rcab + _conv(lr, feats, feats))
    total += _conv(lr, feats, feats)
    up, hw = _upsampler(lr, feats, scale)
    total += up + _conv(hw, feats, 3)
    return total


def qrcan_flops_per_image(lr=128, feats=64, groups=10, blocks=20, scale=4, reduction=16,
                          num_metadata=1, q_layers=2):
    """Q-RCAN = RCAN + one meta-attention MLP (num_metadata -> feats/2 -> feats) a
    block, on the metadata vector."""
    sizes = [num_metadata] + [feats // m for m in range(q_layers, 0, -1)]
    para_ca = sum(2.0 * a * b for a, b in zip(sizes, sizes[1:]))
    return rcan_flops_per_image(lr, feats, groups, blocks, scale, reduction) \
        + groups * blocks * para_ca


def forward_flops(family, sizes, lr):
    """Forward FLOPs of one image of side ``lr``."""
    if family == 'qrcan':
        return qrcan_flops_per_image(lr, sizes['n_feats'], sizes['n_resgroups'],
                                     sizes['n_resblocks'], sizes['scale'],
                                     sizes['reduction'], sizes['num_metadata'])
    if family == 'edsr':
        return edsr_flops_per_image(lr, sizes['num_features'], sizes['num_blocks'],
                                    sizes['scale'])
    raise KeyError('no FLOP formula for %r' % family)


def convs(family, sizes, lr):
    """[(side, cin, cout, k)] of every spatial conv of a forward on an image of side
    ``lr``, in order (the CA and meta-attention denses act on vectors and are not
    listed)."""
    if family == 'qrcan':
        c, depth = sizes['n_feats'], sizes['n_resgroups'] * (2 * sizes['n_resblocks'] + 1) + 1
    elif family == 'edsr':
        c, depth = sizes['num_features'], 2 * sizes['num_blocks'] + 1
    else:
        raise KeyError('no conv list for %r' % family)
    if sizes['scale'] != 4:
        raise ValueError('the conv list is written for x4')
    return ([(lr, 3, c, 3)] + [(lr, c, c, 3)] * depth
            + [(lr, c, 4 * c, 3), (2 * lr, c, 4 * c, 3), (4 * lr, c, 3, 3)])


def train_flops(family, sizes, lr):
    """FLOPs of one training crop of side ``lr``: the forward, and a backward of the
    weight gradient of every conv and the input gradient of every conv but the first
    (each as many FLOPs as the conv's forward)."""
    layers = convs(family, sizes, lr)
    first = _conv(*layers[0])
    return forward_flops(family, sizes, lr) + 2 * sum(_conv(*l) for l in layers) - first


def conv_bound_s(layers, images, in_bytes, out_bytes, ops_per_s, bytes_per_s):
    """The least time the card could take for ``layers`` over ``images`` images: per
    conv the larger of its operations over the peak rate and its bytes (the input read
    once at ``in_bytes`` an element, the output written once at ``out_bytes``, the
    weights once at ``in_bytes``) over the memory rate."""
    total = 0.0
    for side, cin, cout, k in layers:
        pixels = images * side * side
        ops = 2.0 * pixels * cin * cout * k * k
        moved = pixels * (cin * in_bytes + cout * out_bytes) + cin * cout * k * k * in_bytes
        total += max(ops / ops_per_s, moved / bytes_per_s)
    return total


def ca_bytes(n, h, w, c, itemsize, reduction=16, m=0, gate=False):
    """Bytes a channel-attention call needs: the map read once and written once, the
    two denses' weights and biases (float32), the metadata and the gate."""
    r = c // reduction
    weights = 4 * ((c + m) * r + r + r * c + c)
    return 2 * n * h * w * c * itemsize + weights + 4 * n * m + (4 * n * c if gate else 0)
