"""Analytic forward-FLOP models (2*MACs) for MFU accounting (PyTorch port of
sisr_tpu's ``tools/flops.py``, the same functions, arguments and results).

Counts every conv (3x3 unless noted) at its true spatial resolution, including the
PixelShuffle upsampler stages that run at intermediate/HR resolution.  Attention
bookkeeping (GAP, reduce/expand 1x1 "denses", sigmoid scale) is counted where it is
non-negligible; elementwise adds/activations are not (sub-0.1% for these nets).
``chip_smoke.py`` holds these counts within 0.1% of the FLOPs of every Conv2d the
port's own modules run (forward hooks) at full width.

:func:`peak_flops` is the card's dense bf16 peak, the denominator of an MFU share:
``BENCH_PEAK_TFLOPS`` (TFLOP/s) when set, else :data:`PEAK_BF16_TFLOPS` by the card's
name.  Used by ``bench_models --paper``; :func:`bound_ms` by ``bench_ca_epilogue``.
"""
import os

# by torch.cuda.get_device_name(), the H100 SXM5's data-sheet figures: the dense (no
# sparsity) bf16 tensor-core peak, the memory rate and the f32 rate outside the tensor
# cores
PEAK_BF16_TFLOPS = {'NVIDIA H100 80GB HBM3': 989.0}
MEMORY_BYTES_PER_S = {'NVIDIA H100 80GB HBM3': 3.35e12}
F32_CUDA_CORE_FLOPS = {'NVIDIA H100 80GB HBM3': 67e12}


def bound_ms(bytes_moved, ops, device=None):
    """The least time in ms the card could take for work that moves ``bytes_moved``
    and does ``ops`` f32 operations on its CUDA cores (the larger of the two), or None
    for a card the tables lack."""
    import torch
    name = torch.cuda.get_device_name(device)
    if name not in MEMORY_BYTES_PER_S:
        return None
    return max(bytes_moved / MEMORY_BYTES_PER_S[name], ops / F32_CUDA_CORE_FLOPS[name]) * 1e3


def peak_flops(device=None):
    """The dense bf16 peak of ``device``'s card in FLOP/s: ``BENCH_PEAK_TFLOPS`` when
    set, else the table's entry for the card's name; a card the table lacks raises."""
    override = os.environ.get('BENCH_PEAK_TFLOPS')
    if override:
        return float(override) * 1e12
    import torch
    name = torch.cuda.get_device_name(device)
    if name not in PEAK_BF16_TFLOPS:
        raise RuntimeError('no bf16 peak known for %r (known: %s): set BENCH_PEAK_TFLOPS '
                           'to its dense bf16 TFLOP/s' % (name, sorted(PEAK_BF16_TFLOPS)))
    return PEAK_BF16_TFLOPS[name] * 1e12


def _conv(hw, cin, cout, k=3):
    return 2.0 * hw * hw * cin * cout * k * k


def _upsampler(hw, feats, scale):
    """conv(f->4f)+PixelShuffle(2) chain (or one x3 stage), as in the reference
    common.Upsampler (ref: advanced/common.py:20-45)."""
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


def qrcan_flops_per_image(lr=128, feats=64, groups=10, blocks=20, scale=4,
                          reduction=16, num_metadata=1, q_layers=2):
    """QRCAN = RCAN + one ParaCALayer per RCAB (the q_layer MLP on the pooled metadata
    VECTOR: num_metadata -> feats/2 -> feats per image), counted so the QRCAN MFU row
    is labelled with its own model's arithmetic, not RCAN's."""
    sizes = [num_metadata] + [feats // m for m in range(q_layers, 0, -1)]
    para_ca = sum(2.0 * a * b for a, b in zip(sizes, sizes[1:]))
    return rcan_flops_per_image(lr, feats, groups, blocks, scale, reduction) \
        + groups * blocks * para_ca


def rcan_flops_per_image(lr=128, feats=64, groups=10, blocks=20, scale=4,
                         reduction=16):
    """RCAN: head + groups x (blocks x RCAB + group-tail conv) + body-tail +
    upsampler + tail.  An RCAB is 2 convs + CA (two 1x1 'denses' f->f/r->f on the
    pooled vector — negligible but counted)."""
    ca = 2.0 * 2 * feats * (feats // reduction)  # per image, spatially pooled
    rcab = 2 * _conv(lr, feats, feats) + ca
    total = _conv(lr, 3, feats)
    total += groups * (blocks * rcab + _conv(lr, feats, feats))
    total += _conv(lr, feats, feats)
    up, hw = _upsampler(lr, feats, scale)
    total += up + _conv(hw, feats, 3)
    return total
