"""Exact bucketed-eval spatial masking (PyTorch port of sisr_tpu's ``ops/masking.py``).

Bucketed eval zero-pads each LR image up to a multiple of the bucket size, so that
a set of differently sized images runs at a few shapes only.  Zero padding alone is
not faithful: biases and activations make the pad region non-zero, that bleeds back
into the valid region through the next 3x3 convolutions, and a global average pool
would average over the pad.  Two mechanisms restore exactness:

* :func:`conv_mask_hooks` registers, on every ``nn.Conv2d`` of one model and for the
  context's duration only, a forward pre-hook and a forward hook that re-zero the pad
  region of the conv's input and output, so each conv sees exactly the zero padding
  it would have seen at the true image boundary;
* :func:`masked_global_mean` (and the CA kernel's valid-extent pool,
  ``fused_channel_attention(..., valid_hw=...)``) average over valid pixels only.

A context (:class:`spatial_masks`) carries the bucket (H, W) and the true (h, w) of
the batch, as host integers.  An activation at R times the bucket resolution is
valid in its first (h*R, w*R) pixels.  Activations here are NCHW, as the port's
modules keep them; ``spatial_dims=(1, 2)`` serves NHWC tensors.
"""
import contextlib
import threading

import torch
from torch import nn

_ctx = threading.local()


def _state():
    return getattr(_ctx, 'state', None)


class spatial_masks:
    """Context manager that turns masking on.

    :param bucket_hw: padded (H, W) of the model input.
    :param valid_hw: the true (h, w) of the images in the batch.
    """

    def __init__(self, bucket_hw, valid_hw):
        # the last item caches each mask made in this context: every conv of a forward
        # asks for the same few
        self.value = (int(bucket_hw[0]), int(bucket_hw[1]),
                      (int(valid_hw[0]), int(valid_hw[1])), {})

    def __enter__(self):
        self._prev = _state()  # restored on exit: contexts nest
        _ctx.state = self.value
        return self

    def __exit__(self, *exc):
        _ctx.state = self._prev
        return False


def valid_extent(height, width):
    """(valid_h, valid_w) of an activation of spatial size (height, width), or None
    when masking is off or the size is not an integer multiple of the bucket's.

    As in sisr_tpu, None means the activation goes unmasked: a model whose activations
    leave the bucket grid (strided convs, pooling pyramids) must set
    ``bucketed_eval_ok = False`` on its handler."""
    st = _state()
    if st is None:
        return None
    bh, bw, (vh, vw), _ = st
    height, width = int(height), int(width)
    if height <= 0 or width <= 0 or height % bh or width % bw:
        return None
    return vh * (height // bh), vw * (width // bw)


def mask_for(x, spatial_dims=(2, 3)):
    """A validity mask of x's dtype and device that broadcasts against x (1 on the
    valid pixels, 0 on the pad), or None outside a context."""
    if x.dim() != 4:
        return None
    h_dim, w_dim = spatial_dims
    extent = valid_extent(x.shape[h_dim], x.shape[w_dim])
    if extent is None:
        return None
    cache = _state()[3]
    key = (x.shape[h_dim], x.shape[w_dim], spatial_dims, x.dtype, x.device)
    if key not in cache:
        vh, vw = extent
        rows = torch.arange(x.shape[h_dim], device=x.device) < vh
        cols = torch.arange(x.shape[w_dim], device=x.device) < vw
        shape = [1, 1, 1, 1]
        shape[h_dim], shape[w_dim] = x.shape[h_dim], x.shape[w_dim]
        cache[key] = (rows[:, None] & cols[None, :]).reshape(shape).to(x.dtype)
    return cache[key]


def apply_mask(x, spatial_dims=(2, 3)):
    """Zero the pad region of a 4-D activation (x as it is outside a context)."""
    m = mask_for(x, spatial_dims)
    return x if m is None else x * m


def masked_global_mean(x):
    """Global average pool of an NCHW map over valid pixels only: (N, C) in f32 (the
    plain mean outside a context).  The sum and the division by the pixel count are
    in f32, as in sisr_tpu; the map is masked again so the mean does not depend on
    the convs' masking."""
    extent = valid_extent(x.shape[2], x.shape[3]) if x.dim() == 4 else None
    if extent is None:
        return x.float().mean(dim=(2, 3))
    vh, vw = extent
    total = apply_mask(x).float().sum(dim=(2, 3))
    return total / x.new_full((), float(vh * vw), dtype=torch.float32)


def _mask_input(module, args):
    if _state() is not None and args and torch.is_tensor(args[0]) and args[0].dim() == 4:
        return (apply_mask(args[0]),) + tuple(args[1:])
    return None


def _mask_output(module, args, out):
    if _state() is not None and torch.is_tensor(out) and out.dim() == 4:
        return apply_mask(out)
    return None


@contextlib.contextmanager
def conv_mask_hooks(model):
    """Re-zero the pad region around every ``nn.Conv2d`` of ``model`` while the block
    runs (the counterpart of sisr_tpu's ``conv_mask_interceptor``): inputs, so that
    non-conv producers cannot leak non-zero pad values into a conv window at the true
    image boundary; outputs, so that non-conv consumers see zeros in the pad.  The
    hooks act only inside a :class:`spatial_masks` context, and are removed at exit."""
    handles = []
    try:
        for module in model.modules():
            if isinstance(module, nn.Conv2d):
                handles.append(module.register_forward_pre_hook(_mask_input))
                handles.append(module.register_forward_hook(_mask_output))
        yield model
    finally:
        for handle in handles:
            handle.remove()
