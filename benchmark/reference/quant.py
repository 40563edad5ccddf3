"""The reference in a lower precision, as the controls of the cells put it in the
program's place, one precision below the configuration's:

* :class:`Quantized`: integer arithmetic of a given width, symmetric per-output-channel
  weights, and per-tensor static activation scales from the largest magnitude each conv
  sees on a calibration batch, times a margin (the usual post-training scheme, Jacob et
  al., CVPR 2018, without zero points).  Every 3x3 and upsampler conv is quantised; the
  attention vectors stay float32.  At 4 bits it is the control of an int8 cell.
* :func:`conv_e4m3` and :func:`round_e4m3`: float8 e4m3 (Micikevicius et al., "FP8 Formats for Deep Learning",
  2022), each tensor scaled so that its largest magnitude meets the format's 448: every
  conv's input and weights (per output channel) and the residual stream after every
  add; products accumulate in float32, the attention vectors stay float32.  It is the
  control of a bfloat16 cell, whose activations and carry are bfloat16.
"""
import torch
from torch.nn import functional as F

from .common import conv2d


class Quantized:
    def __init__(self, bits, margin=1.1):
        self.qmax = 2 ** (bits - 1) - 1
        self.margin = margin
        self.absmax = {}

    def calibrate(self, x, weight, bias, name):
        """A float32 conv that records the largest magnitude of its input."""
        self.absmax[name] = max(self.absmax.get(name, 0.0), float(x.abs().max()))
        return conv2d(x, weight, bias)

    def conv(self, x, weight, bias, name):
        """The conv of the quantised input and weights, rescaled, plus the bias."""
        sa = self.absmax[name] * self.margin / self.qmax
        xq = torch.clamp(torch.round(x / sa), -self.qmax, self.qmax)
        sw = weight.abs().amax(dim=(1, 2, 3), keepdim=True).clamp(min=1e-12) / self.qmax
        wq = torch.clamp(torch.round(weight / sw), -self.qmax, self.qmax)
        y = F.conv2d(xq, wq, None, padding=weight.shape[-1] // 2)
        return y * (sa * sw.view(1, -1, 1, 1)) + bias.view(1, -1, 1, 1)


E4M3_MAX = 448.0


def round_e4m3(x, dim=None):
    """``x`` rounded to float8 e4m3 under a scale that takes its largest magnitude (over
    all of it, or over each slice along ``dim``) to 448, back in float32."""
    if dim is None:
        amax = x.abs().max()
    else:
        amax = x.abs().amax(dim=tuple(d for d in range(x.dim()) if d != dim), keepdim=True)
    scale = amax.clamp(min=1e-30) / E4M3_MAX
    q = (x / scale).clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)
    return q.to(torch.float32) * scale


def conv_e4m3(x, weight, bias, name=None):
    """The conv of the e4m3 input and weights, accumulated in float32, plus the bias."""
    return conv2d(round_e4m3(x), round_e4m3(weight, dim=0), bias)
