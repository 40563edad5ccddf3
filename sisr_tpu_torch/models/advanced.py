"""RCAN (PyTorch port of sisr_tpu's ``models/advanced.py``; the other families of that
module come with later slices)."""
from torch import nn

from .blocks import ResidualGroup, Upsampler, conv


class RCAN(nn.Module):
    """(ref: advanced/architectures.py:126-180).  10 groups x 20 RCABs by default.

    Keys: ``head.0``, ``body.<g>.body.<b>.body.{0,2}``,
    ``body.<g>.body.<b>.body.3.conv_du.{0,2}``, ``body.<g>.body.<n_resblocks>``,
    ``body.<n_resgroups>``, ``tail.0.<2i>``, ``tail.1``."""

    def __init__(self, n_resblocks=20, n_resgroups=10, n_feats=64, in_feats=3, out_feats=3,
                 scale=4, reduction=16):
        super().__init__()
        self.n_resblocks = n_resblocks
        self.n_resgroups = n_resgroups
        self.head = nn.Sequential(conv(in_feats, n_feats, 3))
        self.body = nn.Sequential(
            *[ResidualGroup(n_feats, 3, reduction, n_resblocks) for _ in range(n_resgroups)],
            conv(n_feats, n_feats, 3))
        self.tail = nn.Sequential(Upsampler(scale, n_feats), conv(n_feats, out_feats, 3))

    def forward(self, x):
        x = self.head(x)
        res = self.body(x) + x
        return self.tail(res)
