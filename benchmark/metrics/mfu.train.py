"""The whole train step's share of the card's peak: a crop's forward and backward
FLOPs (``benchmark/flops.train_flops``: no flat 3x) times the window's crops a second,
over the published dense peak of the precision the mix names (``peak``: TF32 for
float32 convs under cuDNN's default)."""
from benchmark import flops


def read(ctx):
    if ctx['job'] != 'train' or not ctx['peaks']:
        return None
    cfg = ctx['config']
    per_crop = flops.train_flops(cfg['reference'], cfg['sizes'], ctx['facts']['lr_side'])
    return 100.0 * per_crop * ctx['rate'] / ctx['peaks'][ctx['traffic']['peak']]
