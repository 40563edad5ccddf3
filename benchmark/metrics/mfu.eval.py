"""The whole eval step's share of the card's peak: the forward's FLOPs an image (the
frozen formulas of ``benchmark/flops.py``) times the window's images a second, over the
published dense peak of the precision the mix names (``peak``)."""
from benchmark import flops


def read(ctx):
    if ctx['job'] != 'eval' or not ctx['peaks']:
        return None
    cfg = ctx['config']
    per_image = flops.forward_flops(cfg['reference'], cfg['sizes'], ctx['facts']['lr_side'])
    return 100.0 * per_image * ctx['rate'] / ctx['peaks'][ctx['traffic']['peak']]
