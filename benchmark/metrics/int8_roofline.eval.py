"""The int8 program's share of its roofline: per conv the larger of its operations
(2 M N K) over the int8 tensor-core peak and its bytes (the int8 input read once, the
bf16 output written once, the weights) over the memory rate, summed over the forward's
convs and images, divided by the program's card time from CUDA events around each
call of it."""
from benchmark import flops

PROBES = ('int8_events',)


def read(ctx):
    calls = ctx['probes'].get('int8_events')
    if not calls or not ctx['peaks']:
        return None
    cfg, peaks = ctx['config'], ctx['peaks']
    layers = flops.convs(cfg['reference'], cfg['sizes'], ctx['facts']['lr_side'])
    bound_s = flops.conv_bound_s(layers, sum(c['images'] for c in calls), 1, 2,
                                 peaks['int8'], peaks['memory_bytes_per_s'])
    return 100.0 * bound_s / (sum(c['ms'] for c in calls) * 1e-3)
