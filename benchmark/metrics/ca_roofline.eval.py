"""The channel-attention layers' share of their memory roofline: the bytes each call
needs (the map read once and written once, the denses' weights, the gate) over the
card's memory rate, divided by the calls' card time from CUDA events in hooks on every
CALayer / QCALayer."""
from benchmark import flops

PROBES = ('ca_events',)


def read(ctx):
    calls = ctx['probes'].get('ca_events')
    if not calls or not ctx['peaks']:
        return None
    reduction = ctx['config']['sizes']['reduction']
    moved = 0
    for c in calls:
        n, ch, h, w = c['shape']
        moved += flops.ca_bytes(n, h, w, ch, c['itemsize'], reduction, gate=c['gate'])
    bound_s = moved / ctx['peaks']['memory_bytes_per_s']
    return 100.0 * bound_s / (sum(c['ms'] for c in calls) * 1e-3)
