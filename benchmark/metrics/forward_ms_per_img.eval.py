"""Card milliseconds of the model forward an image: CUDA events in forward pre-hooks
and hooks on the program's top module, over the probe stretch."""
PROBES = ('forward_events',)


def read(ctx):
    calls = ctx['probes'].get('forward_events')
    if not calls:
        return None
    return sum(c['ms'] for c in calls) / sum(c['images'] for c in calls)
