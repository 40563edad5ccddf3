"""Share of the traced probe stretch (whole epochs) the training loop spent waiting
for its next batch from the loader."""
PROBES = ('loader_wait',)


def read(ctx):
    waits = ctx['probes'].get('loader_wait')
    if not waits or not waits['seconds']:
        return None
    return 100.0 * sum(waits['seconds']) / ctx['stretch_s']
