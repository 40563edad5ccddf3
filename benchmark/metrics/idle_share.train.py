"""Share of the profiled stretch (whole epochs) in which no operation ran on the card:
1 minus the union of the card's operation intervals over the stretch."""
from benchmark import traces


def read(ctx):
    trace = ctx.get('trace')
    if ctx['job'] != 'train' or not trace or trace['window'] is None or not trace['device']:
        return None
    return 100.0 * (1.0 - traces.busy_s(trace) / traces.window_s(trace))
