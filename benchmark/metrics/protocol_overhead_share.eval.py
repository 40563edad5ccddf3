"""Share of the traced probe stretch (whole passes of the hub) spent outside the
program's eval step calls, each call timed to its completion on the card: the fused
protocol's own host work (batch iteration, the metric copies, the CSV reports)."""
PROBES = ('step_spans',)


def read(ctx):
    spans = ctx['probes'].get('step_spans')
    if not spans or not spans['seconds']:
        return None
    return 100.0 * (ctx['stretch_s'] - sum(spans['seconds'])) / ctx['stretch_s']
