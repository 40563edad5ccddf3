"""Share of the probe stretch (whole epochs) in which the card was idle while the
training loop's main thread waited for its next batch: idle gaps whose innermost open
program span is ``train.loader_wait`` (``probes/program_spans.idle_by_span``)."""
from benchmark.probes.program_spans import idle_by_span

PROBES = ('program_spans',)


def read(ctx):
    data = ctx['probes'].get('program_spans')
    if ctx['job'] != 'train' or not data or not data['device'] or not data['spans']:
        return None
    lo, hi = data['window']
    return 100.0 * idle_by_span(data).get('train.loader_wait', 0.0) / ((hi - lo) * 1e-9)
