"""Card milliseconds of the train step's backward (the program's ``train.backward``
spans, timed by their CUDA events) a step (its ``train.steps`` counter), over the probe
stretch."""
PROBES = ('program_spans',)


def read(ctx):
    data = ctx['probes'].get('program_spans')
    steps = data and data['counters'].get('train.steps')
    ms = [s['device_ms'] for s in data['spans'] if s['name'] == 'train.backward'] \
        if steps else []
    if not ms or None in ms:
        return None
    return sum(ms) / steps
