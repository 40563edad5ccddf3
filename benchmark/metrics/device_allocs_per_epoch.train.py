"""Device allocations (``cudaMalloc``) of the caching allocator an epoch: the program's
``cuda.device_allocs`` counter over its ``train.epoch`` spans, in the probe stretch."""
PROBES = ('program_spans',)


def read(ctx):
    data = ctx['probes'].get('program_spans')
    if not data or 'cuda.device_allocs' not in data['counters']:
        return None
    epochs = sum(s['name'] == 'train.epoch' for s in data['spans'])
    return float(data['counters']['cuda.device_allocs']) / epochs if epochs else None
