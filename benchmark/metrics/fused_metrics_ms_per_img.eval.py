"""Card milliseconds of the fused eval step's work around the forward an image: the
program's ``eval.prep`` (the LR's device bicubic, YCbCr, the module's input) and
``eval.metrics`` (the SR's YCbCr, PSNR and SSIM rows) spans, timed by their CUDA events,
over its ``eval.images`` counter, in the probe stretch."""
PROBES = ('program_spans',)
PARTS = ('eval.prep', 'eval.metrics')


def read(ctx):
    data = ctx['probes'].get('program_spans')
    images = data and data['counters'].get('eval.images')
    ms = [s['device_ms'] for s in data['spans'] if s['name'] in PARTS] if images else []
    if not ms or None in ms:
        return None
    return sum(ms) / images
