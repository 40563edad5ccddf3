"""CUDA events around every channel-attention layer call (the modules named CALayer
or QCALayer, whatever computes them), with the shape and item size of the map."""
from benchmark.probes._events import ModuleEvents


def _describe(module, args):
    x = args[0]
    return {'shape': tuple(x.shape), 'itemsize': x.element_size(),
            'gate': len(args) > 2 and args[2] is not None}


def install(job):
    if job.kind != 'eval' or not job.cuda or job.int8:
        return None
    layers = [m for m in job.handler.module.modules()
              if type(m).__name__ in ('CALayer', 'QCALayer')]
    return ModuleEvents(layers, _describe) if layers else None
