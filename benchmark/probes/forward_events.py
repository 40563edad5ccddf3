"""CUDA events around every call of the program's top module (the model forward), with
the batch it was given."""
from benchmark.probes._events import ModuleEvents


def install(job):
    if job.kind != 'eval' or not job.cuda or job.int8:
        return None
    return ModuleEvents([job.handler.module], lambda m, args: {'images': args[0].shape[0]})
