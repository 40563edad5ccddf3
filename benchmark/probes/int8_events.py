"""CUDA events around every call of the program's calibrated int8 program (the
function the fused step calls in place of the module), with its batch."""
import torch


class Int8Events:
    def __init__(self, job):
        self.handler = job.handler
        self.calls = []
        self._ctx = self.handler._int8_ctx
        program = self._ctx[0]

        def timed(x, meta=None):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            out = program(x, meta)
            end.record()
            self.calls.append((start, end, x.shape[0]))
            return out

        self.handler._int8_ctx = (timed,) + tuple(self._ctx[1:])

    def remove(self):
        self.handler._int8_ctx = self._ctx

    def data(self):
        torch.cuda.synchronize()
        return [{'ms': s.elapsed_time(e), 'images': n} for s, e, n in self.calls]


def install(job):
    if job.kind != 'eval' or not job.cuda or not job.int8 or job.handler._int8_ctx is None:
        return None
    return Int8Events(job)
