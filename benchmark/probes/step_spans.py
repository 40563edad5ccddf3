"""Host-clock spans of the fused protocol's calls into the program's eval step
(``BaseHandler.run_eval_fused``), each timed to its completion on the card: the time
of the hub's pass spent outside them is the protocol's own."""
import time


class StepSpans:
    def __init__(self, job):
        self.job = job
        self.handler = job.handler
        self.spans = []
        inner = self.handler.run_eval_fused

        def timed(*args, **kwargs):
            tic = time.perf_counter()
            out = inner(*args, **kwargs)
            job.synchronize()
            self.spans.append(time.perf_counter() - tic)
            return out

        self.handler.run_eval_fused = timed
        self._inner = inner

    def remove(self):
        self.handler.run_eval_fused = self._inner

    def data(self):
        return {'seconds': list(self.spans)}


def install(job):
    return StepSpans(job) if job.kind == 'eval' else None
