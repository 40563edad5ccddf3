"""Host-clock waits of the training loop for its next batch: the epoch's iterator over
the loader (``TrainingHandler._stream``) timed at each ``next``."""
import time


class LoaderWait:
    def __init__(self, job):
        self.trainer = job.trainer
        self.waits = []
        inner = self.trainer._stream

        def stream(*args, **kwargs):
            batches = iter(inner(*args, **kwargs))
            while True:
                tic = time.perf_counter()
                try:
                    batch = next(batches)
                except StopIteration:
                    self.waits.append(time.perf_counter() - tic)
                    return
                self.waits.append(time.perf_counter() - tic)
                yield batch

        self.trainer._stream = stream
        self._inner = inner

    def remove(self):
        self.trainer._stream = self._inner

    def data(self):
        return {'seconds': list(self.waits)}


def install(job):
    return LoaderWait(job) if job.kind == 'train' else None
