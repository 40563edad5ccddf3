"""What every job shares: its inputs, the window (whole units of work, passes or
epochs, until ``--seconds`` have passed, ending at a synchronise), the traced stretch,
and the experiment folder the program loads."""
import importlib
import os
import sys
import time

import torch


def load(kind):
    """The job class of a traffic mix's ``job``."""
    return importlib.import_module('benchmark.jobs.' + kind).Job


def reference_module(config):
    return importlib.import_module('benchmark.reference.' + config['reference'])


def write_experiment(work, model_name, internal, weights):
    """An experiment folder as ``train_sisr`` leaves it, holding the benchmark's
    weights as epoch 0: ``<work>/Results/bench/{config.toml, saved_models/
    train_model_0}``.  Returns the folder of experiments."""
    from sisr_tpu_torch.utils import toml_io
    base = os.path.join(work, 'Results', 'bench')
    os.makedirs(os.path.join(base, 'saved_models'))
    with open(os.path.join(base, 'config.toml'), 'w') as f:
        toml_io.dump({'model': {'name': model_name, 'internal_params': internal}}, f)
    network = {k: v.detach().cpu() for k, v in weights.items()}
    torch.save({'network': network, 'model_name': model_name, 'model_epoch': 0,
                'step': 0}, os.path.join(base, 'saved_models', 'train_model_0'))
    return os.path.join(work, 'Results')


class Job:
    kind = None
    int8 = False

    def __init__(self, config, traffic, seed, device, work):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.cuda = self.device.type == 'cuda'
        self.work = work
        self._born = time.perf_counter()

    def mark(self, phase):
        """Log the set-up phase just done, with the seconds since the job began."""
        print('setup %s done at %.3f s' % (phase, time.perf_counter() - self._born),
              file=sys.stderr, flush=True)

    def synchronize(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def run_units(self, seconds=None, units=None):
        """Whole units back to back until ``seconds`` have passed (or ``units`` are
        done), from and to a synchronise: (work done, seconds)."""
        self.synchronize()
        tic = time.perf_counter()
        done, marks = 0, [tic]
        while True:
            self.unit()
            done += 1
            self.synchronize()
            marks.append(time.perf_counter())
            elapsed = marks[-1] - tic
            if (seconds is not None and elapsed >= seconds) or done == units:
                print('unit seconds %s' % ' '.join('%.4f' % (b - a) for a, b in
                                                   zip(marks, marks[1:])),
                      file=sys.stderr, flush=True)
                return done * self.work_per_unit, elapsed

    def window(self, seconds):
        return self.run_units(seconds=seconds)

    def stretch(self):
        return self.run_units(units=self.stretch_units())

    def counters(self):
        return {}
