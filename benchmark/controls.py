"""The controls of the cells' comparisons: what a later change might be tempted to
put in the program's place, one precision below the configuration's, which the
limits have to call not correct.  A cell's checks file names its control:

* ``{"traffic": {...}}``: the program itself with the mix's keys changed, where the
  program has such a path of its own (its int8 path for a bf16 eval cell; bf16
  autocast for a float32 training cell);
* ``{"reference_bits": b}``: the plain reference in b-bit integer arithmetic
  (``reference/quant.py``) judged in the program's place (4 bits for an int8 cell);
* ``{"reference_fp8": true}``: the plain reference in float8 e4m3 (``reference/quant.py``:
  conv inputs, weights and the residual carry) judged in the program's place (the
  control of a bfloat16 cell).
"""
import copy

import torch

from benchmark.reference.common import no_tf32
from benchmark.reference.quant import Quantized, conv_e4m3, round_e4m3


def apply(control, traffic, config):
    """(traffic, config, judged) of the run of ``control``."""
    traffic, config = copy.deepcopy(traffic), copy.deepcopy(config)
    traffic.update(control.get('traffic', {}))
    judged = None
    if 'reference_bits' in control:
        judged = reference_bits(int(control['reference_bits']))
    if control.get('reference_fp8'):
        judged = reference_fp8()
    return traffic, config, judged


def reference_bits(bits):
    """The reference in ``bits``-bit arithmetic, calibrated on the first block of the
    sampled images, as the judged outputs of an eval job."""
    def judged(job, sample):
        quant = Quantized(bits)
        block = int(job.traffic['check_block'])
        with no_tf32(), torch.no_grad():
            x, meta = job.inputs(sample[:block])
            job.ref.forward(job.weights, x, meta, job.config['sizes'], conv=quant.calibrate)
        sr = job.reference_outputs(sample, conv=quant.conv)
        return sr, job.reference_rows(sample, sr)
    return judged


def reference_fp8():
    """The reference in float8 e4m3, as the judged outputs of an eval job."""
    def judged(job, sample):
        sr = job.reference_outputs(sample, conv=conv_e4m3, carry=round_e4m3)
        return sr, job.reference_rows(sample, sr)
    return judged
