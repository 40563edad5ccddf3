"""Bucketed-eval payoff measurement on the card (PyTorch port of sisr_tpu's
``tools/bench_bucketed.py``).

A mixed-size eval set runs the forward at one input shape per image size on the
standard path; ``--eval_buckets N`` pads shapes up to the bucket grid and runs the
mask-exact padded forward (``BaseHandler.set_eval_buckets``), one shape per BUCKET.
This tool measures both on 20 images of 10 shapes (EDSR 32f/8b, bf16, batch 1):
the cold run (each shape's first calls included: cuDNN's choice of algorithm per
shape), the warm run, and the number of distinct forward input shapes (sisr_tpu
counts XLA programs, one per shape).  Each run ends in ``torch.cuda.synchronize()``
(``run_eval`` copies every output to the host).

Run: ``python -m sisr_tpu_torch.tools.bench_bucketed [--device cpu]``
"""
import argparse
import time

import numpy as np


N_IMAGES = 20
SHAPES = [(96 + 8 * i, 120 + 8 * ((i * 3) % 7)) for i in range(10)]  # 10 distinct
EDSR_SMALL = {'scale': 4, 'num_features': 32, 'num_blocks': 8, 'dtype': 'bf16'}


def _run_set(handler, images):
    outs = []
    for im in images:
        out, _, _ = handler.run_eval(im[None])
        outs.append(np.asarray(out))
    return outs


def main(argv=None):
    """Prints each arm's line and the cold-run speedup; returns
    {label: (cold s, warm s, forward input shapes)}."""
    from ..models.handlers import define_model
    from ..utils.helpers import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default=None, help='cuda (default), cuda:N or cpu')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.RandomState(0)
    images = [rng.rand(*SHAPES[i % len(SHAPES)], 3).astype(np.float32)
              for i in range(N_IMAGES)]

    results = {}
    for label, buckets in (('per-shape (no buckets)', None), ('buckets=32', 32)):
        handler = define_model('edsr', eval_mode=True, device=device, **EDSR_SMALL)
        if buckets:
            handler.set_eval_buckets(buckets)
        shapes = set()
        hook = handler.module.register_forward_pre_hook(
            lambda mod, inp: shapes.add(tuple(inp[0].shape)))
        try:
            t0 = time.perf_counter()
            _run_set(handler, images)
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            _run_set(handler, images)
            warm = time.perf_counter() - t0
        finally:
            hook.remove()
        results[label] = (cold, warm, len(shapes))
        print('%-24s cold %6.1f s | warm %6.2f s | %2d forward shapes (%d images, '
              '%d shapes)' % (label, cold, warm, len(shapes), N_IMAGES, len(SHAPES)))

    (cold_a, _, prog_a), (cold_b, _, prog_b) = results.values()
    print('bucketed cold-run speedup: %.2fx (%d -> %d forward shapes)'
          % (cold_a / cold_b, prog_a, prog_b))
    return results


if __name__ == '__main__':
    main()
