"""Phase timeline of the CA + residual tail's rounds kernel (``ca_rounds``) on a card.

    python -m sisr_tpu_torch.tools.ca_res_timeline [--batch 8] [--size 128] [--runs 7]

Builds ``ops/cuda/csrc/channel_attention.cu`` with ``-DSISR_CA_RES_TIMELINE`` (a
library of its own), in which thread 0 of every block of ``ca_rounds`` takes the
GPU's global timer at kernel entry and, in each round, once its slab is pooled, past
the grid barrier, after the excite and after the scale.  Runs
``fused_channel_attention_residual`` through that library on seeded x (float32) and
r (bfloat16), checks it against the plain version, and prints one JSON object: for
each stamp the minimum, median and maximum over blocks of its time in microseconds
after the earliest block's entry (each block's median over ``--runs`` launches), the
plan, and the card's name and power limit.  Needs a CUDA card; the stamps are
one-shot launches after a synchronise, not back-to-back graph replays.
"""
import argparse
import ctypes
import json
import subprocess
import sys
import warnings

import numpy as np
import torch

from ..ops import channel_attention as ca
from ..ops.cuda import build

DEFINE = 'SISR_CA_RES_TIMELINE'
STAMP_ROUNDS = 3  # kResStampRounds in channel_attention.cu
STAMP_BLOCKS = 1024  # kResStampBlocks
STAMPS = 1 + 4 * STAMP_ROUNDS  # kResStamps
PHASES = ('pooled', 'past_barrier', 'excited', 'scaled')


def stamp_names(rounds):
    """The names of the stamps a launch of ``rounds`` rounds records, in order."""
    return ['entry'] + ['round%d_%s' % (k, phase) for k in range(min(rounds, STAMP_ROUNDS))
                        for phase in PHASES]


def timeline(stamps, blocks, rounds):
    """{stamp: [min, median, max] over blocks} in microseconds after each launch's
    earliest entry, each block's value its median over launches.  ``stamps`` is
    (launches, STAMP_BLOCKS, STAMPS) of nanoseconds; a stamp older than its launch's
    entry is stale (a block with no image in that round) and is left out."""
    names = stamp_names(rounds)
    ns = stamps[:, :blocks, :len(names)].astype(np.float64)
    rel = (ns - ns[:, :, :1].min(axis=1, keepdims=True)) / 1e3
    rel[rel < 0] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)  # a block stale in every launch
        per_block = np.nanmedian(rel, axis=0)
    return {name: [float(np.nanmin(col)), float(np.nanmedian(col)), float(np.nanmax(col))]
            for name, col in zip(names, per_block.T)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--batch', type=int, default=8)
    parser.add_argument('--size', type=int, default=128, help='H = W of the map')
    parser.add_argument('--channels', type=int, default=64)
    parser.add_argument('--reduction', type=int, default=16)
    parser.add_argument('--runs', type=int, default=7)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('ca_res_timeline: needs a CUDA card', file=sys.stderr)
        return 1
    props = torch.cuda.get_device_properties(0)
    lib = build.load('channel_attention', ca._SIGNATURES, defines=(DEFINE,))
    lib.sisr_ca_res_stamps.restype = ctypes.c_int
    lib.sisr_ca_res_stamps.argtypes = [ctypes.c_void_p]
    # the wrapper launches through the instrumented library on device 0
    ca._DEVICES[0] = (lib, props.multi_processor_count, props.shared_memory_per_block_optin)

    rng = np.random.RandomState(args.seed)
    n, hw, c = args.batch, args.size * args.size, args.channels
    cr = c // args.reduction
    shape = (n, args.size, args.size, c)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
    r = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(torch.bfloat16).cuda()
    w1, w2 = (torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1).cuda().t()
              for s in ((cr, c), (c, cr)))  # conv_du's layout, as the int8 path passes it
    b1, b2 = (torch.from_numpy(rng.randn(k).astype(np.float32) * 0.1).cuda() for k in (cr, c))
    plan = ca.res_onchip_plan(n, hw, c, cr, 4, 2, True, props.multi_processor_count,
                              props.shared_memory_per_block_optin)
    if plan is None:
        print('ca_res_timeline: %s does not take the on-chip path' % (shape,), file=sys.stderr)
        return 1
    rounds, images, blocks = plan[:3]
    stamps = np.zeros((args.runs, STAMP_BLOCKS, STAMPS), np.uint64)
    with torch.inference_mode():
        ref = ca.reference_channel_attention_residual(x, r, w1, b1, w2, b2).float()
        for _ in range(3):
            out = ca.fused_channel_attention_residual(x, r, w1, b1, w2, b2)
        torch.testing.assert_close(out.float(), ref, atol=1e-6, rtol=1.6e-2)
        for run in range(args.runs):
            ca.fused_channel_attention_residual(x, r, w1, b1, w2, b2)
            torch.cuda.synchronize()
            build.check(lib, lib.sisr_ca_res_stamps(stamps[run].ctypes.data),
                        'reading the stamps')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True)
    print(json.dumps({
        'shape': list(shape), 'x_dtype': 'float32', 'r_dtype': 'bfloat16',
        'plan': dict(zip(('rounds', 'images_per_round', 'blocks_per_image', 'slab_pixels',
                          'smem_bytes'), plan)),
        'runs': args.runs, 'us_after_entry_min_median_max':
            timeline(stamps, images * blocks, rounds),
        'nvidia_smi': smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
