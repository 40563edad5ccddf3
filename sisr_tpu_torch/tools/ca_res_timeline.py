"""Phase timeline of the CA + residual tail's cooperative kernels on a card.

    python -m sisr_tpu_torch.tools.ca_res_timeline [--batch 8] [--size 128] [--runs 7]
    python -m sisr_tpu_torch.tools.ca_res_timeline --route stream [--ca] [--variants]

Builds ``ops/cuda/csrc/channel_attention.cu`` with ``-DSISR_CA_RES_TIMELINE`` (a
library of its own), in which thread 0 of every block takes the GPU's global timer at
kernel entry and then at each phase of the route: in ``ca_rounds`` (``--route
rounds``, the default, at (8, 128, 128, 64)), in each round, once its slab is
pooled, past the grid barrier, after the excite and after the scale; in ``ca_stream``
(``--route stream``, at a DIV2K validation image's map (1, 339, 510, 64)), in each
of the first two rounds, once the slab's head is pooled, once its tail is pooled (the
block's sum written), past the barrier, after the excite, after the tail's scale and
after the head's.  Runs ``fused_channel_attention_residual`` (``--ca``:
``fused_channel_attention``, with no r) through that library on seeded x (float32)
and r (bfloat16), checks the route and the output against the plain version, and
prints one JSON object: for each stamp the minimum, median and maximum over blocks of
its time in microseconds after the earliest block's entry (each block's median over
``--runs`` launches), the plan, and the card's name and power limit.  Needs a CUDA
card; the stamps are one-shot launches after a synchronise, not back-to-back graph
replays.

``--variants`` (the stream route) also builds, without the stamps, the product library
and one library for each of VARIANTS (ca_stream with another ring, another count of
loads from L2 at once or the head scaled first), all nvcc runs at once, and times
each against the product in turns (product, variant, variant, product; the second
turn of each kept), in ms a call replayed from a CUDA graph, each output held against
the plain version and compared bit for bit with the product's.
"""
import argparse
import concurrent.futures
import ctypes
import json
import statistics
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
DIV2K_LR = (339, 510)  # (H, W) of the stream route's map: a DIV2K validation image's LR
# each route's stamps a round after the entry's (ca_rounds, ca_stream), and the rounds
# the stamps hold
PHASES = {'rounds': ('pooled', 'past_barrier', 'excited', 'scaled'),
          'stream': ('head_pooled', 'tail_pooled', 'past_barrier', 'excited', 'tail_scaled',
                     'head_scaled')}
ROUNDS_STAMPED = {route: (STAMPS - 1) // len(p) for route, p in PHASES.items()}
# ca_stream's builds timed against the product's: (name, defines, the ring's slots)
PRODUCT_SLOTS = ca._STREAM_SLOTS
VARIANTS = (('slots_4', ('SISR_CA_STREAM_SLOTS=4',), 4),
            ('loads_16', ('SISR_CA_STREAM_LOADS=16',), PRODUCT_SLOTS),
            ('head_first', ('SISR_CA_STREAM_HEAD_FIRST',), PRODUCT_SLOTS))


def stamp_names(rounds, route='rounds'):
    """The names of the stamps a launch of ``rounds`` rounds of ``route`` records, in
    order."""
    return ['entry'] + ['round%d_%s' % (k, phase)
                        for k in range(min(rounds, ROUNDS_STAMPED[route]))
                        for phase in PHASES[route]]


def timeline(stamps, blocks, rounds, route='rounds'):
    """{stamp: [min, median, max] over blocks} in microseconds after each launch's
    earliest entry, each block's value its median over launches.  ``stamps`` is
    (launches, STAMP_BLOCKS, STAMPS) of nanoseconds; a stamp older than its launch's
    entry is stale (a block with no image in that round) and is left out."""
    names = stamp_names(rounds, route)
    ns = stamps[:, :blocks, :len(names)].astype(np.float64)
    rel = (ns - ns[:, :, :1].min(axis=1, keepdims=True)) / 1e3
    rel[rel < 0] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)  # a block stale in every launch
        per_block = np.nanmedian(rel, axis=0)
    return {name: [float(np.nanmin(col)), float(np.nanmedian(col)), float(np.nanmax(col))]
            for name, col in zip(names, per_block.T)}


def graph_ms(fn, calls=20, rounds=5):
    """ms a call of ``fn``: ``calls`` calls captured in one CUDA graph, replays timed
    with CUDA events (median of ``rounds``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def time_variants(call, check, device):
    """{variant: {'ms', 'product_ms', 'same_bits'}}: each of VARIANTS against the product
    build in turns, ``call`` launching through ``ca._DEVICES[0]`` = (library,
    ``*device``) and ``check`` holding an output against the plain version."""
    sets = [()] + [defines for _, defines, _ in VARIANTS]
    with concurrent.futures.ThreadPoolExecutor(len(sets)) as pool:
        list(pool.map(lambda d: build.build(['channel_attention'], d), sets))
    libs = [build.load('channel_attention', ca._SIGNATURES, defines=d) for d in sets]

    def use(lib, slots):
        ca._DEVICES[0] = (lib,) + device
        ca._STREAM_SLOTS = slots

    results = {}
    try:
        use(libs[0], PRODUCT_SLOTS)
        product_out = call()
        for (name, _, slots), lib in zip(VARIANTS, libs[1:]):
            use(lib, slots)
            out = call()
            check(out)
            timing = {}
            for key, lib_, slots_ in (('product_ms', libs[0], PRODUCT_SLOTS),
                                      ('ms', lib, slots), ('ms', lib, slots),
                                      ('product_ms', libs[0], PRODUCT_SLOTS)):
                use(lib_, slots_)
                timing[key] = graph_ms(call)  # the second turn of each is kept
            results[name] = {**timing, 'same_bits': bool(torch.equal(out, product_out))}
    finally:
        use(libs[0], PRODUCT_SLOTS)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--route', choices=sorted(PHASES), default='rounds')
    parser.add_argument('--ca', action='store_true',
                        help='the CA op (no r) instead of the CA + residual tail')
    parser.add_argument('--batch', type=int, default=None,
                        help='images (default 8 for rounds, 1 for stream)')
    parser.add_argument('--size', type=int, default=128, help='H = W of a rounds map')
    parser.add_argument('--channels', type=int, default=64)
    parser.add_argument('--reduction', type=int, default=16)
    parser.add_argument('--runs', type=int, default=7)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--variants', action='store_true',
                        help='time the stream route against VARIANTS (with --route stream)')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('ca_res_timeline: needs a CUDA card', file=sys.stderr)
        return 1
    stream = args.route == 'stream'
    n = args.batch or (1 if stream else 8)
    height, width = DIV2K_LR if stream else (args.size, args.size)
    if args.variants and not stream:
        print('ca_res_timeline: --variants times the stream route only', file=sys.stderr)
        return 1
    props = torch.cuda.get_device_properties(0)
    lib = build.load('channel_attention', ca._SIGNATURES, defines=(DEFINE,))
    lib.sisr_ca_res_stamps.restype = ctypes.c_int
    lib.sisr_ca_res_stamps.argtypes = [ctypes.c_void_p]
    # the wrapper launches through the instrumented library on device 0
    ca._DEVICES[0] = (lib, props.multi_processor_count, props.shared_memory_per_block_optin)

    rng = np.random.RandomState(args.seed)
    c = args.channels
    hw, cr = height * width, c // args.reduction
    shape = (n, height, width, c)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
    r = None if args.ca else torch.from_numpy(
        rng.rand(*shape).astype(np.float32)).to(torch.bfloat16).cuda()
    w1, w2 = (torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1).cuda().t()
              for s in ((cr, c), (c, cr)))  # conv_du's layout, as the int8 path passes it
    b1, b2 = (torch.from_numpy(rng.randn(k).astype(np.float32) * 0.1).cuda() for k in (cr, c))
    smem = props.multi_processor_count, props.shared_memory_per_block_optin
    if args.ca:
        route, plan = ca.ca_plan(n, hw, c, cr, 4, True, *smem)
        op, counter = ca.fused_channel_attention, {'rounds': 'rounds_launches'}
        call = lambda: op(x, w1, b1, w2, b2)
        plain = lambda: ca.reference_channel_attention(x, w1, b1, w2, b2)
    else:
        route, plan = ca.ca_res_plan(n, hw, c, cr, 4, 2, True, *smem)
        op, counter = ca.fused_channel_attention_residual, {'rounds': 'onchip_launches'}
        call = lambda: op(x, r, w1, b1, w2, b2)
        plain = lambda: ca.reference_channel_attention_residual(x, r, w1, b1, w2, b2)
    if route != args.route:
        print('ca_res_timeline: %s takes the %s route, not %s' % (shape, route, args.route),
              file=sys.stderr)
        return 1
    counter = counter.get(route, 'stream_launches')
    rounds, blocks = plan[0], (plan[1] * plan[2] if route == 'rounds' else plan[1])
    stamps = np.zeros((args.runs, STAMP_BLOCKS, STAMPS), np.uint64)
    with torch.inference_mode():
        ref = plain().float()
        check = lambda out: torch.testing.assert_close(
            out.float(), ref, atol=1e-5 if args.ca else 1e-6, rtol=0 if args.ca else 1.6e-2)
        for _ in range(3):
            out = call()
        check(out)
        launched = getattr(op, counter)
        for run in range(args.runs):
            call()
            torch.cuda.synchronize()
            build.check(lib, lib.sisr_ca_res_stamps(stamps[run].ctypes.data),
                        'reading the stamps')
        if getattr(op, counter) != launched + args.runs:
            raise AssertionError('the timed launches did not take the %s route' % route)
        variants = time_variants(call, check, smem) if args.variants else None
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True)
    keys = (('rounds', 'images_per_round', 'blocks_per_image', 'slab_pixels', 'smem_bytes')
            if route == 'rounds' else
            ('rounds', 'blocks_per_image', 'slab_pixels', 'head_pixels', 'smem_bytes'))
    print(json.dumps({
        'route': route, 'op': op.__name__, 'shape': list(shape), 'x_dtype': 'float32',
        'r_dtype': None if args.ca else 'bfloat16', 'plan': dict(zip(keys, plan)),
        'runs': args.runs, 'us_after_entry_min_median_max':
            timeline(stamps, blocks, rounds, route), 'variants': variants,
        'nvidia_smi': smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
