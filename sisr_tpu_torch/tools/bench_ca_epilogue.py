"""The CA + residual tail, kernel against unfused, on the card (PyTorch port of
sisr_tpu's ``tools/bench_pallas_epilogue.py``).

The RCAB block tail of the int8 serving path — the requantised conv output x (f32),
the channel-attention scale and the residual add onto the carry r — runs as one CUDA
kernel (``fused_channel_attention_residual``, on the route ``ca_res_plan`` gives) or
as its plain version, the unfused PyTorch ops
(``reference_channel_attention_residual``).  This tool times both standalone, at
sisr_tpu's three shapes with the bf16 carry (and the f32 carry beside it), printing
the route, both times, the bound and the max abs error; then end to end, the int8
RCAN 10x20 forward at (8, 128, 128, 3) with ``ca_epilogue='kernel'`` (the main path)
against ``'plain'``, with the two outputs' max abs difference and PSNR against each
other (raw, and clipped to [0, 1] as eval reads them).  Beside it, the rounding
witnesses: the plain forward against itself with the tail's pool summed another way
(``WITNESS_POOLS``: in f64, rows reversed, over W then H), a change of rounding only.
The int8 chain carries such a difference on, since the next conv's requantisation may
round it to another int8 step, so these PSNRs say how far apart two correct tails
leave the output.  One JSON line per measurement.  Times: the median of 3 rounds of
``ITERS`` calls between CUDA events, after warm-up calls.

Run on the card:  python -m sisr_tpu_torch.tools.bench_ca_epilogue [--device cpu]
"""
import json
import sys

import numpy as np

ITERS = 30  # calls a round, standalone
E2E_ITERS = 10  # calls a round, end to end
ROUNDS, WARM = 3, 3
SHAPES = ((8, 32, 32, 64), (8, 128, 128, 64), (1, 256, 256, 64))
# the plain tail's pool summed other ways: each a rounding-only change of the tail
WITNESS_POOLS = {
    'f64': lambda x: x.double().mean(dim=(1, 2)).float(),
    'rows_reversed': lambda x: x.float().flip(1).mean(dim=(1, 2)),
    'w_then_h': lambda x: x.float().sum(2).sum(1) / (x.shape[1] * x.shape[2]),
}


def _timed_loop(fn, args, iters=None):
    """Median-of-``ROUNDS`` per-call seconds of ``fn(*args)``: ``iters`` (``ITERS``)
    calls between CUDA events (a host clock on the CPU), after ``WARM`` calls."""
    import statistics
    import time
    import torch
    iters, rounds, warm = iters or ITERS, ROUNDS, WARM
    device = args[0].device
    with torch.inference_mode():
        for _ in range(warm):
            fn(*args)
        samples = []
        for _ in range(rounds):
            if device.type == 'cuda':
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn(*args)
                stop.record()
                torch.cuda.synchronize(device)
                samples.append(start.elapsed_time(stop) / 1e3 / iters)
            else:
                tic = time.perf_counter()
                for _ in range(iters):
                    fn(*args)
                samples.append((time.perf_counter() - tic) / iters)
    return statistics.median(samples)


def _route(x, r, w1):
    """The route ``ca_res_plan`` gives these tensors on x's card ('plain' on the
    CPU)."""
    import torch
    from ..ops import channel_attention as ca
    if x.device.type != 'cuda':
        return 'plain'
    props = torch.cuda.get_device_properties(x.device)
    n, h, w, c = x.shape
    out = torch.empty_like(r)
    return ca.ca_res_plan(n, h * w, c, w1.shape[1], x.element_size(), r.element_size(),
                          ca.res_onchip_aligned(x, r, out), props.multi_processor_count,
                          props.shared_memory_per_block_optin)[0]


def _bound(x, r, w1):
    """The tail's bound in ms on x's card: one read of x and r, one write of out (r's
    type) and the excite's weights; the pool's add, the multiply and the add per element
    plus the excite (None on the CPU or an unknown card)."""
    from .flops import bound_ms
    if x.device.type != 'cuda':
        return None
    n, _, _, c = x.shape
    cr = w1.shape[1]
    bytes_moved = (x.numel() * x.element_size() + 2 * r.numel() * r.element_size()
                   + 4 * (2 * c * cr + c + cr))
    ops = 3 * x.numel() + n * (4 * c * cr + 2 * c)
    return bound_ms(bytes_moved, ops, x.device)


def _ulps(a, b):
    """max |a - b| in units of b's bf16 spacing."""
    import torch
    b = b.float()
    exponent = torch.floor(torch.log2(b.abs().clamp(min=2.0 ** -126)))
    return ((a.float() - b).abs() / torch.pow(2.0, exponent - 7)).max().item()


def bench_standalone(n=8, h=128, w=128, c=64, device=None, r_dtype='bfloat16'):
    """The epilogue chain alone: f32 conv output, a bf16 (or f32) carry."""
    import torch
    from ..ops.channel_attention import (fused_channel_attention_residual,
                                         reference_channel_attention_residual)
    from ..utils.helpers import resolve_device
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    dev = lambda a, dt=torch.float32: torch.as_tensor(a).to(device, dt)  # noqa: E731
    x = dev(rng.rand(n, h, w, c))
    w1 = dev(rng.randn(c, c // 16) * 0.1)
    b1 = dev(np.zeros(c // 16))
    w2 = dev(rng.randn(c // 16, c) * 0.1)
    b2 = dev(np.zeros(c))
    r0 = dev(rng.rand(n, h, w, c), getattr(torch, r_dtype))
    args = (x, r0, w1, b1, w2, b2)
    t_plain = _timed_loop(reference_channel_attention_residual, args)
    t_kern = _timed_loop(fused_channel_attention_residual, args)
    with torch.inference_mode():
        a = reference_channel_attention_residual(*args)
        b = fused_channel_attention_residual(*args)
    bound = _bound(x, r0, w1)
    result = {'bench': 'ca_res_epilogue_standalone', 'shape': [n, h, w, c],
              'r_dtype': r_dtype, 'route': _route(x, r0, w1),
              'plain_ms': round(t_plain * 1e3, 4), 'kernel_ms': round(t_kern * 1e3, 4),
              'speedup': round(t_plain / t_kern, 3),
              'bound_ms': None if bound is None else round(bound, 4),
              'max_abs_err': float((a.float() - b.float()).abs().max())}
    if r_dtype == 'bfloat16':
        result['max_ulps'] = _ulps(b, a)
    return result


def _plain_tail(pool):
    """The plain tail without meta or gate (``reference_channel_attention_residual``'s
    ops in its order) with its pool computed by ``pool``."""
    import torch

    def tail(x, r, w1, b1, w2, b2):
        with torch.autocast(x.device.type, enabled=False):
            hidden = torch.relu(pool(x) @ w1.float() + b1.float())
            att = torch.sigmoid(hidden @ w2.float() + b2.float())
        return (x.float() * att[:, None, None, :] + r.float()).to(r.dtype)
    return tail


def bench_e2e_int8_rcan(n=8, hw=128, n_resgroups=10, n_resblocks=20, device=None):
    """Full int8 RCAN forward at the eval shape, ``ca_epilogue`` 'kernel' against
    'plain': the handler's quantised weights and scales (calibrated on the batch, as
    the main path calibrates), both forwards timed, and the two outputs compared
    (``psnr_db`` of the images clipped to [0, 1], ``psnr_db_unclipped`` of the raw
    outputs); ``witness_psnr_db_unclipped``: the plain output against the plain
    forward with each of ``WITNESS_POOLS`` in its tail."""
    import torch
    from ..models.handlers import define_model
    from ..ops import quantization as qz
    handler = define_model('rcan', eval_mode=True, device=device, scale=4, n_feats=64,
                           n_resgroups=n_resgroups, n_resblocks=n_resblocks)
    handler._set_training(False)
    x = torch.from_numpy(np.random.RandomState(0).rand(n, hw, hw, 3).astype(np.float32))
    x = x.to(handler.device)
    handler._ensure_int8_ctx(x)
    _, qp, scales = handler._int8_ctx
    scales = qz.scales_on(scales, handler.device)
    results, outs = {}, {}
    for mode in ('plain', 'kernel'):
        def fwd(x_, mode=mode):
            return qz.rcan_int8_forward_static(qp, scales, x_, n_resgroups, n_resblocks,
                                               ca_epilogue=mode)
        results[mode] = _timed_loop(fwd, (x,), iters=E2E_ITERS)
        with torch.inference_mode():
            outs[mode] = fwd(x).float()
    witness, plain_tail = {}, qz.reference_channel_attention_residual
    for name, pool in WITNESS_POOLS.items():
        qz.reference_channel_attention_residual = _plain_tail(pool)
        try:
            with torch.inference_mode():
                out = qz.rcan_int8_forward_static(qp, scales, x, n_resgroups, n_resblocks,
                                                  ca_epilogue='plain').float()
        finally:
            qz.reference_channel_attention_residual = plain_tail
        witness[name] = _psnr(outs['plain'] - out)
    diff = outs['plain'] - outs['kernel']
    images = outs['plain'].clamp(0, 1) - outs['kernel'].clamp(0, 1)
    return {'bench': 'int8_rcan_e2e', 'shape': [n, hw, hw, 3],
            'layers': [n_resgroups, n_resblocks],
            'plain_ms': round(results['plain'] * 1e3, 3),
            'kernel_ms': round(results['kernel'] * 1e3, 3),
            'speedup': round(results['plain'] / results['kernel'], 3),
            'max_abs_err': float(diff.abs().max()),
            'psnr_db': _psnr(images), 'psnr_db_unclipped': _psnr(diff),
            'witness_psnr_db_unclipped': witness}


def _psnr(diff):
    """PSNR in dB of a difference at a peak of 1."""
    return 10 * float(np.log10(1.0 / max(float((diff ** 2).mean()), 1e-20)))


def main(argv=None, device=None):
    """Every measurement, each printed as one JSON line; returns them."""
    from .bench_models import _device_arg
    from ..utils.helpers import resolve_device
    arg_device, _ = _device_arg(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device or arg_device)
    out = []
    for shape in SHAPES:
        for r_dtype in ('bfloat16', 'float32'):
            out.append(bench_standalone(*shape, device=device, r_dtype=r_dtype))
            print(json.dumps(out[-1]), flush=True)
    out.append(bench_e2e_int8_rcan(device=device))
    print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == '__main__':
    main()
    sys.exit(0)
