"""Drive the PyTorch/CUDA port (sisr_tpu_torch) once on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. environment: the card (nvidia-smi), torch and CUDA versions, and the build of every
   CUDA kernel from the sources in this checkout;
2. kernel: each kernel against its plain PyTorch version on the card, at the main-path
   shape and at edge shapes, in bf16 and f32, with its time: ``ms`` per call replayed
   from a CUDA graph (device time with launch gaps, no host), ``host_ms`` per call
   back to back from Python, ``device_ms`` the profiler's sum of its kernels;
3. reference: the full-width RCAN forward and the fused eval on a small input, card
   (CUDA kernels) against the CPU (plain versions), in f32;
4. main path: ``eval_sisr --fused_eval`` (sisr_tpu_torch.net_eval) on RCAN 10x20, 64
   features, 4x, bf16, over 16 seeded synthetic 128^2 -> 512^2 PNG pairs; the kernel
   launch counts of that run; then the img/s of warm protocol passes and a device-time
   breakdown of one batch;

then the ``kernels`` table, the card's name and power limit, and a last line
``{"ok": true, "device": {...}}``.  TF32 is off for matmuls and cuDNN throughout, so
f32 comparisons are true f32.  It exits non-zero without a result when CUDA is absent
or when the sisr_tpu_torch package is not beside it.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_CUDA_CORE_FLOPS = 67e12  # float32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12

LR_SIZE, SCALE, N_IMAGES, BATCH = 128, 4, 16, 8
RCAN = {'scale': SCALE, 'n_resgroups': 10, 'n_resblocks': 20, 'n_feats': 64,
        'reduction': 16, 'dtype': 'bf16'}
CA_PER_FORWARD = RCAN['n_resgroups'] * RCAN['n_resblocks']
CA_KERNELS = ('ca_pool_partial', 'ca_excite', 'ca_scale')
# substrings of cuDNN / CUTLASS convolution and GEMM kernel names
CONV_KERNEL_HINTS = ('conv', 'xmma', 'gemm', 'cutlass', 'cudnn', 'fprop', 'implicit')


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=50, rounds=5):
    """Median over ``rounds`` of the CUDA-event time of ``reps`` back-to-back calls,
    per call, after a warm-up."""
    import torch
    for _ in range(5):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def graph_ms(fn, calls=20, rounds=5):
    """Per-call device time of ``fn`` with the host out of the way: ``calls`` calls
    captured in one CUDA graph, replays timed with CUDA events (median of
    ``rounds``)."""
    import torch
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
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def device_kernel_ms(fn, reps=20):
    """Per-call device time of ``fn``'s CUDA kernels from torch.profiler, and the
    per-kernel totals (ms over all calls); (None, {}) when the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for evt in prof.key_averages():
        us = getattr(evt, 'self_device_time_total', None)
        if us is None:
            us = getattr(evt, 'self_cuda_time_total', 0)
        if us:
            per_kernel[evt.key] = us / 1e3
    total = sum(per_kernel.values())
    return (total / reps if total else None), per_kernel


def write_workload(root, rng):
    """16 LR/HR PNG pairs: HR is smooth structure (sinusoids and a gradient) plus
    per-pixel noise, LR its PIL bicubic downscale."""
    import numpy as np
    from PIL import Image
    hr_size = LR_SIZE * SCALE
    lr_dir, hr_dir = os.path.join(root, 'lr'), os.path.join(root, 'hr')
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    yy, xx = np.mgrid[0:hr_size, 0:hr_size].astype(np.float32) / hr_size
    for i in range(N_IMAGES):
        fx, fy, phase = rng.uniform(2, 12), rng.uniform(2, 12), rng.uniform(0, 6.3, 3)
        chans = [0.5 + 0.35 * np.sin(2 * np.pi * (fx * xx + fy * yy) + phase[c])
                 * np.cos(2 * np.pi * fy * xx * (c + 1) / 3) + 0.15 * (xx - yy)
                 for c in range(3)]
        img = np.stack(chans, -1) * 255 + rng.normal(0, 12, (hr_size, hr_size, 3))
        hr = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
        name = 'im_%03d.png' % i
        hr.save(os.path.join(hr_dir, name))
        hr.resize((LR_SIZE, LR_SIZE), Image.BICUBIC).save(os.path.join(lr_dir, name))
    return lr_dir, hr_dir


def write_experiment(model_loc, name, seed):
    """A ready-to-evaluate RCAN experiment: config.toml + saved_models/train_model_0."""
    from sisr_tpu_torch.models.handlers import define_model
    from sisr_tpu_torch.utils import toml_io
    base = os.path.join(model_loc, name)
    os.makedirs(os.path.join(base, 'saved_models'))
    toml_io.dump({'model': {'name': 'rcan', 'internal_params': RCAN}},
                 os.path.join(base, 'config.toml'))
    define_model('rcan', device='cpu', seed=seed, **RCAN).save_model(
        'train_model', 0, os.path.join(base, 'saved_models'))


def phase_environment():
    import torch
    from sisr_tpu_torch.ops.cuda import build
    tic = time.perf_counter()
    built = build.build()
    emit({'phase': 'environment', 'nvidia_smi': nvidia_smi_line(),
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'python': sys.version.split()[0], 'nvcc': build.nvcc_path(),
          'nvcc_flags': ' '.join(build.NVCC_FLAGS),
          'build_seconds': round(time.perf_counter() - tic, 3),
          'libraries': {k: {'path': os.path.relpath(v['path']),
                            'nvcc_seconds': round(v['seconds'], 3)}
                        for k, v in built.items()}})
    for name, info in built.items():
        print('[%s ptxas]\n%s' % (name, info['log'].strip()), file=sys.stderr)


def ca_inputs(shape, dtype, reduction, gen):
    """x and the excite's weights, the weights as the main path passes them:
    transposed views of conv_du's (out, in) matrices."""
    import torch
    c = shape[-1]
    cr = c // reduction
    x = torch.rand(shape, generator=gen).to(dtype).cuda()
    w1 = (torch.randn(cr, c, generator=gen) * 0.1).cuda().t()
    b1 = (torch.randn(cr, generator=gen) * 0.1).cuda()
    w2 = (torch.randn(c, cr, generator=gen) * 0.1).cuda().t()
    b2 = (torch.randn(c, generator=gen) * 0.1).cuda()
    return x, w1, b1, w2, b2


def phase_kernel():
    """fused_channel_attention against reference_channel_attention.  Tolerances:
    f32 1e-5 abs (summation order only); bf16 2 bf16 ULPs of the output (rtol
    1.6e-2), since the summation order can flip how att rounds to bf16."""
    import torch
    from sisr_tpu_torch.ops.channel_attention import (fused_channel_attention,
                                                      launch_plan,
                                                      reference_channel_attention)
    gen = torch.Generator().manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [((BATCH, LR_SIZE, LR_SIZE, 64), 16), ((1, 13, 8, 32), 4),
              ((2, 16, 8, 32), 4), ((1, 512, 512, 64), 16),
              ((1, 7, 5, 20), 4), ((2, 9, 3, 18), 3)]
    checks = []
    with torch.inference_mode():
        for shape, reduction in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                args = ca_inputs(shape, dtype, reduction, gen)
                out = fused_channel_attention(*args)
                again = fused_channel_attention(*args)
                torch.cuda.synchronize()
                ref = reference_channel_attention(*args)
                err = (out.float() - ref.float()).abs().max().item()
                if dtype == torch.float32:
                    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
                else:
                    torch.testing.assert_close(out.float(), ref.float(), atol=1e-6,
                                               rtol=1.6e-2)
                if not torch.equal(out, again):
                    raise AssertionError('fused_channel_attention is not deterministic '
                                         'at %s %s' % (shape, dtype))
                vectorized, slabs = launch_plan(shape[0], shape[1] * shape[2], shape[3],
                                                args[0].element_size(), True, sms)
                checks.append({'shape': list(shape), 'dtype': str(dtype).split('.')[-1],
                               'max_abs_err': err, 'vectorized': vectorized,
                               'slabs_per_image': slabs})

        x, w1, b1, w2, b2 = ca_inputs((BATCH, LR_SIZE, LR_SIZE, 64), torch.bfloat16, 16,
                                      gen)
        kern = lambda: fused_channel_attention(x, w1, b1, w2, b2)
        plain = lambda: reference_channel_attention(x, w1, b1, w2, b2)
        err = (kern().float() - plain().float()).abs().max().item()
        # plain, kernel, kernel, plain: the second turn of each is reported
        timing = {'plain_ms': graph_ms(plain), 'ms': graph_ms(kern)}
        timing['ms'], timing['plain_ms'] = graph_ms(kern), graph_ms(plain)
        timing['host_ms'], timing['plain_host_ms'] = cuda_ms(kern), cuda_ms(plain)
        timing['device_ms'], kern_detail = device_kernel_ms(kern)
        timing['plain_device_ms'], _ = device_kernel_ms(plain)
    n, h, w, c = x.shape
    cr = w1.shape[1]
    bytes_moved = 2 * x.numel() * x.element_size() + 4 * (2 * c * cr + c + cr)
    ops = 2 * x.numel() + n * (4 * c * cr + 2 * c)
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_CUDA_CORE_FLOPS) * 1e3
    emit({'phase': 'kernel', 'name': 'fused_channel_attention', 'checks': checks,
          'main_shape': [n, h, w, c], 'dtype': 'bfloat16', 'max_abs_err': err,
          'bound_ms': bound_ms, 'bound_us': bound_ms * 1e3, 'bytes': bytes_moved, 'ops': ops,
          'device_kernels_ms_per_20_calls': kern_detail, **timing})
    return {'max_abs_err': err, 'bound_ms': bound_ms, **timing}


def phase_reference():
    """Full-width RCAN (seeded weights) on a 32^2 LR input in f32: the card (CUDA
    kernels, cuDNN) against the CPU (plain versions).  Forward <= 5e-4 abs; fused-eval
    PSNR within 0.01 dB and SSIM within 1e-3."""
    import numpy as np
    import torch
    from sisr_tpu_torch.models.handlers import define_model
    f32 = {**RCAN, 'dtype': 'f32'}
    card = define_model('rcan', device='cuda', seed=3, **f32)
    host = define_model('rcan', device='cpu', seed=3, **f32)
    rng = np.random.RandomState(5)
    lr = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    hr = rng.randint(0, 256, (2, 32 * SCALE, 32 * SCALE, 3)).astype(np.uint8)
    x = torch.from_numpy(lr).float() / 255.0
    with torch.inference_mode():
        out_card = card.forward(x.cuda()).cpu()
        out_host = host.forward(x)
    fwd_err = (out_card - out_host).abs().max().item()
    (keys, m_card), _ = card.run_eval_fused({'lr': lr, 'hr': hr})
    (_, m_host), _ = host.run_eval_fused({'lr': lr, 'hr': hr})
    m_card, m_host = m_card.cpu().numpy(), m_host.numpy()
    diff = {k: float(np.abs(m_card[i] - m_host[i]).max()) for i, k in enumerate(keys)}
    emit({'phase': 'reference', 'forward_max_abs_err': fwd_err, 'metric_max_abs_diff': diff,
          'output_shape': list(out_card.shape)})
    if not np.isfinite(out_card.numpy()).all() or fwd_err > 5e-4:
        raise AssertionError('RCAN forward on the card disagrees with the CPU: %g' % fwd_err)
    for i, k in enumerate(keys):
        bar = 0.01 if k.endswith('PSNR') else 1e-3
        if not diff[k] <= bar:
            raise AssertionError('fused eval %s on the card is %g from the CPU' % (k, diff[k]))


def phase_main_path(root):
    import numpy as np
    import pandas as pd
    import torch
    from sisr_tpu_torch import net_eval
    from sisr_tpu_torch.evaluation.standard_eval import EvalHub
    from sisr_tpu_torch.ops.channel_attention import fused_channel_attention
    lr_dir, hr_dir = write_workload(root, np.random.RandomState(0))
    model_loc = os.path.join(root, 'Results')
    write_experiment(model_loc, 'rcan_10x20', seed=8)
    out_loc = os.path.join(root, 'out')
    args = ['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'rcan_10x20', '0',
            '--model_loc', model_loc, '--out_loc', out_loc, '--results_name', 'smoke',
            '-m', 'PSNR', '-m', 'SSIM', '--scale', str(SCALE), '--batch_size', str(BATCH),
            '--full_directory', '--fused_eval', '--no_image_comparison',
            '--no-time_models']

    fused_channel_attention.launches = 0
    tic = time.perf_counter()
    net_eval.eval_run.main(args=args, standalone_mode=False)
    cli_seconds = time.perf_counter() - tic
    launches = {'fused_channel_attention': fused_channel_attention.launches}

    csv = os.path.join(out_loc, 'smoke', 'standard_metrics', 'individual_metrics.csv')
    frame = pd.read_csv(csv, header=[0, 1], index_col=0)
    vals = frame[[('rcan_10x20', 'PSNR'), ('rcan_10x20', 'SSIM'), ('LR', 'PSNR'),
                  ('LR', 'SSIM')]].to_numpy()
    n_batches = -(-N_IMAGES // BATCH)
    if len(frame) != N_IMAGES or not np.isfinite(vals).all():
        raise AssertionError('individual_metrics.csv: %d rows, finite=%s'
                             % (len(frame), np.isfinite(vals).all()))
    if launches['fused_channel_attention'] != CA_PER_FORWARD * n_batches:
        raise AssertionError('CA kernel launched %d times, expected %d x %d batches'
                             % (launches['fused_channel_attention'], CA_PER_FORWARD,
                                n_batches))

    # warm protocol passes on one hub: the first decodes and sets up, the rest are timed
    hub = EvalHub(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('rcan_10x20', '0')],
                  results_name='smoke_timed', gpu=True, metrics=['PSNR', 'SSIM'],
                  data_split=None, save_im=False, batch_size=BATCH, full_directory=True,
                  lr_dir_interp=None, model_only=False, scale=SCALE, model_loc=model_loc,
                  out_loc=out_loc, use_test_group=False, no_image_comparison=True,
                  num_image_save=0, qpi_selection=(None, None), data_attributes=None,
                  dataset_name=None, image_shortlist=None, metadata_file=None, sp_gpu=0,
                  time_models=False, recursive=False, fused_eval=True)
    hub.full_image_protocol()
    rates = []
    for _ in range(3):
        tic = time.perf_counter()
        hub.full_image_protocol()
        rates.append(N_IMAGES / (time.perf_counter() - tic))

    handler = hub.model_bundles[0].model
    rng = np.random.RandomState(1)
    batch = {'lr': rng.randint(0, 256, (BATCH, LR_SIZE, LR_SIZE, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (BATCH, LR_SIZE * SCALE, LR_SIZE * SCALE, 3))
             .astype(np.uint8)}
    dev = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    step = lambda: handler.run_eval_fused(dev)[0][1]
    x = dev['lr'].float() / 255.0
    conv_flops = count_conv_flops(handler, x)
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: handler.forward(x), reps=5, rounds=3)
    step_ms = cuda_ms(step, reps=5, rounds=3)
    step_device_ms, per_kernel = device_kernel_ms(step, reps=3)
    per_kernel = {k: v / 3 for k, v in per_kernel.items()}
    ca_ms = sum(v for k, v in per_kernel.items() if any(n in k for n in CA_KERNELS))
    conv_ms = sum(v for k, v in per_kernel.items() if not any(n in k for n in CA_KERNELS)
                  and any(t in k.lower() for t in CONV_KERNEL_HINTS))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    emit({'phase': 'main_path', 'model': 'rcan 10x20 64f 4x bf16', 'images': N_IMAGES,
          'batch': BATCH, 'lr': LR_SIZE, 'cli_seconds': cli_seconds, 'launches': launches,
          'mean_psnr': float(frame[('rcan_10x20', 'PSNR')].mean()),
          'mean_lr_psnr': float(frame[('LR', 'PSNR')].mean()),
          'img_per_s_warm_passes': rates, 'img_per_s': statistics.median(rates),
          'nvidia_smi': nvidia_smi_line()})
    emit({'phase': 'breakdown', 'batch': BATCH, 'forward_ms': forward_ms,
          'forward_conv_gflop': conv_flops / 1e9,
          'forward_bf16_bound_ms': conv_flops / BF16_TENSOR_FLOPS * 1e3,
          'fused_step_ms': step_ms, 'fused_step_device_ms': step_device_ms,
          'ca_device_ms': ca_ms, 'conv_device_ms': conv_ms,
          'device_idle_share': (1 - step_device_ms / step_ms) if step_device_ms else None,
          'top_kernels_ms': top, 'nvidia_smi': nvidia_smi_line()})
    return launches


def count_conv_flops(handler, x):
    """Multiply-add FLOPs of every Conv2d the forward runs, from forward hooks."""
    import torch
    total = [0]

    def hook(mod, inp, out):
        total[0] += 2 * out.numel() * mod.in_channels // mod.groups \
            * mod.kernel_size[0] * mod.kernel_size[1]

    hooks = [m.register_forward_hook(hook) for m in handler.module.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            handler.forward(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False: nothing to run.',
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, 'sisr_tpu_torch')):
        print('chip_smoke: the sisr_tpu_torch package is not beside this script.',
              file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_environment()
    kernel = phase_kernel()
    phase_reference()
    root = tempfile.mkdtemp(prefix='sisr_chip_smoke_')
    try:
        launches = phase_main_path(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({'kernels': [{
        'name': 'fused_channel_attention', 'route': 'cuda',
        'source': 'sisr_tpu_torch/ops/cuda/csrc/channel_attention.cu',
        'replaces': 'sisr_tpu/ops/pallas/channel_attention.py:104',
        'launches': launches['fused_channel_attention'],
        'max_abs_err': kernel['max_abs_err'], 'ms': kernel['ms'],
        'plain_ms': kernel['plain_ms'], 'bound_ms': kernel['bound_ms'],
        'bound_by': 'bytes', 'library_ms': None,
        'host_ms': kernel['host_ms'], 'device_ms': kernel['device_ms'],
        'plain_device_ms': kernel['plain_device_ms']}]})
    print(nvidia_smi_line())
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
