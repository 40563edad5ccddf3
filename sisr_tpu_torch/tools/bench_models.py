"""Per-family serving-throughput table on the card (PyTorch port of sisr_tpu's
``tools/bench_models.py``: the same families, sizes, flags and table layouts).

Runs each model family at its reference default size on the headline serving
workload (4x SR, 128->512 — interp-input models consume the pre-upscaled 512 input)
in bfloat16 and prints img/s.  Each family is built through ``define_model`` and
timed through its handler's forward (the bf16 autocast, channels_last and the CA
kernel's routes of the main path), ``ITERS`` calls after ``WARM`` warm-up calls,
with CUDA events.  A family that fails prints a ``FAILED`` row, the table goes on,
and the tool exits non-zero.

Run: ``python -m sisr_tpu_torch.tools.bench_models [family ...] [--device cpu]``
(default: every family; e.g. ``... bench_models edsr rcan qrcan``).

``--e2e``: instead of forward-only loops, measure the BASELINE benchmark configs
#1-#5 (srcnn/edsr/qrcan/san/sparnet — see tools/e2e_bench.py) through the product
eval protocol, in img/s; its timed passes reuse the batches the warm-up pass decoded
and uploaded (the forward, YCbCr, PSNR/SSIM and the CSV; no PNG decode):
``python -m sisr_tpu_torch.tools.bench_models --e2e [config ...]``.

``--train``: end-to-end training-epoch throughput (decode + crops + copies ahead +
forward/backward/Adam) for EDSR 64f/16b; ``--fused-dispatch`` is taken for
sisr_tpu's flag (every step is its own dispatch here), ``--cache`` keeps the decoded
images, ``--vs-torch`` adds the plain-torch train-step baseline on the same device.

``--val``: the validation epoch, standard against fused_val.

``--paper``: PAPER-scale (flagship) forward benchmarks with MFU — EDSR at the SPL
recipe size (256f/32b) and RCAN/QRCAN at the SPL 10x20x64 config, bf16 + int8
(``--no-int8`` to skip the quantized rows).  MFU is over the card's dense bf16 peak
(``tools/flops.peak_flops``: ``BENCH_PEAK_TFLOPS``, else the card's data-sheet
figure).
"""
import sys

BATCH, ITERS, LR = 16, 10, 128
WARM = 3  # untimed calls before the timed ones (cuDNN's choice per shape)
PAPER_ITERS = 5  # timed calls of each --paper row


def _ca_counts():
    """The CA and CA + residual kernels' launch counters, as a dict."""
    from ..ops import channel_attention as ca
    op, res = ca.fused_channel_attention, ca.fused_channel_attention_residual
    return {'ca': op.launches, 'ca_onchip': op.onchip_launches,
            'ca_rounds': op.rounds_launches, 'ca_stream': op.stream_launches,
            'ca_res': res.launches, 'ca_res_rounds': res.onchip_launches,
            'ca_res_stream': res.stream_launches}


def timed(fn, x, iters=None, warm=WARM):
    """img/s of ``fn(x)`` on x's batch: ``iters`` back-to-back calls (``ITERS`` by
    default) between two CUDA events (a host clock to a synchronise on the CPU),
    after ``warm`` calls.  Returns (img/s, calls made, the CA counters' increase over
    those calls)."""
    import time
    import torch
    iters = ITERS if iters is None else iters
    before = _ca_counts()
    with torch.inference_mode():
        for _ in range(warm):
            fn(x)
        if x.device.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(x)
            stop.record()
            torch.cuda.synchronize(x.device)
            seconds = start.elapsed_time(stop) / 1e3
        else:
            tic = time.perf_counter()
            for _ in range(iters):
                fn(x)
            seconds = time.perf_counter() - tic
    after = _ca_counts()
    return (x.shape[0] / (seconds / iters), warm + iters,
            {k: after[k] - before[k] for k in after})


def _families():
    """name -> thunk returning (define_model name, structure, input size, metadata
    columns or None); lazy so benchmarking one family never constructs the others.
    Sizes are reference defaults: srcnn/vdsr consume the pre-upscaled 512 input
    (im_input='interp'); sparnet runs its native 128-face workload; the rest are
    true 4x 128->512.  SRMD takes RGB ++ 15 per-pixel maps (its handler concatenates
    15 metadata values), SFTMD a 10-value vector, Q-RCAN and Q-EDSR one value."""
    bf = {'dtype': 'bf16', 'scale': 4}
    return [
        ('srcnn', lambda: ('srcnn', dict(bf, channel_pattern=[3, 64, 32, 3]), 512, None)),
        ('vdsr', lambda: ('vdsr', dict(bf, channel_pattern=[3] + [64] * 19 + [3],
                                       kernel_pattern=[3] * 20), 512, None)),
        ('edsr', lambda: ('edsr', bf, LR, None)),
        ('rcan', lambda: ('rcan', bf, LR, None)),
        ('han', lambda: ('han', bf, LR, None)),
        ('san', lambda: ('san', bf, LR, None)),
        ('srmd', lambda: ('srmd', dict(bf, metadata=['map_%d' % i for i in range(15)]),
                          LR, 15)),
        ('sftmd', lambda: ('sftmd', dict(bf, metadata=['blur_kernel']), LR, 10)),
        ('sparnet', lambda: ('sparnet', bf, 128, None)),
        ('qrcan', lambda: ('qrcan', dict(bf, style='modulate', include_q_layer=True),
                           LR, 1)),
        ('qedsr', lambda: ('qedsr', bf, LR, 1)),
    ]


def family_forward(model, internal, in_size, meta_cols, device):
    """(the handler, its forward on a fixed batch as a function of the image batch,
    the image batch): ``BATCH`` seeded [0, 1) images of ``in_size``^2 and zero
    metadata, through the handler's ``_prep_batch`` and ``forward``."""
    import torch
    from ..models.handlers import define_model
    handler = define_model(model, eval_mode=True, device=device, **internal)
    handler._set_training(False)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(BATCH, in_size, in_size, 3, generator=gen).to(handler.device)
    meta = None if meta_cols is None else torch.zeros(BATCH, meta_cols,
                                                      device=handler.device)

    def fn(h):
        inp, _, m = handler._prep_batch({'lr': h, 'metadata': meta})
        return handler.forward(inp, m)
    return handler, fn, x


def main_table(only, device=None):
    """The family table; returns {family: img/s or None for a FAILED row}."""
    from ..utils.helpers import resolve_device
    device = resolve_device(device)
    print('%-9s %10s  %s' % ('family', 'img/s', '(bf16, batch %d, 4x 128->512)'
                             % BATCH))
    out = {}
    for name, make in _families():
        if only and name not in only:
            continue
        try:
            _, fn, x = family_forward(*make(), device)
            tput = timed(fn, x)[0]
            out[name] = tput
            print('%-9s %10.1f' % (name, tput))
        except Exception as e:  # keep the table going; report the failure
            out[name] = None
            print('%-9s %10s  (%s: %s)' % (name, 'FAILED', type(e).__name__,
                                           str(e)[:60]))
    return out


def main_e2e(only, device=None, n_images=32, batch_size=8):
    """The e2e table; returns {config: img/s or None for a FAILED row}."""
    from .e2e_bench import E2E_CONFIGS, run_config
    keys = [k for k in E2E_CONFIGS if not only or k in only]
    unknown = only - set(E2E_CONFIGS)
    if unknown:
        sys.exit('unknown e2e configs: %s (choose from: %s)'
                 % (', '.join(sorted(unknown)), ', '.join(E2E_CONFIGS)))
    print('%-9s %10s  %s' % ('config', 'img/s', '(end-to-end eval protocol, '
                             '%d images, batch %d)' % (n_images, batch_size)))
    out = {}
    for key in keys:
        try:
            tput = run_config(key, n_images, batch_size, device=device)
            out[key] = tput
            print('%-9s %10.2f' % (key, tput))
        except Exception as e:
            out[key] = None
            print('%-9s %10s  (%s: %s)' % (key, 'FAILED', type(e).__name__,
                                           str(e)[:60]))
    return out


def int8_program(handler, x_cal, meta_cal=None):
    """The handler's int8 program (``BaseHandler._ensure_int8_ctx``: the port's
    ``quantize_*`` and ``calibrate_*``, then ``load_int8_state``), calibrated as the
    main path calibrates: absmax over ``x_cal`` (and its prepared metadata) times 1.1
    (sisr_tpu's bench calibrates with margin 1.0)."""
    handler._invalidate_steps()
    handler._ensure_int8_ctx(x_cal, meta_cal)
    return handler._int8_ctx[0]


def main_paper(args, device=None):
    """PAPER-scale (flagship) forward benchmarks with MFU, on the card.

    Rows: EDSR at the SPL recipe size (256 feats / 32 blocks — ref
    Documentation/sample_config_files/div2k/edsr.toml:43-57) and RCAN/QRCAN at the
    SPL 10 groups x 20 blocks x 64 feats config, bf16 and (where serving-relevant)
    int8, at batch 16.  Returns the rows as dicts (name, img_s, gflop, mfu, vs_bf16,
    calls, launches: the CA counters' increase over the row's calls)."""
    from ..utils.helpers import resolve_device
    from .flops import (edsr_flops_per_image, peak_flops, qrcan_flops_per_image,
                        rcan_flops_per_image)
    device = resolve_device(device)
    peak = peak_flops(device if device.type == 'cuda' else None)
    rows = []

    def row(name, result, flops, bf16=None):
        tput, calls, launches = result
        rows.append({'name': name, 'img_s': tput, 'gflop': flops / 1e9,
                     'mfu': None if bf16 else tput * flops / peak,
                     'vs_bf16': None if bf16 is None else tput / bf16,
                     'calls': calls, 'launches': launches})
        return tput

    # --- EDSR 256f/32b at batch 16
    fl_e = edsr_flops_per_image(feats=256, blocks=32)
    handler, fn, x = family_forward('edsr', {'scale': 4, 'num_features': 256,
                                             'num_blocks': 32, 'dtype': 'bf16'},
                                    LR, None, device)
    bf16_e = row('edsr 256f/32b bf16', timed(fn, x, iters=PAPER_ITERS), fl_e)
    if '--no-int8' not in args:
        program = int8_program(handler, x[:2])
        row('edsr 256f/32b int8', timed(program, x, iters=PAPER_ITERS), fl_e, bf16_e)
    del handler, fn

    # --- RCAN / QRCAN at the SPL config (their defaults ARE the paper size)
    fl_r = rcan_flops_per_image()
    handler, fn, x16 = family_forward('rcan', {'scale': 4, 'dtype': 'bf16'}, LR, None,
                                      device)
    bf16_r = row('rcan 10x20x64 bf16', timed(fn, x16, iters=PAPER_ITERS), fl_r)
    if '--no-int8' not in args:
        program = int8_program(handler, x16[:2])
        row('rcan 10x20x64 int8', timed(program, x16, iters=PAPER_ITERS), fl_r, bf16_r)
    del handler, fn

    _, fn, x16 = family_forward('qrcan', {'scale': 4, 'dtype': 'bf16', 'style': 'modulate',
                                          'include_q_layer': True}, LR, 1, device)
    fl_q = qrcan_flops_per_image()  # +ParaCA meta-MLP terms (ppm-level, but its own model)
    row('qrcan SPL bf16', timed(fn, x16, iters=PAPER_ITERS), fl_q)

    print('%-20s %9s %11s %7s %8s   (4x 128->512; MFU at %.0f bf16 peak TFLOP/s)'
          % ('config', 'img/s', 'GFLOP/img', 'MFU', 'vs bf16', peak / 1e12))
    for r in rows:
        print('%-20s %9.1f %11.1f %7s %8s'
              % (r['name'], r['img_s'], r['gflop'],
                 '—' if r['mfu'] is None else '%.1f%%' % (100 * r['mfu']),
                 '—' if r['vs_bf16'] is None else '%.2fx' % r['vs_bf16']))
    return rows


def main_train(args, device=None):
    from .e2e_bench import measure_train_torch, run_train_bench
    k = 8 if '--fused-dispatch' in args else 1
    cache = '--cache' in args
    tput = run_train_bench(steps_per_dispatch=k, cache_decoded=cache, device=device)
    print('train epoch throughput (EDSR 64f/16b, crop 32, batch 8%s%s): %.2f img/s'
          % (', --fused-dispatch (one step a dispatch here)' if k > 1 else '',
             ', decoded-image cache' if cache else '', tput))
    result = {'train_img_s': tput}
    if '--vs-torch' in args:
        torch_tput = measure_train_torch(device=device)
        result['torch_img_s'] = torch_tput
        print('plain-torch train-step baseline (same model/batch/crop, f32, same '
              'device): %.2f img/s (%.1fx)' % (torch_tput, tput / torch_tput))
    return result


def main_val(device=None):
    from .e2e_bench import run_val_bench
    std, fused = run_val_bench(device=device)
    print('validation epoch throughput (EDSR 64f/16b, 4x 128->512, batch 4): '
          'standard %.2f img/s | fused_val %.2f img/s (%.2fx)'
          % (std, fused, fused / std))
    return std, fused


def _device_arg(args):
    """``--device NAME`` out of the argument list: (device or None, the rest)."""
    args = list(args)
    device = None
    if '--device' in args:
        i = args.index('--device')
        if i + 1 >= len(args):
            sys.exit('--device needs a value (cuda, cuda:N or cpu)')
        device = args[i + 1]
        del args[i:i + 2]
    return device, args


def main(argv=None):
    device, args = _device_arg(sys.argv[1:] if argv is None else argv)
    if '--paper' in args:
        main_paper(set(args), device)
        return 0
    if '--val' in args:
        main_val(device)
        return 0
    if '--train' in args:
        main_train(set(args), device)
        return 0
    if '--e2e' in args:
        out = main_e2e({a for a in args if a != '--e2e'}, device)
        return 1 if None in out.values() else 0
    only = set(args)
    known = {name for name, _ in _families()}
    unknown = only - known
    if unknown:
        sys.exit('unknown families: %s (choose from: %s)'
                 % (', '.join(sorted(unknown)), ', '.join(sorted(known))))
    out = main_table(only, device)
    return 1 if None in out.values() else 0


if __name__ == '__main__':
    sys.exit(main())
