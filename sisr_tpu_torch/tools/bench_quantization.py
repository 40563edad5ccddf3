"""bf16 against static int8 for every family with an int8 program (PyTorch port of
sisr_tpu's ``tools/bench_quantization.py``: the same sections, inputs and lines).

Each section builds its family at the serving size through ``define_model`` (bf16
eval), times the handler's bf16 forward, quantises the weights and calibrates the
static activation scales on two images (the port's ``quantize_*`` and
``calibrate_*`` through ``BaseHandler._ensure_int8_ctx``: absmax times 1.1, the main
path's margin, where sisr_tpu's bench takes 1.0),
times each residual carry's ``*_int8_forward_static`` program, and reports each int8
program's fidelity in dB against the same weights' f32 forward (TF32 off) on the first
image.  Timing: ``ITERS`` calls after warm-up calls, between CUDA events.

Run: ``python -m sisr_tpu_torch.tools.bench_quantization [family ...] [--all]
[--device cpu]``
"""
import sys

import numpy as np

BATCH, ITERS = 16, 20
HW = 128  # the LR side of the serving input (VDSR takes 4 * HW, pre-upscaled)


def _fid(out, ref):
    """Fidelity of the quantized output vs the f32 model, in dB."""
    err = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    return 10 * np.log10(1.0 / max(float((err ** 2).mean()), 1e-12))


def _serving_x(channels=3, hw=None, seed=0, batch=None):
    hw, batch = hw or HW, batch or BATCH
    return np.random.RandomState(seed).rand(batch, hw, hw, channels).astype(np.float32)


def _meta(seed):
    """A batch of 10 seeded metadata values an image (one blur kernel's)."""
    return np.random.RandomState(seed).rand(BATCH, 10).astype(np.float32)


def _module_f32(handler, inp, meta):
    """The handler's module in true f32 (no autocast, TF32 off) on the module input
    ``inp`` and its metadata input, as NHWC."""
    import torch
    from ..ops.quantization import _true_f32
    args = (meta,) if handler.module_takes_metadata else ()
    with torch.inference_mode(), _true_f32(), \
            torch.autocast(handler.device.type, enabled=False):
        return handler.module(inp.permute(0, 3, 1, 2), *args).permute(0, 2, 3, 1)


def _section(label, model, internal, x, meta=None, seed=0, carries=('bfloat16',),
             device=None, raw_input=False, lines=None):
    """One family: the bf16 handler's img/s, then each carry's int8 img/s, its ratio
    to bf16 and its dB against f32.  ``x`` is the image batch (numpy) and ``meta`` its
    metadata; with ``raw_input`` x is the module's input as it is (SRMD's 18 channels),
    not passed through the handler's preparation.  ``lines``: the bf16 and int8 line
    labels (sisr_tpu's), the int8 one with a ``%s`` for the carry where it has one."""
    import torch
    from ..models.handlers import define_model
    from .bench_models import int8_program, timed
    bf16_line, int8_line = lines or ('%-26s' % ('%s bf16 model' % label),
                                     '%-26s' % ('%s int8 static' % label))
    handler = define_model(model, eval_mode=True, device=device, seed=seed, dtype='bf16',
                           **internal)
    handler._set_training(False)
    x = torch.from_numpy(x).to(handler.device)
    m = None if meta is None else torch.from_numpy(meta).to(handler.device)
    if raw_input:
        inp, mod_meta = x, None
    else:
        inp, _, mod_meta = handler._prep_batch({'lr': x, 'metadata': m})
    ref = _module_f32(handler, inp[:1], None if mod_meta is None else mod_meta[:1])
    ref = ref.float().cpu().numpy()

    bf16_tput = timed(lambda h: handler.forward(h, mod_meta), inp, ITERS)[0]
    print('%s: %8.1f img/s' % (bf16_line, bf16_tput))
    result = {'family': label, 'bf16_img_s': bf16_tput, 'int8': {}}
    program = int8_program(handler, inp[:2], None if mod_meta is None else mod_meta[:2])
    for carry in carries:
        if carry != handler.int8_residual_dtype:
            handler.int8_residual_dtype = carry
            handler.load_int8_state(*handler._int8_ctx[1:])
            program = handler._int8_ctx[0]
        tput, _, launches = timed(lambda h: program(h, mod_meta), inp, ITERS)
        with torch.inference_mode():
            out = program(inp[:1], None if mod_meta is None else mod_meta[:1])
        fid = _fid(out.float().cpu().numpy(), ref)
        name = int8_line % carry if '%' in int8_line else int8_line
        print('%s: %8.1f img/s  (%.2fx bf16, %4.1f dB vs f32)'
              % (name, tput, tput / bf16_tput, fid))
        result['int8'][carry] = {'img_s': tput, 'vs_bf16': tput / bf16_tput,
                                 'db_vs_f32': fid, 'launches': launches}
    return result


def _rcan_section(device=None):
    return _section('rcan', 'rcan', {'scale': 4}, _serving_x(), seed=1, device=device,
                    lines=('rcan bf16 model           ', 'rcan int8 static, bf16 res'))


def _han_section(device=None):
    return _section('han', 'han', {'scale': 4}, _serving_x(), seed=2, device=device,
                    lines=('han bf16 model            ', 'han int8 static, bf16 res '))


def _qrcan_section(device=None):
    cfg = dict(n_resgroups=10, n_resblocks=20, n_feats=64, scale=4, style='max_concat',
               metadata=['blur_kernel'], include_q_layer=True)
    return _section('qrcan', 'qrcan', cfg, _serving_x(), _meta(12), seed=2, device=device,
                    lines=('qrcan bf16 model           ', 'qrcan int8 static, bf16 res'))


def _edsr_section(device=None):
    return _section('edsr', 'edsr', {'scale': 4, 'num_features': 64, 'num_blocks': 16},
                    _serving_x(), seed=0, carries=('float32', 'bfloat16', 'int16'),
                    device=device,
                    lines=('edsr bf16 model           ', 'edsr int8, %-9s res  '))


def _vdsr_section(device=None):
    """VDSR serves the pre-upscaled 512 input (im_input='interp', y-only)."""
    return _section('vdsr', 'vdsr', {'scale': 4}, _serving_x(channels=1, hw=4 * HW, seed=3),
                    seed=3, device=device, lines=('vdsr bf16 model  (512-in) ',
                                                  'vdsr int8 static          '))


def _srmd_section(device=None):
    """SRMD consumes the RGB + 15 metadata-map concat input (in_nc=18)."""
    return _section('srmd', 'srmd', {'scale': 4, 'metadata': ['map_%d' % i
                                                              for i in range(15)]},
                    _serving_x(channels=18, seed=4), seed=4, device=device,
                    raw_input=True)


def _sftmd_section(device=None):
    return _section('sftmd', 'sftmd', {'scale': 4, 'metadata': ['blur_kernel']},
                    _serving_x(seed=5), _meta(15), seed=5, device=device)


def _san_section(device=None):
    return _section('san', 'san', {'scale': 4}, _serving_x(seed=6), seed=6, device=device)


def _qsan_section(device=None):
    return _section('qsan', 'qsan', {'scale': 4, 'metadata': ['blur_kernel']},
                    _serving_x(seed=7), _meta(17), seed=7, device=device)


def _qedsr_section(device=None):
    return _section('qedsr', 'qedsr', {'scale': 4, 'metadata': ['blur_kernel']},
                    _serving_x(seed=8), _meta(18), seed=8, device=device)


def _qhan_section(device=None):
    return _section('qhan', 'qhan', {'scale': 4, 'metadata': ['blur_kernel']},
                    _serving_x(seed=9), _meta(19), seed=9, device=device)


SECTIONS = {
    'edsr': _edsr_section, 'rcan': _rcan_section, 'han': _han_section,
    'qrcan': _qrcan_section, 'vdsr': _vdsr_section, 'srmd': _srmd_section,
    'sftmd': _sftmd_section, 'san': _san_section, 'qsan': _qsan_section,
    'qedsr': _qedsr_section, 'qhan': _qhan_section,
}


def main(argv=None):
    """Default: the round-3 quartet (edsr/rcan/han/qrcan).  Pass family names to
    select sections, or ``--all`` for every int8-covered family; ``--device cpu``
    runs on the CPU.  Returns each section's results."""
    from .bench_models import _device_arg
    device, args = _device_arg(sys.argv[1:] if argv is None else argv)
    from ..utils.helpers import resolve_device
    device = resolve_device(device)
    if '--all' in args:
        names = list(SECTIONS)
    elif args:
        unknown = set(args) - set(SECTIONS)
        if unknown:
            sys.exit('unknown families: %s (choose from: %s)'
                     % (', '.join(sorted(unknown)), ', '.join(SECTIONS)))
        names = [a for a in args if a in SECTIONS]
    else:
        names = ['edsr', 'rcan', 'han', 'qrcan']
    return [SECTIONS[name](device) for name in names]


if __name__ == '__main__':
    main()
