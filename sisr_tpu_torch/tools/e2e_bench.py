"""End-to-end eval-protocol benchmark machinery for the BASELINE configs (PyTorch port
of sisr_tpu's ``tools/e2e_bench.py``: the same configs, functions and arguments).

BASELINE.md lists five benchmark configs; each is measured through the product eval
path (``EvalHub.full_image_protocol``: PNG decode -> LR prep -> upload -> the forward
on the card -> YCbCr -> PSNR/SSIM -> CSV), not a synthetic forward loop.  Which of
those steps a timed pass runs depends on the caches: at ``measure_e2e``'s defaults
(``cache_decoded=True``, so the fused protocol's device-batch cache is on) the warm-up
pass decodes, prepares and uploads every batch, and the timed passes reuse those
batches on the card, so they time the forward, YCbCr, PSNR/SSIM and the CSV, and
decode no PNG.  ``cache_decoded=False`` times every step, the decode included
(``bench_decode_cache`` times both ways of reading the images).

1. srcnn   — pre-upscaled (interp) y-channel input
2. edsr    — 4x 128->512, fused device eval; also with the int8 serving path
             ('edsr_int8')
3. qrcan   — meta-attention with 10-d blur-kernel metadata through the QModel path
4. san     — second-order attention with the static tile-grid eval engaged
5. sparnet — face SR 128->512 on the pre-upscaled pipeline

Every entry point runs on the card unless the caller names another device
(``device='cpu'``); without CUDA and without that request it raises.  Times are host
clocks that end in ``torch.cuda.synchronize()``, after a warm-up pass.  The training
benches drive the port's ``TrainingHandler``, which runs every step as its own
dispatch: sisr_tpu's ``steps_per_dispatch`` (K steps in one device program) is taken
and changes nothing here.

Shared by ``python -m sisr_tpu_torch.tools.bench_models --e2e`` (the full table),
``bench_decode_cache`` and ``train_soak``.
"""
import json
import os
import sys
import time

import numpy as np

# a folder of Set5's HR PNGs (sisr_tpu reads the reference checkout's copy): workload
# images are cropped from it when it is there, else they are noise
SET5_HR = os.environ.get('SISR_SET5_HR')

# BASELINE benchmark configs #1-#5 (BASELINE.md "Benchmark configs to stand up")
E2E_CONFIGS = {
    'srcnn': dict(
        model='srcnn',
        internal={'scale': 4, 'kernel_pattern': [9, 1, 5],
                  'channel_pattern': [1, 64, 32, 1]},
        spatial=(512, 512), fused=True, metadata_cols=0),
    'edsr': dict(
        model='edsr',
        internal={'scale': 4, 'num_features': 64, 'num_blocks': 16, 'dtype': 'bf16'},
        spatial=(128, 128), fused=True, metadata_cols=0),
    'edsr_int8': dict(
        model='edsr',
        internal={'scale': 4, 'num_features': 64, 'num_blocks': 16, 'dtype': 'bf16'},
        spatial=(128, 128), fused=True, metadata_cols=0, int8=True),
    'qrcan': dict(
        model='qrcan',
        internal={'scale': 4, 'style': 'max_concat', 'include_q_layer': True,
                  'metadata': ['blur_kernel'], 'dtype': 'bf16'},
        spatial=(128, 128), fused=True, metadata_cols=10),
    'san': dict(
        model='san',
        # max_combined_im_size < 128^2 forces the static tile-grid eval (config #4
        # calls for the tiled path — the framework's forward_chop replacement)
        internal={'scale': 4, 'dtype': 'bf16', 'max_combined_im_size': 8192},
        spatial=(128, 128), fused=True, metadata_cols=0),
    'sparnet': dict(
        model='sparnet',
        internal={'scale': 4, 'dtype': 'bf16'},
        spatial=(512, 512), fused=True, metadata_cols=0),
}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def synchronize(device):
    """Wait for the card's queued work (nothing on the CPU)."""
    import torch
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def build_workload(root, n_images, lr_size=128, scale=4, metadata_cols=0):
    """N LR/HR PNG pairs shaped like the DIV2K 4x eval workload (lr_size^2 ->
    (lr_size*scale)^2).  Sourced from Set5 crops when available (realistic PNG
    entropy), else noise.  With ``metadata_cols``, writes the reference's
    degradation_metadata.csv contract (JSON blur-kernel lists) alongside the LR set.
    The same bytes as sisr_tpu's for the same arguments and Set5 folder."""
    from PIL import Image
    hr_size = lr_size * scale
    lr_dir = os.path.join(root, 'lr')
    hr_dir = os.path.join(root, 'hr')
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    sources = []
    if SET5_HR and os.path.isdir(SET5_HR):
        for f in sorted(os.listdir(SET5_HR)):
            im = Image.open(os.path.join(SET5_HR, f)).convert('RGB')
            if im.width >= 256 and im.height >= 256:
                sources.append(np.asarray(im.resize((hr_size, hr_size),
                                                    Image.BICUBIC)))
    rng = np.random.RandomState(0)
    names = []
    for i in range(n_images):
        if sources:
            hr = sources[i % len(sources)].copy()
            hr[:8, :8] = rng.randint(0, 255, (8, 8, 3))  # decorrelate duplicates
        else:
            hr = rng.randint(0, 255, (hr_size, hr_size, 3)).astype(np.uint8)
        name = 'im_%03d.png' % i
        names.append(name)
        hr_im = Image.fromarray(hr.astype(np.uint8))
        hr_im.save(os.path.join(hr_dir, name))
        hr_im.resize((lr_size, lr_size), Image.BICUBIC).save(
            os.path.join(lr_dir, name))
    if metadata_cols:
        with open(os.path.join(lr_dir, 'degradation_metadata.csv'), 'w') as f:
            f.write('image,blur_kernel\n')
            for name in names:
                kern = rng.dirichlet(np.ones(metadata_cols) * 5)
                f.write('%s,"%s"\n' % (name, json.dumps(kern.tolist())))
    return lr_dir, hr_dir


def build_experiment(root, name, model, internal, spatial, metadata_cols=0):
    """A ready-to-evaluate experiment dir (seeded init, epoch 0) for ``name``, saved
    through the port's handler.  ``spatial`` is sisr_tpu's init shape; a torch module's
    parameters do not depend on it.  The weights are drawn on the host."""
    from ..models.handlers import define_model
    from ..utils import toml_io
    del spatial
    base = os.path.join(root, 'Results', name)
    saved = os.path.join(base, 'saved_models')
    os.makedirs(saved)
    with open(os.path.join(base, 'config.toml'), 'w') as f:
        toml_io.dump({'model': {'name': model, 'internal_params': internal}}, f)
    h = define_model(model, eval_mode=False, device='cpu', **internal)
    if h.uses_metadata:
        h.set_metadata_keys(['blur_kernel'] * metadata_cols)
    h.save_model('train_model', 0, saved)
    h.wait_pending_checkpoints()  # epoch resolution below lists the dir on disk
    return os.path.join(root, 'Results')


def make_hub(lr_dir, hr_dir, model_loc, out_root, experiment, batch_size, fused=True,
             scale=4, int8=False, cache_decoded=True, cache_device=None, device=None,
             results_name='bench_eval'):
    """The EvalHub of the protocol benches, on ``device`` (the card by default)."""
    from ..evaluation.standard_eval import EvalHub
    from ..utils.helpers import resolve_device
    device = resolve_device(device)
    return EvalHub(
        hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[(experiment, '0')],
        results_name=results_name, gpu=device.type == 'cuda', metrics=['PSNR', 'SSIM'],
        data_split='all', save_im=False, batch_size=batch_size, full_directory=True,
        lr_dir_interp=None, model_only=False, scale=scale, model_loc=model_loc,
        out_loc=out_root, use_test_group=False, no_image_comparison=True,
        num_image_save=0, qpi_selection=(None, None), data_attributes=None,
        dataset_name=None, image_shortlist=None, metadata_file=None,
        sp_gpu=device.index or 0, time_models=False, recursive=False,
        device_metrics=True, fused_eval=fused, int8=int8, cache_decoded=cache_decoded,
        cache_device=cache_device)


def timed_passes(hub, n_images, passes, device):
    """``passes`` timed runs of ``hub.full_image_protocol`` (each to a synchronise):
    their img/s, sorted."""
    rates = []
    for i in range(passes):
        log('timed protocol run %d...' % i)
        synchronize(device)
        t0 = time.perf_counter()
        hub.full_image_protocol()
        synchronize(device)
        rates.append(n_images / (time.perf_counter() - t0))
    return sorted(rates)


def measure_e2e(lr_dir, hr_dir, model_loc, out_root, experiment, batch_size,
                n_images, fused=True, scale=4, int8=False, cache_decoded=True,
                cache_device=None, device=None):
    """Wall-clock the product eval protocol after one warm-up pass: the median img/s
    of ``BENCH_PASSES`` passes.  Its per-image CSV is
    ``<out_root>/bench_eval/standard_metrics/individual_metrics.csv``.

    By default the timed passes are served by the device-batch cache the warm-up
    fills: no decode, prep or upload, only the forward and the metrics.
    ``cache_decoded=False`` disables BOTH the decoded-image cache and the fused
    protocol's device-batch reuse, so every timed pass performs the full protocol
    (decode -> prep -> upload -> forward -> metrics).  ``cache_device=False`` keeps the
    decoded-image cache but re-uploads every pass."""
    from ..utils.helpers import resolve_device
    device = resolve_device(device)
    hub = make_hub(lr_dir, hr_dir, model_loc, out_root, experiment, batch_size, fused,
                   scale, int8, cache_decoded, cache_device, device)
    log('warmup protocol run (first calls)...')
    hub.full_image_protocol()
    # median of BENCH_PASSES passes with spread: the median is the deliverable; min/max
    # are logged
    rates = timed_passes(hub, n_images, int(os.environ.get('BENCH_PASSES', '5')), device)
    log('protocol passes (img/s): median %.2f | min %.2f | max %.2f | n=%d'
        % (rates[len(rates) // 2], rates[0], rates[-1], len(rates)))
    return rates[len(rates) // 2]


def run_config(key, n_images=32, batch_size=8, device=None):
    """Build workload + experiment for BASELINE config ``key``, return e2e img/s."""
    import shutil
    import tempfile
    cfg = E2E_CONFIGS[key]
    tmp = tempfile.mkdtemp(prefix='sisr_e2e_%s_' % key)
    try:
        lr_dir, hr_dir = build_workload(tmp, n_images,
                                        metadata_cols=cfg['metadata_cols'])
        model_loc = build_experiment(tmp, 'bench_%s' % key, cfg['model'],
                                     cfg['internal'], cfg['spatial'],
                                     metadata_cols=cfg['metadata_cols'])
        return measure_e2e(lr_dir, hr_dir, model_loc, os.path.join(tmp, 'out'),
                           'bench_%s' % key, batch_size, n_images,
                           fused=cfg['fused'], int8=cfg.get('int8', False), device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


TIMED_EPOCHS = 3  # the training benches' timed epochs, after a warm-up one

EDSR_BENCH = {'name': 'edsr', 'internal_params': {'scale': 4, 'num_features': 64,
                                                  'num_blocks': 16, 'dtype': 'bf16'}}


def _train_gpu(device):
    """The TrainingHandler's ``gpu`` for ``device``: 'single' (cuda:<sp_gpu>) or
    'off'."""
    from ..utils.helpers import resolve_device
    device = resolve_device(device)
    return ('single' if device.type == 'cuda' else 'off'), device


def run_train_bench(n_images=128, batch_size=8, crop=32, steps_per_dispatch=1,
                    cache_decoded=False, device=None):
    """END-TO-END training-epoch throughput (BASELINE config #2's train side): the
    real product loop — threaded decode, random crops/augments, copies ahead to the
    card, the train step (forward, backward, Adam, schedule) — for EDSR 64f/16b bf16
    at LR crop ``crop``.  ``steps_per_dispatch`` is taken and changes nothing: every
    step is its own dispatch here.

    Returns images/sec over the best of ``TIMED_EPOCHS`` timed epochs, after one
    warm-up epoch."""
    import shutil
    import tempfile
    from ..training.handler import TrainingHandler
    from ..utils.toml_io import convert_default_none_dict
    gpu, device = _train_gpu(device)
    tmp = tempfile.mkdtemp(prefix='sisr_trainbench_')
    try:
        lr_dir, hr_dir = build_workload(tmp, n_images)
        data_params = convert_default_none_dict({
            'training_sets': {'data_1': {'lr': lr_dir, 'hr': hr_dir, 'crop': crop,
                                         'random_augment': True,
                                         'cache_decoded': cache_decoded}},
            'eval_sets': {'data_1': {'lr': lr_dir, 'hr': hr_dir, 'cutoff': 2}},
            'batch_size': batch_size, 'dataloader_threads': 8})
        handler = TrainingHandler(
            experiment_name='bench_train', save_loc=os.path.join(tmp, 'Results'),
            model_params=EDSR_BENCH, gpu=gpu, sp_gpu=device.index or 0,
            data_params=data_params, num_epochs=1, metrics=[], seed=8,
            logging=None, save_samples=False, steps_per_dispatch=steps_per_dispatch)
        log('warmup training epoch (first calls)...')
        handler.train()
        best = 0.0
        for i in range(TIMED_EPOCHS):
            log('timed training epoch %d...' % i)
            synchronize(device)
            t0 = time.perf_counter()
            handler.train()
            synchronize(device)
            best = max(best, n_images / (time.perf_counter() - t0))
        return best
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_val_bench(n_images=64, eval_batch_size=4, device=None):
    """Training-time VALIDATION epoch throughput, standard host path vs fused_val
    (forward + YCbCr + PSNR/SSIM + loss in one device step per batch, one copy of the
    rows per batch).  EDSR 64f/16b bf16 on the 128->512 workload.

    Returns (standard_img_s, fused_img_s) over the best of ``TIMED_EPOCHS`` epochs
    each."""
    import shutil
    import tempfile
    from ..training.handler import TrainingHandler
    from ..utils.toml_io import convert_default_none_dict
    gpu, device = _train_gpu(device)
    tmp = tempfile.mkdtemp(prefix='sisr_valbench_')
    try:
        lr_dir, hr_dir = build_workload(tmp, n_images)
        data_params = convert_default_none_dict({
            'training_sets': {'data_1': {'lr': lr_dir, 'hr': hr_dir, 'crop': 32}},
            'eval_sets': {'data_1': {'lr': lr_dir, 'hr': hr_dir,
                                     'cutoff': n_images}},
            'batch_size': 8, 'eval_batch_size': eval_batch_size,
            'dataloader_threads': 8})
        handler = TrainingHandler(
            experiment_name='bench_val', save_loc=os.path.join(tmp, 'Results'),
            model_params=EDSR_BENCH, gpu=gpu, sp_gpu=device.index or 0,
            data_params=data_params, num_epochs=1, metrics=['PSNR', 'SSIM'],
            seed=8, logging=None, save_samples=False)
        handler.model.model.init_state()
        results = {}
        for fused in (False, True):
            handler.fused_val = fused
            log('warmup val epoch (fused=%s, first calls)...' % fused)
            handler.eval(0)
            best = 0.0
            for i in range(TIMED_EPOCHS):
                synchronize(device)
                t0 = time.perf_counter()
                handler.eval(0)
                synchronize(device)
                best = max(best, n_images / (time.perf_counter() - t0))
            results[fused] = best
        return results[False], results[True]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_torch_edsr():
    """The reference-equivalent plain torch EDSR 64f/16b (public standard
    architecture), the train-step baseline below."""
    import torch
    import torch.nn as nn

    class ResBlock(nn.Module):
        def __init__(s, n):
            super().__init__()
            s.c1 = nn.Conv2d(n, n, 3, padding=1)
            s.c2 = nn.Conv2d(n, n, 3, padding=1)

        def forward(s, x):
            return x + 0.1 * s.c2(torch.relu(s.c1(x)))

    class EDSR(nn.Module):
        def __init__(s, n=64, blocks=16):
            super().__init__()
            s.head = nn.Conv2d(3, n, 3, padding=1)
            s.body = nn.Sequential(*[ResBlock(n) for _ in range(blocks)])
            s.bt = nn.Conv2d(n, n, 3, padding=1)
            ups = []
            for _ in range(2):
                ups += [nn.Conv2d(n, 4 * n, 3, padding=1), nn.PixelShuffle(2)]
            s.up = nn.Sequential(*ups)
            s.tail = nn.Conv2d(n, 3, 3, padding=1)

        def forward(s, x):
            x = s.head(x)
            r = s.bt(s.body(x)) + x
            return s.tail(s.up(r))

    return EDSR()


def measure_train_torch(n_steps=6, batch_size=8, crop=32, device=None):
    """Plain-torch train-step baseline: the same EDSR 64f/16b forward + backward +
    Adam at the same crop/batch, f32 NCHW, on ``device`` (the card by default)."""
    import torch
    import torch.nn as nn
    from ..utils.helpers import resolve_device
    device = resolve_device(device)
    model = build_torch_edsr().to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    crit = nn.L1Loss()
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(batch_size, 3, crop, crop, generator=gen).to(device)
    y = torch.rand(batch_size, 3, crop * 4, crop * 4, generator=gen).to(device)
    for _ in range(2):  # warmup
        opt.zero_grad(); crit(model(x), y).backward(); opt.step()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        opt.zero_grad(); crit(model(x), y).backward(); opt.step()
    synchronize(device)
    return n_steps * batch_size / (time.perf_counter() - t0)
