"""Measure the persisted decoded-uint8 disk cache (``.npy`` sidecars) end to end
(PyTorch port of sisr_tpu's ``tools/bench_decode_cache.py``: the same arms, flags and
JSON line).

Decision rule: make the sidecar path a *recommended default* only if it improves the
e2e protocol by >= +15%; otherwise keep it opt-in (``--decoded_cache_dir``).

Method — both arms run the REAL product path (``EvalHub.full_image_protocol``, EDSR
4x 128->512 fused, the ``edsr`` e2e config) with the in-memory cache defeated so every
timed pass pays the image-ingest cost:

* arm "png":     ``cache_decoded=False`` — every pass decodes every PNG (and, with it,
                 uploads every batch: no device-batch cache).
* arm "sidecar": ``cache_decoded='sidecar'`` with the in-memory budget zeroed after
                 the warm-up pass (``_decode_cache_lock``, ``_decode_cache_cap``) and
                 the device-batch cache off — every pass np.load()s the sidecars the
                 warm-up wrote instead of decoding.

Each pass is timed on the host clock to a ``torch.cuda.synchronize()``.

Run: ``python -m sisr_tpu_torch.tools.bench_decode_cache [--images 32] [--batch 8]
[--passes 5] [--device cpu]``
Prints one JSON line with both medians and the ratio.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile


def _timed_passes(hub, n_images, passes, defeat_mem_cache, device):
    """Warmup (first calls + populates caches), then ``passes`` timed protocol runs.
    With ``defeat_mem_cache``, the decoded-uint8 RAM cache is emptied and its budget
    zeroed after warmup so every timed pass re-reads from disk."""
    from .e2e_bench import timed_passes
    hub.full_image_protocol()
    if defeat_mem_cache:
        for loader in (hub.rgb_data, hub.interp_loader):
            if loader is None:
                continue
            ds = loader.dataset
            with ds._decode_cache_lock:
                ds._decode_cache.clear()
                ds._decode_cache_bytes = 0
                ds._decode_cache_cap = 0
    rates = timed_passes(hub, n_images, passes, device)
    return rates[len(rates) // 2], rates


def main(argv=None):
    """Both arms; returns the printed result."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--images', type=int, default=32)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--passes', type=int, default=5)
    ap.add_argument('--device', default=None, help='cuda (default), cuda:N or cpu')
    args = ap.parse_args(argv)

    from .e2e_bench import E2E_CONFIGS, build_experiment, build_workload, log, make_hub
    from ..utils.helpers import resolve_device
    device = resolve_device(args.device)

    cfg = E2E_CONFIGS['edsr']
    tmp = tempfile.mkdtemp(prefix='sisr_decodecache_')
    try:
        lr_dir, hr_dir = build_workload(tmp, args.images)
        model_loc = build_experiment(tmp, 'bench_edsr', cfg['model'],
                                     cfg['internal'], cfg['spatial'])

        def arm_hub(tag, cache_decoded):
            return make_hub(lr_dir, hr_dir, model_loc, os.path.join(tmp, 'out'),
                            'bench_edsr', args.batch, cache_decoded=cache_decoded,
                            cache_device=False, device=device,
                            results_name='bench_%s' % tag)

        log('arm png: every pass decodes every PNG...')
        png_med, png_rates = _timed_passes(
            arm_hub('png', False), args.images, args.passes,
            defeat_mem_cache=False, device=device)  # cache_decoded=False re-decodes
        log('png passes (img/s): %s' % ['%.2f' % r for r in png_rates])

        log('arm sidecar: every pass np.loads pre-populated sidecars...')
        side_med, side_rates = _timed_passes(
            arm_hub('sidecar', 'sidecar'), args.images, args.passes,
            defeat_mem_cache=True, device=device)
        log('sidecar passes (img/s): %s' % ['%.2f' % r for r in side_rates])

        result = {
            'metric': 'decode_cache_e2e_edsr_4x_128to512',
            'png_img_per_sec': round(png_med, 3),
            'sidecar_img_per_sec': round(side_med, 3),
            'sidecar_speedup': round(side_med / png_med, 4),
            'unit': 'img/s/card',
            'recommend_default': side_med / png_med >= 1.15,
        }
        print(json.dumps(result))
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == '__main__':
    main()
    sys.exit(0)
