"""Paper-scale training soak: EDSR at the SPL recipe size on the card (PyTorch port
of sisr_tpu's ``tools/train_soak.py``: the same TOML, flags and ``soak_result.json``).

Drives the REAL product path (``net_train.experiment_setup`` with a generated TOML)
for a few thousand optimizer steps of EDSR 256 feats / 32 blocks in bf16 with the SPL
recipe semantics (crop 64 + random augments, per-BATCH cosine warm restarts
restart_period=40000 / lr_min=1e-7 — ref Documentation/sample_config_files/
div2k/edsr.toml:43-57), fused validation and the decoded-image cache.  DIV2K/Flickr2K
are not in the repo; the workload is the 512^2 tile set of
``tools/e2e_bench.build_workload`` (batch 16 instead of the recipe's single-GPU batch
4).  sisr_tpu's ``steps_per_dispatch = 8`` stays in the TOML; the port runs every step
as its own dispatch.

Reports: median img/s over the steady-state epochs (the tracker's ``epoch_time``,
which includes each epoch's validation and checkpoint), best val-PSNR, and dB over the
bicubic baseline on the val images.  Artifacts (the TOML, summary.csv and the tracked
JSONL) are copied to ``--out``.

Run: ``python -m sisr_tpu_torch.tools.train_soak --steps 3000 --out
soak_runs/edsr_paper_torch [--device cpu]``
"""
import argparse
import json
import os
import shutil
import sys
import tempfile


def bicubic_baseline(lr_dir, hr_dir, n=4, scale=4):
    """Mean Y-channel PSNR of the Pillow-bicubic upscale of the first ``n`` LR images
    against their HR images (the handler's val protocol: ``EvalHub._low_res_prep`` and
    ``_high_res_prep``, host ``Metrics``)."""
    import numpy as np
    from PIL import Image
    from ..evaluation.standard_eval import EvalHub
    from ..ops.metrics import Metrics
    hub = Metrics(['PSNR'], delimeter='>')
    fake = type('H', (), {'scale': scale})()
    names = sorted(os.listdir(hr_dir))[:n]
    vals = []
    for name in names:
        lr = np.asarray(Image.open(os.path.join(lr_dir, name)), np.float32)[None] / 255.0
        hr = np.asarray(Image.open(os.path.join(hr_dir, name)), np.float32)[None] / 255.0
        interp, _ = EvalHub._low_res_prep(fake, lr, timing=False)
        res, _ = hub.run_metrics(EvalHub._high_res_prep(interp),
                                 references=EvalHub._high_res_prep(hr), key='LR')
        vals.extend(np.atleast_1d(res['LR>PSNR']).tolist())
    return float(np.mean(vals))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=3000)
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--images', type=int, default=512)
    ap.add_argument('--feats', type=int, default=256)
    ap.add_argument('--blocks', type=int, default=32)
    ap.add_argument('--out', default='soak_runs/edsr_paper_torch')
    ap.add_argument('--device', default=None, help='cuda (default), cuda:N or cpu')
    args = ap.parse_args(argv)

    from .e2e_bench import build_workload
    from ..utils import toml_io
    from ..utils.helpers import resolve_device
    device = resolve_device(args.device)

    steps_per_epoch = args.images // args.batch
    epochs = max(1, -(-args.steps // steps_per_epoch))
    tmp = tempfile.mkdtemp(prefix='sisr_soak_')
    os.makedirs(args.out, exist_ok=True)
    try:
        lr_dir, hr_dir = build_workload(tmp, args.images)
        cfg = {
            'experiment': 'edsr_paper_soak',
            'experiment_save_loc': os.path.join(tmp, 'Results'),
            'data': {
                'batch_size': args.batch, 'dataloader_threads': 8,
                'training_sets': {'data_1': {
                    'lr': lr_dir, 'hr': hr_dir, 'crop': 64,
                    'random_augment': True, 'cache_decoded': True}},
                'eval_sets': {'data_1': {
                    'lr': lr_dir, 'hr': hr_dir, 'cutoff': 4,
                    'cache_decoded': True}},
            },
            'model': {'name': 'edsr', 'internal_params': {
                'scale': 4, 'num_features': args.feats, 'num_blocks': args.blocks,
                'res_scale': 0.1, 'lr': 1e-4, 'dtype': 'bf16',
                'scheduler': 'cosine_annealing_warm_restarts',
                'scheduler_params': {'t_mult': 1, 'restart_period': 40000,
                                     'lr_min': 1e-7}}},
            'training': {'num_epochs': epochs, 'metrics': ['PSNR'],
                         'seed': 8, 'logging': 'text',
                         'gpu': 'single' if device.type == 'cuda' else 'off',
                         'sp_gpu': device.index or 0,
                         'steps_per_dispatch': 8, 'fused_val': True,
                         'save_samples': False, 'model_cleanup_frequency': 10,
                         'aim_track': True,
                         'aim_home': os.path.join(tmp, 'tracking')},
        }
        toml_path = os.path.join(tmp, 'soak.toml')
        with open(toml_path, 'w') as f:
            toml_io.dump(cfg, f)
        shutil.copy(toml_path, os.path.join(args.out, 'soak_config.toml'))

        from ..net_train import experiment_setup
        print('soak: %d epochs x %d steps (batch %d) of EDSR %df/%db'
              % (epochs, steps_per_epoch, args.batch, args.feats, args.blocks))
        try:
            experiment_setup(args=['--parameters', toml_path], standalone_mode=False)
        except SystemExit as e:
            if e.code not in (0, None):
                raise

        exp_dir = os.path.join(tmp, 'Results', 'edsr_paper_soak')
        summary_csv = os.path.join(exp_dir, 'result_outputs', 'summary.csv')
        shutil.copy(summary_csv, os.path.join(args.out, 'summary.csv'))
        # tracked JSONL (tools/tracker.py layout: <aim_home>/<experiment>/<run>.jsonl)
        jsonl = None
        for root, _, files in os.walk(os.path.join(tmp, 'tracking')):
            for f in files:
                if f.endswith('.jsonl'):
                    jsonl = os.path.join(root, f)
        if jsonl:
            shutil.copy(jsonl, os.path.join(args.out, 'run_tracking.jsonl'))

        # --- report: throughput from tracked epoch_time, quality vs bicubic
        import pandas as pd
        epoch_times = []
        if jsonl:
            with open(jsonl) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec.get('name') == 'epoch_time':
                        epoch_times.append(float(rec['value']))
        steady = sorted(epoch_times[1:] or epoch_times)
        if steady:
            med = steady[len(steady) // 2]
            tput = args.images / med
        else:
            # no tracker jsonl found: the quality report must still be produced
            med = tput = None
        df = pd.read_csv(summary_csv)
        best_psnr = float(df['val-PSNR'].max())
        bicubic = bicubic_baseline(lr_dir, hr_dir)

        result = {
            'model': 'edsr %df/%db bf16' % (args.feats, args.blocks),
            'recipe': 'SPL crop64+augment, cosine-warm-restarts/batch '
                      '(40000, 1e-7), batch %d, one step a dispatch' % args.batch,
            'steps': epochs * steps_per_epoch,
            'train_img_per_sec_per_chip': round(tput, 2) if tput else None,
            'median_epoch_s': round(med, 2) if med else None,
            'best_val_psnr_db': round(best_psnr, 3),
            'bicubic_baseline_psnr_db': round(bicubic, 3),
            'db_over_bicubic': round(best_psnr - bicubic, 3),
        }
        with open(os.path.join(args.out, 'soak_result.json'), 'w') as f:
            json.dump(result, f, indent=1)
        print('SOAK_RESULT ' + json.dumps(result))
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == '__main__':
    main()
    sys.exit(0)
