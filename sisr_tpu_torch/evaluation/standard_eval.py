"""EvalHub: the fused metrics protocol (PyTorch port of the fused path of sisr_tpu's
``evaluation/standard_eval.py``, ref: Code/SISR/evaluation/standard_eval.py:23-326).

Each batch runs forward + bicubic LR baseline + YCbCr + PSNR/SSIM on the device (see
``BaseHandler.run_eval_fused``); the CSV reports have the reference's layout.
Degradation metadata for the meta-models comes from ``--metadata_file``, else a
``degradation_metadata.csv`` or ``qpi_slices.csv`` beside the LR images.  The
standard protocol (host metrics, SR image outputs, comparisons, interpolated-LR
folders), CelebA data attributes, bucketed eval and multi-device eval are not ported
yet: asking for them raises NotImplementedError.  ``int8=True`` turns on each model's
int8 serving path (``BaseHandler.set_int8``), which runs inside the fused step.
"""
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
import itertools
import os

import numpy as np
import pandas as pd
import torch
from tqdm import tqdm

from ..data.datasets import SuperResImages
from ..data.loader import DataLoader, device_prefetch
from ..models.interface import ModelInterface
from ..utils import toml_io
from ..utils.helpers import create_dir_if_empty


def _not_ported(what, slice_name):
    return NotImplementedError('%s is not ported to sisr_tpu_torch yet: it comes with the '
                               '%s slice (ROADMAP.md, Queue 1). Use sisr_tpu for it.'
                               % (what, slice_name))


class EvalHub:
    def __init__(self, hr_dir, lr_dir, model_and_epoch, results_name, gpu, metrics,
                 data_split, save_im, batch_size, full_directory, lr_dir_interp,
                 model_only, scale, model_loc, out_loc, use_test_group,
                 no_image_comparison, num_image_save, qpi_selection, data_attributes,
                 dataset_name, image_shortlist, metadata_file, sp_gpu, time_models,
                 recursive, mesh=False, eval_buckets=None, int8=False,
                 device_metrics=False, fused_eval=False, face_model='lightcnn',
                 face_weights=None, cache_decoded=True, decoded_cache_dir=None):
        """Main eval class; param info in net_eval.py (mirrors the reference CLI)."""
        if mesh:
            raise _not_ported('--mesh (multi-device eval)', 'multi-GPU data parallelism')
        if eval_buckets:
            raise _not_ported('--eval_buckets', 'standard eval protocol')
        if metrics and 'FACE_SIM' in metrics:
            raise _not_ported('The FACE_SIM metric', 'long-tail tools')
        if not (fused_eval and metrics and no_image_comparison and not model_only
                and not save_im and not lr_dir_interp):
            raise _not_ported('Only --fused_eval with metrics, --no_image_comparison and '
                              'no image outputs runs; the standard eval protocol',
                              'standard eval protocol')
        if data_attributes is not None:
            raise _not_ported('CelebA data attributes', 'remaining families')
        if decoded_cache_dir:
            raise _not_ported('--decoded_cache_dir', 'standard eval protocol')
        if not model_and_epoch:
            raise ValueError('No models specified: pass at least one '
                             '-me/--model_and_epoch EXPERIMENT EPOCH pair.')

        self.out_dir = os.path.join(out_loc, results_name)
        create_dir_if_empty(self.out_dir)
        input_params = {k: v for k, v in locals().items()
                        if k not in ('self',) and not k.startswith('_')}
        with open(os.path.join(self.out_dir, 'config.toml'), 'w') as f:
            toml_io.dump({k: list(v) if isinstance(v, tuple) else v
                          for k, v in input_params.items() if v is not None}, f)

        experiment_names, eval_epochs = zip(*model_and_epoch)
        self.metrics = list(metrics)
        self.time_models = time_models
        self.device = self._select_device(gpu, sp_gpu)
        self.model_bundles = self._prep_models(model_loc, experiment_names, eval_epochs,
                                               self.device, scale=scale)
        if int8:
            for model in self.model_bundles:
                model.model.set_int8(True)

        if full_directory:
            split, dataset, custom_split = 'all', None, None
        else:
            split = data_split if data_split is not None else 'eval'
            dataset = dataset_name
            custom_split = (162899, 163000) if use_test_group else None
        metadata_file, requested_metadata = self._find_metadata_file(metadata_file, lr_dir)
        rgb_handler = SuperResImages(
            lr_dir, hr_dir, split=split, dataset=dataset, scale=scale,
            custom_split=custom_split, image_shortlist=image_shortlist,
            recursive_search=recursive, cache_decoded=cache_decoded,
            degradation_metadata_file=metadata_file, metadata=requested_metadata,
            qpi_selection=qpi_selection)
        self.rgb_data = DataLoader(dataset=rgb_handler, batch_size=batch_size)
        for model in self.model_bundles:
            model.model.set_metadata_keys(rgb_handler.metadata_keys)

    @staticmethod
    def _find_metadata_file(metadata_file, lr_dir):
        """(metadata file, requested columns) (ref: standard_eval.py:84-99): an
        explicit file must exist; else lr_dir's degradation_metadata.csv, else its
        qpi_slices.csv, each with all its columns; else none."""
        if metadata_file is not None and not os.path.isfile(metadata_file):
            # an explicitly requested file must exist: falling back to the lr_dir
            # defaults would run with other metadata than asked for
            raise FileNotFoundError('metadata_file not found: %s' % metadata_file)
        if metadata_file is None:
            metadata_file = os.path.join(lr_dir, 'degradation_metadata.csv')
        if not os.path.isfile(metadata_file):
            metadata_file = os.path.join(lr_dir, 'qpi_slices.csv')
            if not os.path.isfile(metadata_file):
                print('No metadata file found.')
                return None, None
        return metadata_file, 'all'

    @staticmethod
    def _select_device(gpu, sp_gpu=0):
        """``gpu`` -> cuda:<sp_gpu> (device 0 if out of range); otherwise the CPU."""
        if not gpu:
            return torch.device('cpu')
        if not torch.cuda.is_available():
            raise RuntimeError('--gpu (the default) asks for CUDA, but '
                               'torch.cuda.is_available() is False: pass --no-gpu to run '
                               'on the CPU.')
        if int(sp_gpu) >= torch.cuda.device_count():
            print('sp_gpu=%s requested but only %d device(s) visible — using device 0.'
                  % (sp_gpu, torch.cuda.device_count()))
            sp_gpu = 0
        return torch.device('cuda', int(sp_gpu))

    @staticmethod
    def _prep_models(model_loc, experiment_names, eval_epochs, device, scale=4):
        """(ref: standard_eval.py:127-144)"""
        return [ModelInterface(model_loc, experiment,
                               load_epoch=eval_epoch if eval_epoch in ('best', 'last')
                               else int(eval_epoch),
                               device=device, scale=scale)
                for experiment, eval_epoch in zip(experiment_names, eval_epochs)]

    def full_image_protocol(self):
        """Full metrics run (ref: standard_eval.py:217-294), fused on the device."""
        return self._fused_image_protocol()

    def _fused_image_protocol(self):
        """Metrics-only eval with the whole per-batch pipeline on the device (see
        BaseHandler.run_eval_fused).  ``LR>runtime`` under --time_models is NaN: the LR
        prep runs inside the device step, so no separate host resize time exists.

        Batches reach the card ahead of use (device_prefetch) and each batch's metric
        matrix is copied back on a background thread, so host decode of later
        batches overlaps device compute.  The dataset serves uint8, divided on the
        device."""
        self.rgb_data.dataset.keep_uint8 = True
        metric_package = defaultdict(list)
        pending = []  # (experiment, is_first_model, keys, future of (K,N) values, rt, n)
        batches = device_prefetch(iter(self.rgb_data), self.device)
        with ThreadPoolExecutor(max_workers=1) as fetcher:
            self._run_fused_loop(batches, pending, metric_package, fetcher)
            for experiment, is_first, keys, fut, runtime, n in pending:
                rows = dict(zip(keys, fut.result()))
                for met in self.metrics:
                    if is_first:
                        metric_package['LR>%s' % met].append(
                            [float(x) for x in rows['LR>%s' % met]])
                    metric_package['%s>%s' % (experiment, met)].append(
                        [float(x) for x in rows['model>%s' % met]])
                if runtime is not None:
                    if is_first:
                        metric_package['LR>runtime'].append([float('nan')] * n)
                    metric_package['%s>runtime' % experiment].append([runtime] * n)
        self.manipulate_and_save_metrics(metric_package)

    def _run_fused_loop(self, batches, pending, metric_package, fetcher):
        with tqdm(total=len(self.rgb_data)) as pbar:
            for batch in batches:
                im_names = batch['tag']
                metric_package['Image_Name'].append(list(im_names))
                diag = ''
                for idx, model in enumerate(self.model_bundles):
                    (keys, vals), runtime = model.model.run_eval_fused(
                        batch, metrics=tuple(self.metrics), timing=self.time_models,
                        include_lr=idx == 0)
                    fut = fetcher.submit(lambda v: v.cpu().numpy(), vals)
                    pending.append((model.experiment, idx == 0, keys, fut, runtime,
                                    len(im_names)))
                    if runtime is not None and 'PSNR' in self.metrics:
                        psnr_row = fut.result()[keys.index('model>PSNR')]
                        diag += '%s PSNR: %.4f, ' % (model.experiment,
                                                     float(np.mean(psnr_row)))
                pbar.update(1)
                if diag:
                    pbar.set_description(diag[:-2])

    def manipulate_and_save_metrics(self, metric_package):
        """MultiIndex CSV reports (ref: standard_eval.py:300-319)."""
        for key in metric_package.keys():
            metric_package[key] = list(itertools.chain.from_iterable(metric_package[key]))

        full_results = pd.DataFrame.from_dict(metric_package).set_index(['Image_Name'])
        full_results.columns = pd.MultiIndex.from_tuples(
            [tuple(c.split('>')) for c in full_results.columns])
        av_results = self.average_multilevel_dataframe(full_results)

        metrics_dir = os.path.join(self.out_dir, 'standard_metrics')
        create_dir_if_empty(metrics_dir)
        full_results.to_csv(os.path.join(metrics_dir, 'individual_metrics.csv'))
        av_results.to_csv(os.path.join(metrics_dir, 'average_metrics.csv'))
        return full_results, av_results

    def average_multilevel_dataframe(self, dataframe):
        """(ref: standard_eval.py:321-326)"""
        r1 = dataframe.mean(axis=0).rename('Mean')
        r2 = dataframe.std(axis=0).rename('Std')
        results = pd.concat([r1, r2], axis=1)
        results = pd.DataFrame(results.stack()).T.stack(0).droplevel(level=0)
        return results
