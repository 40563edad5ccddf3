"""EvalHub: model evaluation protocols (PyTorch port of sisr_tpu's
``evaluation/standard_eval.py``, ref: Code/SISR/evaluation/standard_eval.py:23-326).

* The standard protocol (:meth:`EvalHub.full_image_protocol`): per batch the
  Pillow-exact host bicubic LR baseline (timed per image) or an interpolated-LR
  folder, each model's forward on the card (``ModelInterface.net_run_and_process``,
  timed), host PSNR/SSIM on the Y channel (or on the card with ``device_metrics``),
  the SR images (``save_im``) and a comparison collage per image
  (``model_comparisons/image_comparison_<name>.pdf``, one-page PDFs, see
  ``tools/visualization.py``).
* The fused protocol (``fused_eval``, metrics only): forward + bicubic LR baseline +
  YCbCr + PSNR/SSIM in one device step per batch (``BaseHandler.run_eval_fused``);
  it falls back to the standard protocol where it cannot serve (image outputs,
  interpolated LR, bucketed eval), as in sisr_tpu.  With ``cache_device`` (by default
  ``cache_decoded``) the batches of its first complete pass stay on the card (up to
  1 GiB), and each later pass on the hub runs from them: no decode, no collate, no
  upload, and one copy of each model's metrics to the host.
* :meth:`EvalHub.direct_model_protocol` (``model_only``): SR images only.

The CSV reports have the reference's layout.  Degradation metadata for the
meta-models comes from ``--metadata_file``, else a ``degradation_metadata.csv`` or
``qpi_slices.csv`` beside the LR images.  ``int8=True`` turns on each model's int8
serving path (``BaseHandler.set_int8``), ``eval_buckets`` the bucketed eval
(``BaseHandler.set_eval_buckets``; int8 takes precedence), ``decoded_cache_dir`` the
decoded-image sidecars.  ``data_attributes`` (a CelebA attribute file) puts every
attribute in front of each image's metadata, as sisr_tpu does.  FACE_SIM (the cosine
similarity of face embeddings, ``face_model`` and ``face_weights``) runs on the RGB
images in the standard protocol, and turns the fused protocol off.  Multi-device eval
is not ported yet: asking for it raises NotImplementedError.
"""
from collections import OrderedDict, defaultdict
from concurrent.futures import ThreadPoolExecutor
import itertools
import os
import time

import numpy as np
import pandas as pd
import torch
from tqdm import tqdm

from ..data.datasets import SuperResImages
from ..data.loader import DataLoader, device_prefetch
from ..models.feature_extractors import load_face_extractor
from ..models.interface import ModelInterface
from ..ops.colorspace import ycbcr_convert
from ..ops.metrics import Metrics
from ..ops.resize import resize_uint8
from ..tools.visualization import interpret_sisr_images, safe_image_save
from ..utils import toml_io
from ..utils.helpers import create_dir_if_empty

DEVICE_BATCH_CACHE_BYTES = 1 << 30  # the fused protocol's device-batch cache, at most


def _not_ported(what, slice_name, item):
    return NotImplementedError('%s is not ported to sisr_tpu_torch yet: it comes with the '
                               '%s slice (ROADMAP.md, Queue 1 item %d). Use sisr_tpu for it.'
                               % (what, slice_name, item))


class EvalHub:
    def __init__(self, hr_dir, lr_dir, model_and_epoch, results_name, gpu, metrics,
                 data_split, save_im, batch_size, full_directory, lr_dir_interp,
                 model_only, scale, model_loc, out_loc, use_test_group,
                 no_image_comparison, num_image_save, qpi_selection, data_attributes,
                 dataset_name, image_shortlist, metadata_file, sp_gpu, time_models,
                 recursive, mesh=False, eval_buckets=None, int8=False,
                 device_metrics=False, fused_eval=False, face_model='lightcnn',
                 face_weights=None, cache_decoded=True, decoded_cache_dir=None,
                 cache_device=None):
        """Main eval class; param info in net_eval.py (mirrors the reference CLI).
        ``cache_device`` (None: as ``cache_decoded``) keeps the fused protocol's batches
        on the card for later passes; False uploads every pass."""
        if mesh:
            raise _not_ported('--mesh (multi-device eval)', 'multi-GPU data parallelism', 9)
        if not model_and_epoch:
            raise ValueError('No models specified: pass at least one '
                             '-me/--model_and_epoch EXPERIMENT EPOCH pair.')
        self.cache_device = bool(cache_decoded) if cache_device is None else bool(cache_device)
        self._device_batch_cache = None  # the fused protocol's batches, on the card
        self._device_batch_cache_cap = DEVICE_BATCH_CACHE_BYTES
        if decoded_cache_dir:
            # decoded uint8 sidecars on disk: a new process skips the PNG decode
            cache_decoded = decoded_cache_dir

        self.out_dir = os.path.join(out_loc, results_name)
        create_dir_if_empty(self.out_dir)
        input_params = {k: v for k, v in locals().items()
                        if k not in ('self',) and not k.startswith('_')}
        with open(os.path.join(self.out_dir, 'config.toml'), 'w') as f:
            toml_io.dump({k: list(v) if isinstance(v, tuple) else v
                          for k, v in input_params.items() if v is not None}, f)

        experiment_names, eval_epochs = zip(*model_and_epoch)
        self.metrics = list(metrics) if metrics is not None else []
        self.scale = scale
        self.no_image_comparison = no_image_comparison
        self.num_image_save = num_image_save
        self.time_models = time_models
        self.images_processed = 0
        self.save_im = save_im
        self.device = self._select_device(gpu, sp_gpu)
        self.model_bundles = self._prep_models(model_loc, experiment_names, eval_epochs,
                                               self.device, scale=scale)
        if eval_buckets:
            for model in self.model_bundles:
                model.model.set_eval_buckets(eval_buckets)
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
            data_attributes=data_attributes, qpi_selection=qpi_selection)
        self.rgb_data = DataLoader(dataset=rgb_handler, batch_size=batch_size)
        for model in self.model_bundles:
            model.model.set_metadata_keys(rgb_handler.metadata_keys)

        self.interp_loader = None
        if lr_dir_interp:
            # a loader, not one iterator: each protocol run iterates it again
            interp_handler = SuperResImages(
                lr_dir_interp, hr_dir, split=split, input='interp', dataset=dataset,
                scale=scale, custom_split=custom_split, image_shortlist=image_shortlist,
                recursive_search=recursive, cache_decoded=cache_decoded,
                degradation_metadata_file=metadata_file, qpi_selection=qpi_selection)
            self.interp_loader = DataLoader(dataset=interp_handler, batch_size=batch_size)
        self.interp_data = None  # this run's iterator, set when a protocol starts

        self.comparisons_dir = os.path.join(self.out_dir, 'model_comparisons')
        if not no_image_comparison:
            create_dir_if_empty(self.comparisons_dir)
        self.save_folders = {}
        if save_im or model_only:
            for exp in experiment_names:
                self.save_folders[exp] = os.path.join(self.out_dir, exp)
                create_dir_if_empty(self.save_folders[exp])
        # FACE_SIM runs on the RGB images, not the Y-channel preps, so it is split out
        # of the metric loop; --model_only computes no metric and loads no weights
        self.face_metric = 'FACE_SIM' in self.metrics and not model_only
        face_extractor = load_face_extractor(face_model, face_weights, device=self.device) \
            if self.face_metric else None
        self.metrics = [m for m in self.metrics if m != 'FACE_SIM']
        self.metric_hub = Metrics(self.metrics, delimeter='>',
                                  device=self.device if device_metrics else None,
                                  face_extractor=face_extractor)

        # the fused protocol serves metrics-only runs; an interpolated-LR folder it
        # cannot honour (it computes the device bicubic instead), nor FACE_SIM
        self.fused_eval = bool(fused_eval) and bool(self.metrics) and not model_only \
            and not save_im and no_image_comparison and not lr_dir_interp \
            and not self.face_metric
        if fused_eval and not self.fused_eval:
            print('fused_eval needs metrics and no image outputs '
                  '(--no_image_comparison, no --save_im/--model_only, no '
                  '--lr_dir_interp) — disabled.')

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

    def _low_res_prep(self, lr_data, timing=True):
        """The bicubic x``scale`` upsample of the LR batch, Pillow-exact on the host
        (ref: standard_eval.py:146-158): (the float images, each image's resize
        seconds or None)."""
        lr_data = np.asarray(lr_data)
        n, h, w, c = lr_data.shape
        interp = np.empty((n, h * self.scale, w * self.scale, c), np.float32)
        times = [] if timing else None
        for i in range(n):
            u8 = (lr_data[i] * 255).astype(np.uint8)  # ToPILImage's truncation
            tic = time.perf_counter()
            resized = resize_uint8(u8, (w * self.scale, h * self.scale))
            if timing:
                times.append(time.perf_counter() - tic)
            interp[i] = resized.astype(np.float32) / 255.0
        return interp, times

    @staticmethod
    def _high_res_prep(hr_data):
        """RGB -> full 3-channel YCbCr ('jpg' matrices) after a [0, 1] clip (ref:
        standard_eval.py:160-164).  The metrics read channel 0 (Y); Y-channel models
        take channel 0 and their outputs are recombined with channels 1-2."""
        prep = ModelInterface._standard_image_formatting(np.asarray(hr_data))
        for i in range(prep.shape[0]):
            prep[i] = ycbcr_convert(prep[i].transpose(2, 0, 1), im_type='jpg', input='rgb',
                                    y_only=False).transpose(1, 2, 0)
        return prep

    def _generate_image_collage(self, interp_data, model_data, probe_names, metrics=None,
                                metric_slice=None, hr_rgb=None):
        """One comparison collage per image: HR (when given), LR and each model, with
        each model's epoch and metrics (ref: standard_eval.py:166-185)."""
        output_package = OrderedDict()
        if hr_rgb is not None:
            output_package['HR'] = np.asarray(hr_rgb)
        output_package['LR'] = np.asarray(interp_data)
        output_package.update(model_data)
        interpret_sisr_images(
            output_package, metric_slice or {}, metrics or [], self.comparisons_dir,
            names=['image_comparison_%s.pdf' % p.replace(os.path.sep, '_')
                   for p in probe_names],
            config='rgb', extra_info={model.experiment: [['epoch', model.model_epoch]]
                                      for model in self.model_bundles})

    def _host_batches(self):
        """The protocol's float batches (the fused protocol may have left the dataset
        serving uint8), and this run's interpolated-LR iterator."""
        for ds in getattr(self.rgb_data.dataset, 'datasets', [self.rgb_data.dataset]):
            ds.keep_uint8 = False
        self.rgb_data.device_collate = False
        self.interp_data = iter(self.interp_loader) if self.interp_loader else None
        return self.rgb_data

    def _model_input(self, model, batch, interp_data, lr_prep=None):
        """What ``model`` takes: the LR batch, the interpolated one, or (a Y-channel
        model) the interpolated one in YCbCr."""
        if 'rgb' in model.configuration['colorspace']:
            return batch['lr'] if model.configuration['input'] == 'unmodified' \
                else interp_data
        return lr_prep if lr_prep is not None else self._high_res_prep(interp_data)

    def _save_images(self, model, rgb_im, im_names):
        folder = self.save_folders[model.experiment]
        for name in im_names:  # recursive datasets: subfolders must exist
            if os.sep in name:
                create_dir_if_empty(os.path.join(folder, os.path.dirname(name)))
        safe_image_save(rgb_im, folder, im_names, config='rgb')

    def direct_model_protocol(self):
        """SR images only (``model_only``; ref: standard_eval.py:187-215): each
        model's output for each LR image, and the comparison collages unless
        ``no_image_comparison``."""
        with tqdm(total=len(self.rgb_data)) as pbar:
            for batch in self._host_batches():
                im_names = batch['tag']
                self.images_processed += len(im_names)
                probe_names = [n.split('.')[0] for n in list(im_names)]
                if self.interp_data:
                    interp_data = next(self.interp_data)['lr']
                else:
                    interp_data, _ = self._low_res_prep(batch['lr'], timing=False)
                output_package = {}
                for model in self.model_bundles:
                    rgb_im, _, _, _ = model.net_run_and_process(
                        **{**batch, 'lr': self._model_input(model, batch, interp_data)})
                    self._save_images(model, rgb_im, im_names)
                    output_package[model.experiment] = rgb_im
                if not self.no_image_comparison:
                    self._generate_image_collage(interp_data, output_package,
                                                 probe_names=probe_names)
                pbar.update(1)

    def full_image_protocol(self):
        """Full metrics run (ref: standard_eval.py:217-294): the fused protocol where
        it serves, else the standard one."""
        if self.fused_eval:
            if all(m.model.supports_fused_eval() for m in self.model_bundles):
                return self._fused_image_protocol()
            print('fused_eval: some models lack a fused path (bucketed eval) — '
                  'using the standard protocol.')
        metric_package = defaultdict(list)
        hub, delim = self.metric_hub, self.metric_hub.delimeter
        with tqdm(total=len(self.rgb_data)) as pbar:
            for batch in self._host_batches():
                lr_rgb, hr_rgb = batch['lr'], batch['hr']
                im_names = batch['tag']
                self.images_processed += len(im_names)
                probe_names = [n.split('.')[0] for n in list(im_names)]
                hr_names = [n.split('.')[0] for n in list(batch['hr_tag'])]
                metric_package['Image_Name'].append(list(im_names))

                if self.interp_data:
                    interp_data = next(self.interp_data)['lr']
                else:
                    interp_data, timing_info = self._low_res_prep(
                        lr_rgb, timing=self.time_models)
                    if timing_info is not None:
                        # one resize time per image, so the column stays aligned at
                        # batch sizes above 1
                        metric_package['LR%sruntime' % delim].append(timing_info)

                hr_prep = self._high_res_prep(hr_rgb)
                lr_prep = self._high_res_prep(interp_data)
                metric_slice, diag_string = hub.run_metrics(lr_prep, references=hr_prep,
                                                            key='LR', probe_names=hr_names)
                for key, value in metric_slice.items():
                    metric_package[key].append(value)
                if self.face_metric:
                    hr_rgb_fmt = ModelInterface._standard_image_formatting(np.asarray(hr_rgb))
                    metric_package['LR>FACE_SIM'].append(hub.run_image_metric(
                        'FACE_SIM', ModelInterface._standard_image_formatting(
                            np.asarray(interp_data)), hr_rgb_fmt, single_values=True))

                output_package = {}
                for model in self.model_bundles:
                    rgb_im, ycbcr_im, _, runtime = model.net_run_and_process(
                        **{**batch, 'lr': self._model_input(model, batch, interp_data,
                                                            lr_prep)},
                        timing=self.time_models)
                    if runtime is not None:
                        metric_package['%s%sruntime' % (model.experiment, delim)].append(
                            [runtime] * len(im_names))
                    metric_slice, mini_diag = hub.run_metrics(
                        ycbcr_im, hr_prep, key=model.experiment, probe_names=hr_names)
                    for key, value in metric_slice.items():
                        metric_package[key].append(value)
                    diag_string += mini_diag
                    if self.face_metric:
                        metric_package['%s>FACE_SIM' % model.experiment].append(
                            hub.run_image_metric('FACE_SIM', rgb_im, hr_rgb_fmt,
                                                 single_values=True))
                    output_package[model.experiment] = rgb_im
                    # as in the reference, images_processed counts this batch already,
                    # so up to batch_size - 1 fewer images are saved than asked for
                    if self.save_im and self.images_processed < self.num_image_save:
                        self._save_images(model, rgb_im, im_names)

                if not self.no_image_comparison \
                        and self.images_processed < self.num_image_save:
                    self._generate_image_collage(
                        interp_data, output_package, metrics=self.metrics,
                        metric_slice={k: metric_package[k][-1] for k in metric_package},
                        probe_names=probe_names, hr_rgb=hr_rgb)
                pbar.update(1)
                pbar.set_description(diag_string[:-2])
        self.manipulate_and_save_metrics(metric_package)

    def _fused_image_protocol(self):
        """Metrics-only eval with the whole per-batch pipeline on the device (see
        BaseHandler.run_eval_fused).  ``LR>runtime`` under --time_models is NaN: the LR
        prep runs inside the device step, so no separate host resize time exists.

        The first pass: batches reach the card ahead of use (device_prefetch; uniform
        uint8 images copied one by one and stacked on the card) and each batch's metric
        matrix is copied back on a background thread, so host decode of later batches
        overlaps device compute.  The dataset serves uint8, divided on the device.
        With ``cache_device`` a complete pass leaves its device batches in
        ``_device_batch_cache`` (when they take at most 1 GiB; past that the pass keeps
        none); a later pass iterates
        them (no decode, no upload, no fetcher thread) and, unless timed, copies each
        model's metrics to the host once (:meth:`_realize_pending_grouped`)."""
        self.rgb_data.dataset.keep_uint8 = True
        self.rgb_data.device_collate = True
        metric_package = defaultdict(list)
        pending = []  # (experiment, is_first_model, keys, future or (K,N) values, rt, n)
        collect = None
        if self._device_batch_cache is not None:
            batches = iter(self._device_batch_cache)
        else:
            batches = device_prefetch(iter(self.rgb_data), self.device)
            if self.cache_device:
                collect = {'batches': [], 'bytes': 0}
                batches = self._collecting_iter(batches, collect)
        defer = self._device_batch_cache is not None and not self.time_models
        if defer:
            self._run_fused_loop(batches, pending, metric_package, None)
            self._realize_pending_grouped(pending)
        else:
            with ThreadPoolExecutor(max_workers=1) as fetcher:
                self._run_fused_loop(batches, pending, metric_package, fetcher)
                pending = [entry[:3] + (entry[3].result(),) + entry[4:] for entry in pending]
        if collect is not None and collect['bytes'] <= self._device_batch_cache_cap:
            self._device_batch_cache = collect['batches']  # after a complete pass only
        for experiment, is_first, keys, vals, runtime, n in pending:
            rows = dict(zip(keys, vals))
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

    def _collecting_iter(self, batches, collect):
        """``batches``, each kept in ``collect['batches']`` while the bytes of all so far
        (``collect['bytes']``) stay within the cap; past it none are kept."""
        for batch in batches:
            collect['bytes'] += _batch_bytes([batch])
            if collect['bytes'] <= self._device_batch_cache_cap:
                collect['batches'].append(batch)
            else:
                collect['batches'].clear()
            yield batch

    @staticmethod
    def _realize_pending_grouped(pending):
        """Each pending entry's (K, N) device matrix replaced by its host copy, made
        with one concatenation on the card and one copy per (model, keys) group."""
        groups = OrderedDict()
        for i, entry in enumerate(pending):
            groups.setdefault((entry[0], entry[2]), []).append(i)
        for idxs in groups.values():
            mats = [pending[i][3] for i in idxs]
            host = torch.cat(mats, dim=1).cpu().numpy()
            offset = 0
            for i, mat in zip(idxs, mats):
                width = mat.shape[1]
                pending[i] = pending[i][:3] + (host[:, offset:offset + width],) + pending[i][4:]
                offset += width

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
                    # no fetcher: the device matrix waits for one grouped copy
                    fut = vals if fetcher is None \
                        else fetcher.submit(lambda v: v.cpu().numpy(), vals)
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


def _batch_bytes(batches):
    """The bytes of every tensor and array in ``batches`` (lists of them included)."""
    def size(v):
        if isinstance(v, torch.Tensor):
            return v.numel() * v.element_size()
        if isinstance(v, np.ndarray):
            return v.nbytes
        if isinstance(v, (list, tuple)):
            return sum(size(a) for a in v)
        return 0
    return sum(size(v) for batch in batches for v in batch.values())
