"""TrainingHandler: the experiment's epoch loop (PyTorch port of sisr_tpu's
``training/handler.py``, ref: Code/SISR/training/training_handler.py:25-323).

Each epoch trains over the shuffled training loader (batches on their way to the card
while the current step runs), then runs the validation epoch, writes summary.csv, the
loss plots and the first validation batch's SR images, and saves a checkpoint.  The
validation epoch is the standard one (sisr_tpu's default: each batch's SR image and
loss from the card, host PSNR/SSIM on the Y channel) or, with ``fused_val = true``
where it serves (no bucketed eval, metrics within PSNR/SSIM at ``max_im_val`` 1), the
fused one (forward, loss, Y PSNR/SSIM on the device, one (K, N) matrix per batch).
Resume (``continue_from_epoch``) and branching (``new_branch``) continue from a saved
epoch; early stopping watches the validation PSNR; ``epoch_cutoff`` fixes the last
epoch.  ``aim_track`` writes the run's parameters and each epoch's metrics to a JSONL
stream (``tools/tracker.py``, under ``aim_home``, default ``<save_loc>/tracking``);
``model_cleanup_frequency`` N deletes the checkpoints ``clean_models`` does not keep
every N epochs (``tools/helper_cli.py``).

Data parallelism (``gpu = "multi"``, or ``"off"`` for CPU ranks, under a launcher's
process group: ``parallel/distributed.py``): every rank runs this loop on its slice of
each training batch (``BaseHandler.set_mesh``); rank 0 alone writes (checkpoints and
the background writer, summary.csv, plots, samples, tracking, cleanup), and rank 0's
epoch results decide the best epoch and early stopping on every rank.
"""
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from datetime import date, datetime
import itertools
import math
import os
import random
import time

import numpy as np
import torch
import tqdm

from ..configuration import constants as sconst
from ..data.loader import device_prefetch
from ..data.setup import sisr_data_setup
from ..models.interface import ModelInterface
from ..ops.metrics import Metrics
from ..parallel import distributed
from ..tools import profiling
from ..tools.stats import legacy_load_statistics, plot_stats, save_statistics
from ..tools.visualization import safe_image_save
from ..utils.helpers import create_dir_if_empty, training_device

_FUSED_METRICS = {'PSNR', 'SSIM'}


class TrainingHandler:
    def __init__(self,
                 experiment_name='experiment-%s' % date.today().strftime("%b-%d-%Y"),
                 save_loc=sconst.results_directory, aim_track=False, aim_home=None,
                 model_params=None, gpu=None, sp_gpu=0, data_params=None,
                 num_epochs=None, continue_from_epoch=None, max_im_val=1.0, metrics=None,
                 seed=8, model_cleanup_frequency=None, epoch_cutoff=None,
                 early_stopping_patience=None, overwrite_data=False, branch_start=None,
                 new_branch=False, logging='visual', save_samples=True,
                 experiment_group=None, fused_val=False, **kwargs):
        """Parameter semantics follow the reference (training_handler.py:39-63).
        ``gpu``: unset or 'single' trains on cuda:<sp_gpu>, 'off' on the CPU, 'multi'
        data-parallel on each rank's card; under a process group of more than one
        rank, 'off' trains data-parallel on CPU ranks and 'single' raises.
        sisr_tpu's ``steps_per_dispatch`` (K steps in one device dispatch) falls into
        ``kwargs``: here every step is its own dispatch, and K steps in a row are
        the same K steps."""
        self.model_cleanup_frequency = model_cleanup_frequency
        self.tracker = None
        self.metrics = tuple(metrics or ())
        # an unknown metric fails in the validation epoch, as in sisr_tpu
        self.metric_hub = Metrics(metrics) if metrics is not None else None
        self.max_im_val = max_im_val
        self.fused_val = bool(fused_val)
        self._fused_val_warned = False
        world = distributed.world_size()
        if world > 1 and gpu not in ('multi', 'off', False):
            raise RuntimeError('a %d-rank launch trains with gpu = "multi" (a card per '
                               'rank) or "off" (CPU ranks), not %r' % (world, gpu))
        device = training_device(gpu, sp_gpu)
        # every rank runs this loop; rank 0 alone owns the experiment's files
        self._primary = distributed.is_primary_host()
        self.experiment_name = experiment_name
        self.num_epochs = num_epochs
        self.logging = logging
        self.save_samples = save_samples
        self.stop_patience = early_stopping_patience
        self.overwrite = overwrite_data

        # host RNG seeding before the loaders draw their shuffle seeds (ref:
        # training_handler.py:76-79); the weights' seed is in the model's params
        np.random.seed(seed)
        random.seed(seed)

        self.best_val_model_idx = 0
        self.best_val_model_psnr = 0
        self.model_name = model_params['name']
        self.branch_off = new_branch
        self._rewrite_stats = False

        if new_branch and continue_from_epoch is not None:
            branch_name = 'branch_epoch_%d' % continue_from_epoch
            subdir = branch_name if branch_start is None \
                else os.path.join(branch_start, branch_name)
        else:
            subdir = branch_start

        self.model = ModelInterface(save_loc, experiment_name, load_epoch=continue_from_epoch,
                                    device=device, mode='train', new_params=model_params,
                                    save_subdir=subdir, new_branch=self.branch_off,
                                    mesh=gpu == 'multi' or world > 1)
        self.handler = self.model.model

        # a resume trains the epoch after the loaded checkpoint
        self.starting_epoch = self.model.model_epoch
        if continue_from_epoch is not None:
            self.starting_epoch += 1
        if epoch_cutoff is not None:
            self.num_epochs = epoch_cutoff - self.starting_epoch
            print('Epoch count set to %d' % self.num_epochs)

        self.train_data, self.val_data = sisr_data_setup(
            scale=model_params['internal_params']['scale'], **self.model.configuration,
            **data_params)
        self.model.set_metadata_keys(self.train_data.dataset.metadata_keys)
        if getattr(self.train_data.dataset, 'device_degradations', False):
            # the items carry HR crops and kernels; the train step makes the LR
            self.handler.set_device_degrade(True)
        # uint8 transport: crops travel as uint8 (4x fewer bytes) and the train step
        # divides by 255 on the device, bit-identical to the host conversion
        for ds in getattr(self.train_data.dataset, 'datasets', [self.train_data.dataset]):
            ds.keep_uint8 = True

        if aim_track and self._primary:
            # runs are tracked to JSONL streams with Aim's API (tools/tracker.py), under
            # sisr_tpu's run names
            from ..tools.tracker import JsonlTracker
            if continue_from_epoch is None:
                run_name = experiment_name + '_%s' % datetime.today().strftime(
                    "%Hh-%Mm-%Ss-%b-%d-%Y")
            else:
                run_name = 'continuation_from_epoch_%d_' % self.model.model_epoch \
                    + experiment_name
            home = aim_home or os.path.join(save_loc, 'tracking')
            self.tracker = JsonlTracker(experiment=experiment_name, repo=home, run=run_name)
            self.tracker.set_params(dict(model_params), name='model_parameters')
            self.tracker.set_params({'num_epochs': num_epochs,
                                     'continue_from_epoch': continue_from_epoch,
                                     'seed': seed, 'epoch_cutoff': epoch_cutoff},
                                    name='train_parameters')

    def _stream(self, batches, keys):
        """``batches`` on the handler's device (copied ahead on a side stream on CUDA),
        with only the entries ``keys`` names among the arrays."""
        def filtered():
            for batch in batches:
                yield {k: v for k, v in batch.items()
                       if k in keys or not isinstance(v, np.ndarray)}
        return device_prefetch(filtered(), self.handler.device)

    def train(self):
        """One training epoch (ref: training_handler.py:147-177).  Losses stay on the
        device and reach the host in chunks of 8 steps.  Its spans (``tools/profiling``):
        the epoch, each wait for a batch, each step, the loss drains, the epoch's end."""
        current_epoch_losses = defaultdict(list)
        keys = self.handler._train_batch_keys()
        with profiling.span('train.epoch'), profiling.device_allocs(self.handler.device):
            with tqdm.tqdm(total=len(self.train_data)) as pbar_train:
                pending = []

                def drain(force=False):
                    if not pending or (not force and len(pending) < 8):
                        return
                    with profiling.span('train.loss_drain'):
                        flat = torch.cat([p.reshape(-1) for p in pending]).tolist()
                    pending.clear()
                    current_epoch_losses['train-loss'].extend(flat)
                    pbar_train.set_description('loss: {:.4f}'.format(flat[-1]))

                batches = iter(self._stream(self.train_data, keys))
                for step in itertools.count():
                    with profiling.span('train.loader_wait', unit=step):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    pending.append(self.model.train_batch(**batch)[0])
                    profiling.count('train.steps')
                    drain()
                    pbar_train.update(1)
                drain(force=True)
            with profiling.span('train.epoch_end'):
                current_epoch_losses['learning-rate'].append(self.model.get_learning_rate())
                self.model.epoch_end_calls()
        return current_epoch_losses

    def _use_fused_val(self):
        """Whether the fused validation epoch serves this run (ref:
        training/handler.py:252-265): ``fused_val``, a handler with a fused path, an RGB
        model and metrics within PSNR/SSIM at max_im_val 1; otherwise the standard
        epoch, with one notice."""
        if not self.fused_val:
            return False
        ok = (self.handler.supports_fused_eval()
              and 'rgb' in self.model.configuration['colorspace']
              and float(self.max_im_val) == 1.0 and set(self.metrics) <= _FUSED_METRICS)
        if not ok and not self._fused_val_warned:
            print('fused_val: unsupported for this model/metric set — using the '
                  'standard validation path.')
            self._fused_val_warned = True
        return ok

    def eval(self, epoch_idx):
        """One validation epoch (ref: training_handler.py:179-224): the fused one where
        it serves, else the standard one."""
        if self._use_fused_val():
            return self._fused_eval_epoch(epoch_idx)
        return self._standard_eval_epoch(epoch_idx)

    def _standard_eval_epoch(self, epoch_idx):
        """The standard validation epoch (ref: sisr_tpu training/handler.py:347-384):
        per batch the SR image and the loss from the card
        (``ModelInterface.net_run_and_process``), the metrics of its Y channel against
        HR's on the host at ``max_im_val``, and the first batch's SR images as the
        epoch's samples."""
        for ds in getattr(self.val_data.dataset, 'datasets', [self.val_data.dataset]):
            ds.keep_uint8 = False
        current_epoch_losses = defaultdict(list)
        metric_package = {}
        with tqdm.tqdm(total=len(self.val_data)) as pbar_val:
            for index, batch in enumerate(self.val_data):
                y, im_names = batch['hr'], batch['tag']
                rgb_out, ycbcr_out, loss, _ = self.model.net_run_and_process(
                    **batch, request_loss=True)
                if 'rgb' in self.model.configuration['colorspace']:
                    y_proc = self.model.colorspace_convert(y, colorspace='rgb')
                else:
                    y_proc = self.model._standard_image_formatting(np.asarray(y))
                current_epoch_losses['val-loss'].append(loss)
                if self.metric_hub is not None:
                    metric_package, _ = self.metric_hub.run_metrics(
                        ycbcr_out, references=y_proc, max_value=self.max_im_val, key='val',
                        probe_names=[n.split('.')[0] for n in im_names])
                    for metric, result in metric_package.items():
                        current_epoch_losses[metric].extend(result)
                if index == 0 and self.save_samples and self._primary:
                    folder = os.path.join(self.model.logs, 'epoch_%d_samples' % epoch_idx)
                    create_dir_if_empty(folder)
                    safe_image_save(rgb_out, folder,
                                    [name.replace(os.sep, '_') for name in im_names],
                                    config='rgb')
                pbar_val.update(1)
                diag_string = 'loss: {:.4f}, '.format(loss)
                for metric in metric_package.keys():
                    diag_string += '{}: {:.4f}, '.format(metric,
                                                         np.mean(metric_package[metric]))
                pbar_val.set_description(diag_string[:-2])
        return current_epoch_losses

    def _fused_eval_epoch(self, epoch_idx):
        """Validation epoch with each batch's forward, loss and metrics in one device
        step (BaseHandler.run_eval_fused with request_loss); the (K, N) row matrices
        are copied to the host on a background thread as the batches go."""
        current_epoch_losses = defaultdict(list)
        for ds in getattr(self.val_data.dataset, 'datasets', [self.val_data.dataset]):
            ds.keep_uint8 = True
        pending = []
        with ThreadPoolExecutor(max_workers=1) as fetcher, \
                tqdm.tqdm(total=len(self.val_data)) as pbar_val:
            for index, batch in enumerate(self._stream(self.val_data, ('lr', 'hr',
                                                                       'metadata'))):
                (keys, vals), _ = self.handler.run_eval_fused(
                    batch, metrics=self.metrics, include_lr=False, request_loss=True)
                pending.append((keys, fetcher.submit(lambda v=vals: v.cpu().numpy())))
                if index == 0 and self.save_samples:
                    self._save_samples(batch, epoch_idx)
                pbar_val.update(1)
        for keys, fut in pending:
            rows = dict(zip(keys, fut.result()))
            # a rectangular batch repeats its batch-mean loss per image; a ragged one
            # carries per-image losses: the mean is the batch's loss either way
            current_epoch_losses['val-loss'].append(float(np.mean(rows['model>loss'])))
            for met in self.metrics:
                current_epoch_losses['val-%s' % met].extend(
                    float(v) for v in rows['model>%s' % met])
        if pending and 'PSNR' in self.metrics:
            print('val PSNR: %.4f' % np.mean(current_epoch_losses['val-PSNR']))
        return current_epoch_losses

    def _save_samples(self, batch, epoch_idx):
        """The SR images of the first validation batch (the first image of a ragged
        one) into logs/epoch_<N>_samples (ref: training_handler.py:210-214).  Every rank
        computes them (a tile grid is shared out over the ranks); rank 0 writes them."""
        names = [name.replace(os.sep, '_') for name in batch['tag']]
        if isinstance(batch['lr'], list):
            meta = batch.get('metadata')
            batch = {'lr': batch['lr'][0][None], 'hr': batch['hr'][0][None],
                     'metadata': None if meta is None else meta[:1]}
            names = names[:1]
        images = self.handler.super_resolve(batch)
        if not self._primary:
            return
        folder = os.path.join(self.model.logs, 'epoch_%d_samples' % epoch_idx)
        create_dir_if_empty(folder)
        safe_image_save(images, folder, names, config='rgb')

    def run_experiment(self):
        """Full training run (ref: training_handler.py:226-323)."""
        total_losses = defaultdict(list)
        if self.starting_epoch != 0 and self._primary:
            logs = os.path.dirname(self.model.logs) if self.branch_off else self.model.logs
            loaded = legacy_load_statistics(logs, 'summary.csv')
            if 'epoch' in loaded:
                # a resume from an earlier epoch rewrites history: the rows of the
                # epochs trained again are stale, in the dict and, at the first save,
                # in the file
                keep = [i for i, e in enumerate(loaded['epoch']) if e < self.starting_epoch]
                if len(keep) != len(loaded['epoch']):
                    loaded = {k: [v[i] for i in keep] for k, v in loaded.items()}
                    self._rewrite_stats = True
            total_losses = defaultdict(list, loaded)
            if loaded.get('val-PSNR') and not np.all(np.isnan(loaded['val-PSNR'])):
                # a resume continues the best-PSNR race instead of restarting it at 0
                best_row = int(np.nanargmax(loaded['val-PSNR']))
                self.best_val_model_psnr = loaded['val-PSNR'][best_row]
                self.best_val_model_idx = int(loaded['epoch'][best_row]) \
                    if 'epoch' in loaded else best_row
        # summary.csv is rank 0's: its history and best epoch hold on every rank
        (total_losses, self.best_val_model_psnr, self.best_val_model_idx,
         self._rewrite_stats) = distributed.broadcast_object(
            (total_losses, self.best_val_model_psnr, self.best_val_model_idx,
             self._rewrite_stats))
        try:
            result = self._epoch_loop(total_losses)
        except BaseException:
            # drain the queued writes, bounded, without masking the primary failure
            try:
                self.model.wait_pending_checkpoints(timeout=120)
            except BaseException as ckpt_err:
                import sys
                print('WARNING: background checkpoint writes also failed/stalled '
                      'during shutdown: %r' % (ckpt_err,), file=sys.stderr)
            raise
        # the checkpoints are on disk before the run is reported complete, on every rank
        self.model.wait_pending_checkpoints()
        distributed.barrier()
        return result

    def _epoch_loop(self, total_losses):
        improvement_count = 0
        for i, epoch_idx in enumerate(range(self.starting_epoch,
                                            self.starting_epoch + self.num_epochs)):
            epoch_start_time = time.time()
            print('Running epoch', epoch_idx)
            self.model.set_epoch(epoch_idx)
            if i == 0 and self._primary:
                self.model.save(override=self.overwrite, dry_run=True)

            print('Training Run:')
            training_loss = self.train()
            print('Validation Run:')
            eval_loss = self.eval(epoch_idx)
            # rank 0's results decide the best epoch and early stopping on every rank: a
            # rank that decided alone would wait in the next step's all-reduce for ever
            current_epoch_losses = distributed.broadcast_object(
                {**training_loss, **eval_loss})

            if 'val-PSNR' in current_epoch_losses:
                val_mean_psnr = np.mean(current_epoch_losses['val-PSNR'])
                if val_mean_psnr > self.best_val_model_psnr:
                    self.best_val_model_psnr = val_mean_psnr
                    self.best_val_model_idx = epoch_idx
                    improvement_count = 0
                else:
                    improvement_count += 1
            # without a val-PSNR there is no improvement signal: patience does not tick

            n_rows = len(total_losses['epoch'])
            for key, value in current_epoch_losses.items():
                avg_val = np.nanmean(value)
                if math.isnan(avg_val):
                    avg_val = 0
                if len(total_losses[key]) < n_rows:
                    # a metric new in this run: NaN history keeps the rows rectangular
                    total_losses[key] = [float('nan')] * n_rows + total_losses[key]
                total_losses[key].append(avg_val)
                if self.tracker is not None:
                    self.tracker.track(avg_val, name=key.replace('-', '_'), epoch=epoch_idx)
            total_losses['epoch'].append(epoch_idx)
            for value in total_losses.values():
                if len(value) < n_rows + 1:  # a metric dropped in this run
                    value.extend([float('nan')] * (n_rows + 1 - len(value)))

            if self._primary:
                self._write_epoch(i, epoch_idx, total_losses, current_epoch_losses,
                                  epoch_start_time)
            if self.stop_patience is not None \
                    and improvement_count >= max(1, self.stop_patience):
                print('Stopping model training, validation PSNR has plateaued.')
                break
        return total_losses

    def _write_epoch(self, i, epoch_idx, total_losses, current_epoch_losses,
                     epoch_start_time):
        """The epoch's files (rank 0's): plots, the checkpoint, summary.csv, cleanup,
        tracking."""
        if self.logging == 'visual':
            plot_stats(stats_dict=total_losses,
                       keynames=[['train-loss', 'val-loss'], ['val-PSNR'], ['val-SSIM']],
                       experiment_log_dir=self.model.logs, filename='loss_plots.pdf')

        self.model.save(override=self.overwrite)
        if self._rewrite_stats:
            save_statistics(experiment_log_dir=self.model.logs, filename='summary.csv',
                            stats_dict=total_losses, append=False)
            self._rewrite_stats = False
        else:
            resumed = self.starting_epoch != 0 or i > 0
            save_statistics(experiment_log_dir=self.model.logs, filename='summary.csv',
                            stats_dict=total_losses,
                            selected_data=epoch_idx if resumed else None,
                            append=resumed)

        out_string = ' '.join('{}_{:.4f}'.format(key, np.mean(value))
                              for key, value in current_epoch_losses.items())
        if self.model_cleanup_frequency is not None and i != 0 \
                and i % self.model_cleanup_frequency == 0:
            from ..tools.helper_cli import clean_models
            # cleanup lists the checkpoint files: every background write first
            self.model.wait_pending_checkpoints()
            clean_models(self.model.base_folder, clean_samples=True)
        if self.tracker is not None:
            self.tracker.track(time.time() - epoch_start_time, name='epoch_time',
                               epoch=epoch_idx)
        print('Epoch {}/{}:'.format(epoch_idx, self.starting_epoch + self.num_epochs - 1),
              out_string, 'Epoch duration:',
              '{:.4f}'.format(time.time() - epoch_start_time), 'seconds')
        print('-------------')
