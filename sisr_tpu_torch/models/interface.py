"""Client-side model interface: experiment directories, checkpoint selection, the
standard eval's forward with its colorspace post-processing and the training
passthroughs (PyTorch port of sisr_tpu's ``models/interface.py``, ref:
Code/SISR/models/__init__.py:33-254 ModelInterface)."""
import glob
import os

import numpy as np
import pandas as pd
import torch

from ..ops.colorspace import ycbcr_convert
from ..parallel.distributed import barrier
from ..parallel.mesh import MeshContext
from ..utils import toml_io
from ..utils.async_ckpt import WRITER
from ..utils.helpers import create_dir_if_empty
from .handlers import define_model


class ModelInterface:
    """The experiment ``model_loc/experiment`` on ``device`` (default: cuda).

    ``mode='eval'`` loads the checkpoint of ``load_epoch`` (an epoch number, 'best' or
    'last').  ``mode='train'`` builds a new model from ``new_params`` (the config's
    [model] table), or, given ``load_epoch``, resumes that checkpoint with its optimizer
    state; ``save_subdir`` puts logs and checkpoints in a subfolder (a branch), and
    with ``new_branch`` the checkpoint is read from the parent folder.  With ``mesh``
    (sisr_tpu's ``gpu = 'multi'``) the model runs data-parallel over the process
    group's ranks (``BaseHandler.set_mesh``) once it is built and loaded; under a
    process group constructing one with ``load_epoch`` is collective: every rank meets
    at a barrier before any reads the checkpoint rank 0 wrote."""

    def __init__(self, model_loc, experiment, load_epoch=None, device=None, scale=None,
                 mode='eval', new_params=None, save_subdir=None, new_branch=False,
                 mesh=False):
        log_dir, save_dir = 'result_outputs', 'saved_models'
        if save_subdir is not None:
            log_dir = os.path.join(log_dir, save_subdir)
            save_dir = os.path.join(save_dir, save_subdir)
        self.experiment = experiment
        self.base_folder = os.path.abspath(os.path.join(model_loc, experiment))
        self.logs = os.path.join(self.base_folder, log_dir)
        self.saved_models = os.path.join(self.base_folder, save_dir)
        self.mode = mode
        load_override = os.path.dirname(self.saved_models) if new_branch else None

        if mode == 'train':
            create_dir_if_empty(self.base_folder, self.logs, self.saved_models)
            if new_params is None and load_epoch is None:
                raise RuntimeError('Need to specify model parameters to train a new model.')
        elif load_epoch is None:
            raise RuntimeError('Need to specify which model epoch to load.')

        if load_epoch is None:
            self.metadata = new_params
        else:
            # rank 0's background checkpoint writes are on disk before any rank reads
            WRITER.wait()
            barrier()
            self.metadata = toml_io.load(self._config_path())['model']
        self.name = self.metadata['name']
        if self.name == 'qpircan':  # legacy conversion (ref: models/__init__.py:92-93)
            self.name = 'qrcan'

        internal = dict(self.metadata.get('internal_params') or {})
        if scale is not None:
            if internal.get('scale') is None:
                internal['scale'] = scale  # config omitted it: honor the request
            elif scale != internal['scale']:
                raise Exception('The model loaded has been trained for a different '
                                'scale, and cannot produce the requested images.')
        internal.pop('metadata_list', None)
        self.model = define_model(name=self.name, eval_mode=mode == 'eval', device=device,
                                  **internal)
        if mode == 'train':
            self.model.check_trainable()  # before any epoch runs

        self.model_epoch = 0
        if load_epoch is not None:
            if load_epoch in ('best', 'last'):
                # fence first: the best epoch's background write may be in flight
                self.model.wait_pending_checkpoints()
                load_epoch = self._resolve_epoch(load_epoch)
            self.model_epoch = int(load_epoch)
            self.model.load_model(model_save_name='train_model', model_idx=load_epoch,
                                  model_save_dir=self.saved_models,
                                  load_override=load_override)

        if mesh:
            self.model.set_mesh(MeshContext(device=device))
        self.configuration = {'input': self.model.im_input,
                              'colorspace': self.model.colorspace}
        self.print_overview()

    def _config_path(self):
        """config.toml, else the newest config*.toml (resumed runs write
        config_from_epoch_N.toml)."""
        config_path = os.path.join(self.base_folder, 'config.toml')
        if os.path.isfile(config_path):
            return config_path
        snapshots = sorted(glob.glob(os.path.join(self.base_folder, 'config*.toml')),
                           key=os.path.getmtime)
        if not snapshots:
            raise RuntimeError('No config.toml found in %s - model structure unknown.'
                               % self.base_folder)
        return snapshots[-1]

    def _resolve_epoch(self, which):
        """'best' (highest val-PSNR) or 'last' epoch from summary.csv, walking the
        ranking to the first epoch whose checkpoint is on disk."""
        summary = pd.read_csv(os.path.join(self.logs, 'summary.csv'))
        # resolve through the 'epoch' column, not row position: resumed / branched
        # runs can leave stale duplicate-epoch rows appended to summary.csv
        if which == 'best':
            rows = summary['val-PSNR'].sort_values(ascending=False).index
        else:
            rows = summary.index[::-1]
        candidates = [int(summary['epoch'].loc[r]) if 'epoch' in summary else int(r)
                      for r in rows]
        missing = []
        for cand in candidates:
            if os.path.exists(os.path.join(self.saved_models, 'train_model_%d' % cand)):
                break
            missing.append(cand)
        else:
            raise FileNotFoundError('summary.csv lists epochs %s but no corresponding '
                                    'train_model_* checkpoint exists in %s'
                                    % (candidates, self.saved_models))
        if missing:
            print('WARNING: %r epoch(s) %s have no checkpoint on disk (failed/cleaned '
                  'save?) — loading epoch %d instead.' % (which, missing, cand))
        return cand

    # --- training passthroughs ------------------------------------------------------------
    def train_batch(self, lr=None, hr=None, metadata=None, metadata_keys=None,
                    blur_kernels=None, _shard_factor=1, **kwargs):
        """One train step; ``_shard_factor`` W > 1 marks the arrays as this rank's
        slice of a global batch W times larger (``DataLoader(process_shard=...)``)."""
        if metadata_keys is not None and self.model.metadata_keys is None:
            self.model.set_metadata_keys(metadata_keys)
        return self.model.run_train(lr=lr, hr=hr, metadata=metadata,
                                    blur_kernels=blur_kernels, _shard_factor=_shard_factor)

    def train_batch_multi(self, batches):
        """K steps (see BaseHandler.run_train_multi): a list of K batch dicts, or one
        dict of (K, B, ...) stacked arrays."""
        first = batches if isinstance(batches, dict) else (batches[0] if batches else {})
        if first.get('metadata_keys') is not None and self.model.metadata_keys is None:
            self.model.set_metadata_keys(first['metadata_keys'])
        return self.model.run_train_multi(batches)

    def set_epoch(self, epoch):
        self.model_epoch = epoch
        self.model.set_epoch(epoch)

    def set_metadata_keys(self, keys):
        self.model.set_metadata_keys(keys)

    def net_run_and_process(self, lr=None, hr=None, metadata=None, metadata_keys=None,
                            request_loss=False, timing=False, **kwargs):
        """The model's forward and its colorspace post-processing (ref:
        models/__init__.py:138-156): (RGB output, YCbCr output, loss or None, runtime or
        None), NHWC float32 numpy arrays clipped to [0, 1].  Y-channel models take
        and return the Y channel, recombined with the input's chroma."""
        if metadata_keys is not None and self.model.metadata_keys is None:
            self.model.set_metadata_keys(metadata_keys)
        if 'rgb' in self.configuration['colorspace']:
            out_rgb, loss, runtime = self.model.run_eval(
                lr, hr, request_loss=request_loss, metadata=metadata, timing=timing)
            out_ycbcr = self.colorspace_convert(out_rgb, colorspace='rgb')
            out_rgb = self._standard_image_formatting(out_rgb)
        else:
            f_ref = None if hr is None else hr[..., :1]
            out_y, loss, runtime = self.model.run_eval(
                lr[..., :1], f_ref, request_loss=request_loss, metadata=metadata,
                timing=timing)
            out_ycbcr = np.concatenate([out_y, np.asarray(lr[..., 1:], np.float32)], axis=-1)
            out_rgb = self.colorspace_convert(out_ycbcr, colorspace='ycbcr')
            out_ycbcr = self._standard_image_formatting(out_ycbcr)
        return out_rgb, out_ycbcr, loss, runtime

    @staticmethod
    def colorspace_convert(image, colorspace='rgb'):
        """NHWC batch conversion from ``colorspace`` ('rgb' or 'ycbcr') to the other,
        the JPEG matrices, with [0, 1] clipping before (ref:
        models/__init__.py:158-163)."""
        processed = ModelInterface._standard_image_formatting(np.asarray(image))
        out = np.empty_like(processed)
        for i in range(processed.shape[0]):
            conv = ycbcr_convert(processed[i].transpose(2, 0, 1), im_type='jpg',
                                 input=colorspace, y_only=False)
            out[i] = conv.transpose(1, 2, 0)
        return out

    @staticmethod
    def _standard_image_formatting(im, min_value=0, max_value=1):
        """A float copy of ``im`` clipped to [min_value, max_value]."""
        return np.clip(np.array(im, copy=True), min_value, max_value)

    def get_learning_rate(self):
        return self.model.get_learning_rate()

    def epoch_end_calls(self):
        self.model.epoch_end_calls()

    def wait_pending_checkpoints(self, timeout=None):
        """Fence for background checkpoint writes (see BaseHandler.save_model)."""
        self.model.wait_pending_checkpoints(timeout=timeout)

    # --- persistence ----------------------------------------------------------------------
    def save(self, name='train_model', override=False, dry_run=False):
        """Save the current epoch's checkpoint; refuse to overwrite one (on disk or
        still being written) unless ``override``.  ``dry_run`` only checks."""
        save_path = os.path.join(self.saved_models, '%s_%s' % (name, self.model_epoch))
        if (os.path.exists(save_path) or save_path in WRITER.pending_paths) \
                and not override:
            raise RuntimeError('Saving this model will result in overwriting existing '
                               'data!  Change model location or enable override.')
        if dry_run:
            print('Training cleared to run.')
            return
        self.model.save_model(model_save_name=name, model_idx=self.model_epoch,
                              model_save_dir=self.saved_models, background=True)

    def save_metadata(self):
        md = pd.DataFrame.from_dict({'model_parameters': [self.model.print_parameters()]})
        md.to_csv(os.path.join(self.base_folder, 'extra_metadata.csv'), index=False)

    def print_overview(self):
        """(ref: models/__init__.py:195-223)"""
        device = self.model.device
        name = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host CPU'
        if self.mode == 'eval':
            mode, epoch, message = 'eval', self.model_epoch, 'currently evaluating'
        else:
            mode, message = 'train', 'will start training from'
            epoch = self.model_epoch if self.model_epoch == 0 else self.model_epoch + 1
        print('----------------------------')
        print('Handler for experiment %s initialized successfully.' % self.experiment)
        print('System loaded in %s mode - %s architecture provided.' % (mode, self.name))
        print('Model has %d trainable parameters.' % self.model.print_parameters())
        print("Using %s (%s) as the model's primary device, and %s epoch %d of the model."
              % (device, name, message, epoch))
        print('----------------------------')
