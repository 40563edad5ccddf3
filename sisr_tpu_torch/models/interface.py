"""Client-side model interface, eval mode: experiment directories and checkpoint
selection (PyTorch port of sisr_tpu's ``models/interface.py``, ref:
Code/SISR/models/__init__.py:33-254 ModelInterface)."""
import glob
import os

import pandas as pd
import torch

from ..utils import toml_io
from .handlers import define_model


class ModelInterface:
    """Loads experiment ``model_loc/experiment`` at ``load_epoch`` (an epoch number,
    'best' or 'last') onto ``device`` (default: cuda)."""

    def __init__(self, model_loc, experiment, load_epoch, device=None, scale=None):
        self.experiment = experiment
        self.base_folder = os.path.abspath(os.path.join(model_loc, experiment))
        self.logs = os.path.join(self.base_folder, 'result_outputs')
        self.saved_models = os.path.join(self.base_folder, 'saved_models')

        config_path = os.path.join(self.base_folder, 'config.toml')
        if not os.path.isfile(config_path):
            # resumed runs write config_from_epoch_N.toml: fall back to the newest
            snapshots = sorted(glob.glob(os.path.join(self.base_folder, 'config*.toml')),
                               key=os.path.getmtime)
            if not snapshots:
                raise RuntimeError('No config.toml found in %s - model structure '
                                   'unknown.' % self.base_folder)
            config_path = snapshots[-1]
        self.metadata = toml_io.load(config_path)['model']
        self.name = self.metadata['name']

        internal = dict(self.metadata.get('internal_params') or {})
        if scale is not None:
            if internal.get('scale') is None:
                internal['scale'] = scale  # config omitted it: honor the request
            elif scale != internal['scale']:
                raise Exception('The model loaded has been trained for a different '
                                'scale, and cannot produce the requested images.')
        internal.pop('metadata_list', None)
        self.model = define_model(name=self.name, device=device, **internal)

        if load_epoch in ('best', 'last'):
            load_epoch = self._resolve_epoch(load_epoch)
        self.model_epoch = load_epoch
        self.model.load_model(model_save_name='train_model', model_idx=load_epoch,
                              model_save_dir=self.saved_models)

        self.print_overview()

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

    def print_overview(self):
        """(ref: models/__init__.py:195-223)"""
        device = self.model.device
        name = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host CPU'
        print('----------------------------')
        print('Handler for experiment %s initialized successfully.' % self.experiment)
        print('System loaded in eval mode - %s architecture provided.' % self.name)
        print('Model has %d trainable parameters.' % self.model.print_parameters())
        print("Using %s (%s) as the model's primary device, and currently evaluating "
              "epoch %d of the model." % (device, name, self.model_epoch))
        print('----------------------------')

