"""Directory checkpoints: the counterpart of sisr_tpu's ``utils/orbax_ckpt.py``.  No
orbax is involved: the directory holds ``torch.save`` files.

``checkpoint_backend = "orbax"`` in ``[model.internal_params]`` makes the handler save
each epoch as a directory at the file checkpoint's path (``saved_models/train_model_<N>/``):

* ``network.pt``: the module's state_dict;
* ``optimizer.pt``: Adam's state_dict (training handlers);
* ``handler_meta.json``: ``model_name``, ``model_epoch`` and ``step``.

The directory is written in a dot-prefixed staging sibling and renamed into place, so a
crash never leaves a half-written directory under the checkpoint's name; whatever held
the name before (a directory, or a file checkpoint of the same epoch) is moved aside
first and removed after.  ``load_model`` reads a file or a directory, whichever is at the
path.  sisr_tpu's own orbax directories (a ``tree/`` of zarr arrays) are not readable
here: :func:`restore_dir` names the route that works.
"""
import json
import os

import torch

from .async_ckpt import remove_path, replace_atomically, sweep_stale_tmp

_META_NAME = 'handler_meta.json'
_TENSOR_KEYS = ('network', 'optimizer')
_SISR_TPU_TREE = 'tree'  # sisr_tpu's orbax PyTreeCheckpointer directory


def save_dir(path, state_dict):
    """Write a handler state dict (``BaseHandler.save_model``'s: ``network``, optionally
    ``optimizer``, ``model_name``, ``model_epoch``, ``step``) as a checkpoint directory
    at ``path``."""
    path = os.path.abspath(path)
    head, base = os.path.split(path)
    sweep_stale_tmp(head, base)
    staging = os.path.join(head, '.tmp-%d-%s' % (os.getpid(), base))
    remove_path(staging)
    os.makedirs(staging)
    for key in _TENSOR_KEYS:
        if key in state_dict:
            with open(os.path.join(staging, key + '.pt'), 'wb') as f:
                torch.save(state_dict[key], f)
                f.flush()
                os.fsync(f.fileno())
    meta = {'model_name': state_dict['model_name'],
            'model_epoch': int(state_dict['model_epoch']), 'step': int(state_dict['step'])}
    with open(os.path.join(staging, _META_NAME), 'w') as f:
        json.dump(meta, f)
    replace_atomically(staging, path)


def restore_dir(path):
    """The state dict a :func:`save_dir` directory holds (tensors on the CPU)."""
    if os.path.isdir(os.path.join(path, _SISR_TPU_TREE)):
        raise RuntimeError(
            '%s is an orbax checkpoint directory written by sisr_tpu, which sisr_tpu_torch '
            'cannot read. Save that epoch with sisr_tpu\'s default msgpack backend '
            '(checkpoint_backend = "msgpack") and carry its "network" tree across with the '
            'weights bridge, sisr_tpu_torch.tools.convert_weights.state_dict_from_jax.'
            % path)
    with open(os.path.join(path, _META_NAME)) as f:
        state = json.load(f)
    for key in _TENSOR_KEYS:
        file = os.path.join(path, key + '.pt')
        if os.path.isfile(file):
            state[key] = torch.load(file, map_location='cpu', weights_only=True)
    return state
