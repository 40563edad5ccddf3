"""Model handlers: config-name -> nn.Module + eval semantics (PyTorch port of the eval
subset of sisr_tpu's ``models/handlers.py``).

Each handler is registered under the reference's lowercase model name and owns:

* the module, its device and compute type (``dtype='bf16'`` is ``torch.autocast`` to
  bfloat16 around float32 parameters; activations are channels_last);
* parameter initialisation from a seeded ``torch.Generator``;
* the fused eval step: forward + bicubic LR baseline + YCbCr Y + PSNR/SSIM on the
  device, with only a (K, N) metric matrix for the host;
* checkpoints in the reference's file contract (``saved_models/train_model_<N>``, a
  ``torch.save`` dict with ``network``, ``model_name``, ``model_epoch``, ``step``).
"""
import os
import time

import numpy as np
import torch

from ..ops.colorspace import rgb_to_ycbcr_nhwc
from ..ops.metrics import psnr_nhw, ssim_nhw
from ..ops.resize import resize_bicubic
from ..utils.helpers import resolve_device
from . import advanced
from .blocks import torch_default_init_

available_models = {}


def register_model(name, *aliases):
    def wrap(cls):
        available_models[name] = cls
        for alias in aliases:
            available_models[alias] = cls
        cls.model_name = name
        return cls
    return wrap


def define_model(name, **kwargs):
    """Registry lookup (ref: models/__init__.py:225-227)."""
    if name not in available_models:
        raise KeyError('Unknown model %r; available in sisr_tpu_torch: %s (other families '
                       'are not ported yet, see ROADMAP.md)' % (name, sorted(available_models)))
    return available_models[name](**kwargs)


class BaseHandler:
    """Eval-side handler base (ref BaseModel, models/__init__.py:257-575) for RGB
    models that take the LR image as it is."""

    def __init__(self, scale=4, dtype=None, seed=8, device=None, **kwargs):
        """``kwargs`` are the model's structure parameters; keys that only training
        reads (lr, scheduler, ...) are ignored here, as in the reference's eval mode."""
        self.scale = scale
        self.seed = seed
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if dtype in ('bf16', 'bfloat16') else torch.float32
        self.curr_epoch = 0
        self.step = 0
        self.module = self.build_module(scale=scale, **kwargs)
        self._eval_step_cache = {}
        self._warm_eval_shapes = set()
        self.init_state()

    def build_module(self, scale, **kwargs):
        raise NotImplementedError

    # --- state management -----------------------------------------------------------------
    def init_state(self):
        """Draw the parameters from ``torch.Generator().manual_seed(seed)`` (torch's
        default Conv2d scheme) and place the module on the handler's device."""
        self.module.to('cpu')
        torch_default_init_(self.module, torch.Generator().manual_seed(self.seed))
        self._place()

    def _place(self):
        self.module.to(device=self.device, memory_format=torch.channels_last).eval()

    def _synchronize(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def print_parameters(self):
        return sum(p.numel() for p in self.module.parameters())

    def set_epoch(self, epoch):
        self.curr_epoch = epoch

    # --- forward --------------------------------------------------------------------------
    def _prep_batch(self, batch):
        """uint8 transport: the /255 happens on the device (ref handlers.py:415)."""
        def as_f32(img):
            return img.float() / 255.0 if img is not None and img.dtype == torch.uint8 \
                else img
        return as_f32(batch['lr']), as_f32(batch.get('hr'))

    def forward(self, x):
        """Model output for an NHWC float batch, as NHWC.  A contiguous NHWC tensor
        permuted to NCHW is channels_last, the layout the convs and the channel
        attention kernel take."""
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            out = self.module(x.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1)

    # --- fused eval -----------------------------------------------------------------------
    def _to_device(self, img):
        if isinstance(img, torch.Tensor):
            return img.to(self.device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    @staticmethod
    def _as_u8_if_lossless(img):
        """uint8 transport when lossless (file-decoded images), f32 otherwise."""
        if isinstance(img, torch.Tensor) or getattr(img, 'dtype', None) == np.uint8:
            return img  # already on the device, or dataset keep_uint8 passthrough
        img = np.asarray(img, np.float32)
        u8 = np.rint(img * 255).astype(np.uint8)
        return u8 if np.abs(u8.astype(np.float32) / 255.0 - img).max() <= 1e-6 else img

    def run_eval_fused(self, batch, metrics=('PSNR', 'SSIM'), timing=False, include_lr=True):
        """Eval fast path (ref handlers.py:724): one device step runs forward + bicubic
        LR baseline + YCbCr + PSNR/SSIM, and only per-image scalars stay for the host.

        Without ``timing`` the returned (K, N) metric matrix is still being computed
        when this returns (CUDA runs asynchronously); copy it to the host to wait.

        :return: ((keys, values): keys a K-tuple like ('LR>PSNR', 'model>PSNR', ...)
            and values the matching (K, N) float32 device tensor, runtime seconds or
            None).  ``include_lr=False`` omits the LR-baseline rows.
        """
        sides = ('LR', 'model') if include_lr else ('model',)
        keys = tuple('%s>%s' % (side, met) for met in metrics for side in sides)
        if isinstance(batch['lr'], (list, tuple)):
            # ragged batch (mixed-size eval images at bs>1): run per image
            parts, total = [], 0.0
            for lr, hr in zip(batch['lr'], batch['hr']):
                (_, vals), rt = self.run_eval_fused({'lr': lr[None], 'hr': hr[None]},
                                                    metrics=metrics, timing=timing,
                                                    include_lr=include_lr)
                parts.append(vals)
                total += rt or 0.0
            return (keys, torch.cat(parts, dim=1)), (total if timing else None)

        dev_batch = {'lr': self._to_device(self._as_u8_if_lossless(batch['lr'])),
                     'hr': self._to_device(self._as_u8_if_lossless(batch['hr']))}
        key = ('fused', tuple(metrics), include_lr)
        if key not in self._eval_step_cache:
            self._eval_step_cache[key] = self._make_fused_step(tuple(metrics), include_lr)
        step = self._eval_step_cache[key]
        runtime = None
        if timing:
            # exclude first-call set-up (cuDNN heuristics, kernel builds) once per shape
            warm_key = key + (tuple(dev_batch['lr'].shape),)
            if warm_key not in self._warm_eval_shapes:
                step(dev_batch)
                self._warm_eval_shapes.add(warm_key)
            self._synchronize()
            tic = time.perf_counter()
            out = step(dev_batch)
            self._synchronize()
            runtime = time.perf_counter() - tic
        else:
            out = step(dev_batch)
        return (keys, out), runtime

    def _make_fused_step(self, metrics, include_lr=True):
        """(ref handlers.py:835) The per-batch device program as one function."""
        fns = {'PSNR': lambda a, b: psnr_nhw(a, b, 1.0),
               'SSIM': lambda a, b: ssim_nhw(a, b, 1.0)}

        def prep_y(img):  # as sisr_tpu's EvalHub._high_res_prep: clip + Y ('jpg')
            img = img.float().clamp(0.0, 1.0)
            return rgb_to_ycbcr_nhwc(img, y_only=True, im_type='jpg')[..., 0]

        @torch.inference_mode()
        def step(batch):
            lr, hr = self._prep_batch(batch)
            hr_y = prep_y(hr)
            lr_y = None
            if include_lr:
                # device bicubic stands in for the host PIL prep (same filter
                # weights; <=1 uint8 LSB fixed-point difference)
                lr_y = prep_y(resize_bicubic(lr, hr.shape[1], hr.shape[2]))
            sr_y = prep_y(self.forward(lr))
            rows = []
            for met in metrics:  # row order matches run_eval_fused's keys tuple
                if include_lr:
                    rows.append(fns[met](lr_y, hr_y))
                rows.append(fns[met](sr_y, hr_y))
            return torch.stack(rows)

        return step

    # --- checkpointing (ref: models/__init__.py:349-464) -----------------------------------
    def save_model(self, model_save_name, model_idx, model_save_dir):
        state_dict = {
            'network': {k: v.detach().cpu() for k, v in self.module.state_dict().items()},
            'model_name': self.model_name,
            'model_epoch': int(self.curr_epoch),
            'step': int(self.step),
        }
        path = os.path.join(model_save_dir, '%s_%s' % (model_save_name, model_idx))
        tmp = '%s.%d.tmp' % (path, os.getpid())
        with open(tmp, 'wb') as f:
            torch.save(state_dict, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load_model(self, model_save_name, model_idx, model_save_dir):
        path = os.path.join(model_save_dir, '%s_%s' % (model_save_name, model_idx))
        state_dict = torch.load(path, map_location='cpu', weights_only=True)
        self.module.load_state_dict(state_dict['network'])  # strict: layouts must match
        self._place()
        self.step = int(state_dict.get('step', 0))
        self.set_epoch(int(state_dict['model_epoch']))
        print('Loaded model uses the following architecture:', state_dict['model_name'])
        return state_dict


@register_model('rcan')
class RCANHandler(BaseHandler):
    """(ref: advanced/handlers.py:26-39).  The reference locks the size parameters;
    we accept them as an optional superset (defaults identical)."""

    def build_module(self, scale, in_features=3, n_resblocks=20, n_resgroups=10, n_feats=64,
                     reduction=16, **kwargs):
        return advanced.RCAN(scale=scale, in_feats=in_features or 3,
                             n_resblocks=n_resblocks or 20, n_resgroups=n_resgroups or 10,
                             n_feats=n_feats or 64, reduction=reduction or 16)
