"""Model handlers: config-name -> nn.Module + eval semantics (PyTorch port of the eval
subset of sisr_tpu's ``models/handlers.py``).

Each handler is registered under the reference's lowercase model name and owns:

* the module, its device and compute type (``dtype='bf16'`` is ``torch.autocast`` to
  bfloat16 around float32 parameters; activations are channels_last);
* parameter initialisation from a seeded ``torch.Generator``;
* the fused eval step: forward + bicubic LR baseline + YCbCr Y + PSNR/SSIM on the
  device, with only a (K, N) metric matrix for the host;
* degradation metadata (``uses_metadata`` handlers, :class:`QHandler`): the
  dataset's metadata key list selects the columns the model takes
  (``set_metadata_keys``), and each batch's (N, M) metadata reaches the module
  through ``prepare_metadata``;
* int8 serving (``set_int8``): quantised weights and activation scales calibrated on
  the first eval batch, and the int8 program of ``ops/quantization.py`` in place of
  the module in the fused step;
* checkpoints in the reference's file contract (``saved_models/train_model_<N>``, a
  ``torch.save`` dict with ``network``, ``model_name``, ``model_epoch``, ``step``).
"""
import math
import os
import time

import numpy as np
import torch

from ..ops import quantization as qz
from ..ops.colorspace import rgb_to_ycbcr_nhwc
from ..ops.metrics import psnr_nhw, ssim_nhw
from ..ops.resize import resize_bicubic
from ..tools.convert_weights import params_from_state_dict
from ..utils.helpers import resolve_device
from . import advanced, qmodels
from .blocks import torch_default_init_

available_models = {}
# int8 families whose program is ported; sisr_tpu's others raise in set_int8
_INT8_PROGRAMS = ('rcan',)


def _int8_not_ported(what, slice_name):
    return NotImplementedError('%s for int8 serving is not ported to sisr_tpu_torch yet: '
                               'it comes with the %s slice (ROADMAP.md, Queue 1).'
                               % (what, slice_name))


def _tree_to(tree, device):
    """A nested dict of tensors with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


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

    colorspace = 'rgb'
    im_input = 'unmodified'
    tiled_eval = False
    uses_metadata = False
    # int8 serving path (ops/quantization.py): family key, or None if unsupported
    int8_family = None

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
        self.metadata_keys = None
        self.meta_indices = None
        self._eval_step_cache = {}
        self._warm_eval_shapes = set()
        self.int8_mode = False  # int8 serving (set_int8)
        self.int8_residual_dtype = 'bfloat16'
        self._int8_ctx = None  # (program, quantised params, scales) once calibrated
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

    # --- metadata plumbing (ref handlers.py:152-171, 390-398) ------------------------------
    def set_metadata_keys(self, keys):
        """Select the metadata columns the model takes from the dataset's key list
        (ref: attention_manipulators/__init__.py:30-51 mask logic): those named in the
        handler's ``metadata`` config, every one for 'all', the only one if there is
        one."""
        self.metadata_keys = list(keys or [])
        meta_cfg = getattr(self, 'metadata', None)
        if not self.uses_metadata or meta_cfg is None:
            self.meta_indices = None
            return
        if 'all' in meta_cfg:
            mask = [True] * len(self.metadata_keys)
        else:
            mask = [k in meta_cfg for k in self.metadata_keys]
        if len(self.metadata_keys) == 1:
            mask = [True]
        self.meta_indices = np.where(np.array(mask))[0]

    def prepare_metadata(self, x, metadata):
        """(N, M_total) batch metadata -> the module's metadata input in x's dtype (or
        None for a model that takes none)."""
        if not self.uses_metadata:
            return None
        if metadata is None or metadata.dim() != 2:
            raise RuntimeError('Metadata needs to be specified for this network to run: '
                               'an (N, M) batch from a degradation_metadata.csv or '
                               'qpi_slices.csv beside the LR images, or --metadata_file.')
        if self.meta_indices is not None and len(self.meta_indices) != metadata.shape[-1]:
            metadata = metadata[:, self.meta_indices.tolist()]
        return metadata.to(x.dtype)

    def _metadata_width(self, n_meta):
        """Width of the module's metadata input for ``n_meta`` selected columns."""
        return n_meta

    # --- forward --------------------------------------------------------------------------
    def _prep_batch(self, batch):
        """(lr, hr, metadata): uint8 transport, the /255 on the device (ref
        handlers.py:415), and the module's metadata input (None without)."""
        def as_f32(img):
            return img.float() / 255.0 if img is not None and img.dtype == torch.uint8 \
                else img
        lr = as_f32(batch['lr'])
        metadata = self.prepare_metadata(lr, batch.get('metadata'))
        if metadata is not None and \
                metadata.shape[-1] != self._metadata_width(self.num_metadata):
            raise ValueError('%s takes %d metadata values per image, the batch has %d '
                             '(selected columns of %s)'
                             % (type(self).__name__, self._metadata_width(self.num_metadata),
                                metadata.shape[-1], self.metadata_keys))
        return lr, as_f32(batch.get('hr')), metadata

    def forward(self, x, metadata=None):
        """Model output for an NHWC float batch (and the module's (N, M) metadata for a
        metadata model), as NHWC.  A contiguous NHWC tensor permuted to NCHW is
        channels_last, the layout the convs and the channel attention kernel take."""
        args = (metadata,) if self.uses_metadata else ()
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            out = self.module(x.permute(0, 3, 1, 2), *args)
        return out.permute(0, 2, 3, 1)

    # --- int8 serving (ref handlers.py:202-292) --------------------------------------------
    def set_int8(self, enabled=True, residual_dtype='bfloat16'):
        """Turn the int8 serving path on or off: per-channel int8 weights, static
        activation scales calibrated (absmax, 10% margin) on the first eval batch, a
        narrow residual carry ('bfloat16' or 'float32').  Metrics are then computed on
        the quantised output."""
        if enabled and self.int8_family is None:
            print('%s: no int8 serving path for this architecture — ignoring.'
                  % type(self).__name__)
            return
        if enabled and self.int8_family not in _INT8_PROGRAMS:
            raise _int8_not_ported('The %s program' % self.int8_family,
                                   'EDSR and Q-RCAN int8')
        if residual_dtype not in ('float32', 'bfloat16'):
            raise ValueError("residual_dtype must be 'float32' or 'bfloat16' (the int16 "
                             "carry is EDSR-only), got %r" % (residual_dtype,))
        self.int8_mode = bool(enabled)
        self.int8_residual_dtype = residual_dtype
        self._int8_ctx = None
        self._eval_step_cache = {}
        self._warm_eval_shapes = set()

    def _int8_calibration_input(self, lr_f32):
        """The calibration input, matching what the int8 program takes: for RGB
        models that take the LR image as it is, the f32 LR batch itself."""
        if self.im_input == 'interp' or self.colorspace != 'rgb':
            raise _int8_not_ported('Calibrating pre-upscaled or Y-channel inputs',
                                   'remaining families')
        if self.tiled_eval:
            raise _int8_not_ported('Tile-sized calibration crops', 'remaining families')
        return lr_f32

    def _ensure_int8_ctx(self, x):
        """Quantise the weights and calibrate the activation scales on ``x`` (the
        first batch), once; the program then runs with them."""
        if self._int8_ctx is not None:
            return
        params = params_from_state_dict(self.model_name, self.module.state_dict())
        if self.int8_family == 'rcan':
            m = self.module
            qp = qz.quantize_rcan_params(params, m.n_resgroups, m.n_resblocks)
            scales = qz.calibrate_rcan_scales(params, [x], m.n_resgroups, m.n_resblocks,
                                              margin=1.1)
        else:
            raise RuntimeError('unknown int8 family %r' % self.int8_family)
        self.load_int8_state(qp, scales)

    def load_int8_state(self, qparams, act_scales):
        """Run the int8 program with these quantised parameters and scales (from
        :meth:`_ensure_int8_ctx`, or from sisr_tpu through
        ``tools.convert_weights.int8_state_from_jax``), moved to this handler's
        device."""
        qparams = _tree_to(qparams, self.device)
        dev_scales = qz.scales_on(act_scales, self.device)
        if self.int8_family == 'rcan':
            m, rd = self.module, self.int8_residual_dtype

            def program(x):
                return qz.rcan_int8_forward_static(qparams, dev_scales, x, m.n_resgroups,
                                                   m.n_resblocks, residual_dtype=rd)
        else:
            raise RuntimeError('unknown int8 family %r' % self.int8_family)
        self._int8_ctx = (program, qparams, dict(act_scales))

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
        meta = batch.get('metadata') if self.uses_metadata else None
        if isinstance(batch['lr'], (list, tuple)):
            # ragged batch (mixed-size eval images at bs>1): run per image, each with
            # its own metadata row
            parts, total = [], 0.0
            for i, (lr, hr) in enumerate(zip(batch['lr'], batch['hr'])):
                one = {'lr': lr[None], 'hr': hr[None],
                       'metadata': None if meta is None else meta[i:i + 1]}
                (_, vals), rt = self.run_eval_fused(one, metrics=metrics, timing=timing,
                                                    include_lr=include_lr)
                parts.append(vals)
                total += rt or 0.0
            return (keys, torch.cat(parts, dim=1)), (total if timing else None)

        dev_batch = {'lr': self._to_device(self._as_u8_if_lossless(batch['lr'])),
                     'hr': self._to_device(self._as_u8_if_lossless(batch['hr']))}
        if meta is not None:
            dev_batch['metadata'] = self._to_device(meta).float()
        if self.int8_mode and self._int8_ctx is None:
            # calibrate outside the step, on the input the int8 program takes
            self._ensure_int8_ctx(self._int8_calibration_input(
                self._prep_batch(dev_batch)[0]))
        key = ('fused', tuple(metrics), include_lr, self.int8_mode)
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
            lr, hr, metadata = self._prep_batch(batch)
            hr_y = prep_y(hr)
            lr_y = None
            if include_lr:
                # device bicubic stands in for the host PIL prep (same filter
                # weights; <=1 uint8 LSB fixed-point difference)
                lr_y = prep_y(resize_bicubic(lr, hr.shape[1], hr.shape[2]))
            # the calibrated int8 program when int8 serving is on, else the module
            sr = self._int8_ctx[0](lr) if self.int8_mode else self.forward(lr, metadata)
            sr_y = prep_y(sr)
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
        if self._int8_ctx is not None or self.int8_mode:
            # the quantised weights came from the replaced parameters: requantise and
            # recalibrate on the next eval batch
            self._int8_ctx = None
            self._eval_step_cache = {}
        self.step = int(state_dict.get('step', 0))
        self.set_epoch(int(state_dict['model_epoch']))
        print('Loaded model uses the following architecture:', state_dict['model_name'])
        return state_dict


@register_model('rcan')
class RCANHandler(BaseHandler):
    """(ref: advanced/handlers.py:26-39).  The reference locks the size parameters;
    we accept them as an optional superset (defaults identical)."""

    int8_family = 'rcan'

    def build_module(self, scale, in_features=3, n_resblocks=20, n_resgroups=10, n_feats=64,
                     reduction=16, **kwargs):
        return advanced.RCAN(scale=scale, in_feats=in_features or 3,
                             n_resblocks=n_resblocks or 20, n_resgroups=n_resgroups or 10,
                             n_feats=n_feats or 64, reduction=reduction or 16)


class QHandler(BaseHandler):
    """Metadata bookkeeping shared by the meta-models (ref QModel,
    attention_manipulators/__init__.py:6-27): ``metadata`` names the columns the
    model takes ('qpi' by default; 'blur_kernel' is 10 values, 'all' adds the 39
    CelebA attributes)."""

    uses_metadata = True

    def __init__(self, metadata=None, **kwargs):
        if metadata is not None:
            self.num_metadata = len(metadata)
            if 'all' in metadata:
                self.num_metadata += 39  # all celeba attributes
            if 'blur_kernel' in metadata:
                self.num_metadata += 9
            elif 'unmodified_blur_kernel' in metadata:
                self.num_metadata += 440
            self.metadata = metadata
        else:
            self.metadata = ['qpi']
            self.num_metadata = 1
        super().__init__(**kwargs)


@register_model('edsr')
class EDSRHandler(BaseHandler):
    """(ref: advanced/handlers.py:7-23)"""

    int8_family = 'edsr'

    def build_module(self, scale, in_features=3, num_features=64, num_blocks=16,
                     res_scale=0.1, **kwargs):
        return advanced.EDSR(net_features=num_features or 64, num_blocks=num_blocks or 16,
                             scale=scale, res_scale=res_scale if res_scale is not None
                             else 0.1, in_features=in_features or 3)


@register_model('qrcan', 'qpircan')
class QRCANHandler(QHandler):
    """(ref: attention_manipulators/handlers.py:7-54).  'qpircan' legacy alias
    (ref: models/__init__.py:92-93).  The 'modulate' style takes the normalised QPI
    expanded to an n_feats vector (:meth:`scale_qpi`)."""

    colorspace = 'augmented_rgb'
    int8_family = 'qrcan'

    def __init__(self, style='modulate', clamp=False, min_mu=-0.2, max_mu=0.8, n_feats=64,
                 **kwargs):
        self.style = style or 'modulate'
        self.clamp = clamp
        self.min_mu = min_mu if min_mu is not None else -0.2
        self.max_mu = max_mu if max_mu is not None else 0.8
        self.n_feats = n_feats or 64
        super().__init__(**kwargs)

    def build_module(self, scale, in_features=3, include_pixel_attention=False,
                     include_q_layer=False, selective_meta_blocks=None,
                     num_q_layers_inner_residual=None, n_resblocks=20, n_resgroups=10,
                     reduction=16, **kwargs):
        return qmodels.QRCAN(
            n_resblocks=n_resblocks or 20, n_resgroups=n_resgroups or 10,
            n_feats=self.n_feats, in_feats=in_features or 3, scale=scale,
            reduction=reduction or 16, style=self.style, num_metadata=self.num_metadata,
            include_pixel_attention=bool(include_pixel_attention),
            include_q_layer=bool(include_q_layer),
            selective_meta_blocks=selective_meta_blocks,
            num_q_layers_inner_residual=num_q_layers_inner_residual)

    def _metadata_width(self, n_meta):
        return self.n_feats if self.style == 'modulate' else n_meta

    def prepare_metadata(self, x, metadata):
        meta = super().prepare_metadata(x, metadata)
        if self.style == 'modulate':
            meta = self.scale_qpi(meta)
        return meta

    def scale_qpi(self, qpi):
        """Gaussian-profile expansion of the normalised QPI (its first column) to an
        n_feats modulation vector (ref: attention_manipulators/handlers.py:42-54)."""
        sig = 0.2
        base = torch.linspace(0.0, 1.0, self.n_feats, dtype=qpi.dtype, device=qpi.device)
        mu = qpi[:, :1] * (self.max_mu - self.min_mu) + self.min_mu  # (N, 1)
        prof = (1.0 / (math.sqrt(2 * math.pi) * sig)) * torch.exp(
            -torch.square(base[None, :] - mu) / (2 * sig ** 2))
        if self.clamp:
            prof = torch.clamp(prof, 0.0, 1.0)
        return prof
