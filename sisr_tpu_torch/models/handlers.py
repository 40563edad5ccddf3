"""Model handlers: config-name -> nn.Module + eval and training semantics (PyTorch
port of sisr_tpu's ``models/handlers.py``).

Each handler is registered under the reference's lowercase model name and owns:

* the module, its device and compute type (``dtype='bf16'`` is ``torch.autocast`` to
  bfloat16 around float32 parameters, for eval; activations are channels_last);
* parameter initialisation from a seeded ``torch.Generator``;
* training: the Adam optimizer with its per-step lr schedule, optional global-norm
  clipping and the loss (``training/``; with ``perceptual`` and ``vgg_weights`` the
  VGG54 term on a frozen VGG19, training handlers only), and the train step
  (:meth:`run_train`, :meth:`run_train_multi`): prep, forward, loss, backward, clip,
  Adam step;
* the fused eval step: forward + bicubic LR baseline + YCbCr Y + PSNR/SSIM (and the
  loss, for the training-time validation) on the device, with only a (K, N) metric
  matrix for the host;
* the standard eval step (:meth:`run_eval`): the SR image (and the loss) for the
  host, through the module, the int8 program, with ``set_eval_buckets`` the
  zero-padded, mask-exact bucketed forward (``ops/masking.py``), or for a
  ``tiled_eval`` family (SAN, Q-SAN) the static tile grid (:meth:`_tiled_forward`),
  which the fused step runs too;
* pre-upscaled inputs (``im_input = 'interp'``: SPARNet, Q-SPARNet, SRCNN, VDSR): the
  fused step feeds the module the device bicubic of the RGB LR at HR size, the tensor
  that also gives the LR baseline, and a Y-channel (``colorspace = 'ycbcr'``: SRCNN,
  VDSR) module its Y channel, reading the output as Y; the standard protocol and the
  training data hand these families their input already upscaled;
* degradation metadata (``uses_metadata`` handlers, :class:`QHandler`): the
  dataset's metadata key list selects the columns the model takes
  (``set_metadata_keys``), and each batch's (N, M) metadata reaches the module
  through ``prepare_metadata``; a ``channel_concat`` handler (SRMD, SFTMD with
  ``concat_strategy``) broadcasts it to per-pixel maps and concatenates them onto
  the LR image in :meth:`_prep_batch`, the one place every path builds the module's
  input;
* int8 serving (``set_int8``): quantised weights and activation scales calibrated on
  the first eval batch (with its prepared metadata, for a metadata model), and the
  int8 program of ``ops/quantization.py`` in place of the module in the fused step;
* bf16 training (``dtype = 'bf16'``): the train step's forward under the same autocast,
  the parameters, their grads and Adam's moments in float32 (sisr_tpu's flax
  ``param_dtype``);
* online degradation in the train step (:meth:`set_device_degrade`): the batch's LR
  made on the device from its HR crops and blur kernels (``ops/degradations.py``);
* data parallelism over the ranks of a process group (:meth:`set_mesh`, sisr_tpu's
  mesh): each rank's slice of a batch, the train step's forward through
  ``DistributedDataParallel`` (gradients averaged before the clip, the loss the global
  mean), eval outputs and metric rows gathered in rank order, the tile grid's tiles
  shared out over the ranks, int8 calibrated on the whole first batch;
* checkpoints in the reference's file contract (``saved_models/train_model_<N>``, a
  ``torch.save`` dict with ``network``, ``optimizer``, ``step``, ``model_name``,
  ``model_epoch``) or, with ``checkpoint_backend = 'orbax'``, a directory at that path
  (``utils/orbax_ckpt.py``); ``checkpoint_dtype = 'bf16_moments'`` stores Adam's
  moments as bfloat16.  Written in the background during training
  (``utils/async_ckpt.py``).
"""
import math
import os
import time
import warnings

import numpy as np
import torch

from ..ops import quantization as qz
from ..ops.colorspace import rgb_to_ycbcr_nhwc, ycbcr_to_rgb_nhwc
from ..ops.degradations import degrade_batch_on_device
from ..ops.masking import apply_mask, conv_mask_hooks, spatial_masks
from ..ops.metrics import psnr_nhw, ssim_nhw
from ..ops.resize import resize_bicubic
from ..tools import profiling
from ..tools.convert_weights import params_from_state_dict, repair_reference_keys
from ..training.losses import build_loss
from ..training.state import apply_update, build_optimizer
from ..utils import async_ckpt, orbax_ckpt
from ..utils.helpers import resolve_device
from . import advanced, basic, qmodels, san, sftmd, sparnet
from .blocks import torch_default_init_
from .feature_extractors import load_vgg_extractor

available_models = {}
# sisr_tpu's int8 families, each with its program ported; set_int8 raises for another
_INT8_PROGRAMS = ('rcan', 'edsr', 'qrcan', 'qedsr', 'han', 'qhan', 'san', 'qsan', 'srmd',
                  'sftmd', 'vdsr')
# Families whose --int8 fused eval was measured slower than their bf16 one on the card
# below (chip_smoke.py: int8 img/s over bf16 img/s, 16 images of 128^2 -> 512^2,
# batch 8); set_int8 warns at the point of use.
INT8_CARD = 'NVIDIA H100 80GB HBM3, 700.00 W'
INT8_MEASURED_SLOWER = {'rcan': '0.41x', 'qrcan': '0.52x', 'edsr': '0.43x',
                        'qedsr': '0.26x', 'han': '0.43x', 'qhan': '0.51x',
                        'san': '0.36x', 'qsan': '0.45x', 'srmd': '0.63x', 'sftmd': '0.40x',
                        'vdsr': '0.19x'}


def _adam_updates(optimizer_state):
    """The updates an Adam ``state_dict`` has made (its largest per-parameter
    ``step``), 0 for none."""
    steps = [int(v['step']) for v in ((optimizer_state or {}).get('state') or {}).values()
             if 'step' in v]
    return max(steps, default=0)


def _as_f32(img):
    """uint8 transport divided on the device (ref handlers.py:415); anything else as
    it is."""
    return img.float() / 255.0 if img is not None and img.dtype == torch.uint8 else img


def _y_channel(img):
    """The Y channel ('jpg') of an NHWC RGB batch clipped to [0, 1], (N, H, W) f32: as
    sisr_tpu's EvalHub._high_res_prep."""
    img = img.float().clamp(0.0, 1.0)
    return rgb_to_ycbcr_nhwc(img, y_only=True, im_type='jpg')[..., 0]


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
    """Handler base (ref BaseModel, models/__init__.py:257-575) for RGB models that
    take the LR image as it is."""

    colorspace = 'rgb'
    im_input = 'unmodified'
    in_channels = 3
    # concatenate the metadata's per-pixel maps onto the network input (SRMD, SFTMD
    # with concat_strategy)
    channel_concat = False
    # the static tile grid for large eval images (SAN, Q-SAN: :meth:`_tiled_forward`)
    tiled_eval = False
    uses_metadata = False
    loss_type = 'l1'
    grad_clip = None
    # int8 serving path (ops/quantization.py): family key, or None if unsupported
    int8_family = None
    # exact bucketed eval holds for pure-conv models; sisr_tpu's spatial-softmax,
    # covariance-pooling and strided families set it False
    bucketed_eval_ok = True

    def __init__(self, eval_mode=False, lr=1e-4, scale=4, scheduler=None,
                 scheduler_params=None, perceptual=None, optimizer_params=None,
                 grad_clip=None, dtype=None, vgg_weights=None, seed=8, device=None,
                 checkpoint_backend='msgpack', async_checkpoint=True,
                 checkpoint_dtype='f32', max_combined_im_size=160000, **kwargs):
        """``kwargs`` are the model's structure parameters.  The training keys (lr,
        scheduler, optimizer_params, grad_clip; ref models/__init__.py:281-329) build
        the optimizer, schedule and loss.  ``checkpoint_backend`` 'msgpack' (sisr_tpu's
        name for its single-file checkpoint) is the torch file here, 'orbax' the
        directory of ``utils/orbax_ckpt.py``; ``checkpoint_dtype`` 'bf16_moments'
        writes Adam's moments as bfloat16.
        ``max_combined_im_size`` bounds the area of a tile of a ``tiled_eval`` family's
        grid (halo included)."""
        self.eval_mode = eval_mode
        self.max_combined_im_size = max_combined_im_size
        self.scale = scale
        self.seed = seed
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if dtype in ('bf16', 'bfloat16') else torch.float32
        if checkpoint_dtype not in ('f32', 'bf16_moments'):
            raise ValueError("checkpoint_dtype must be 'f32' or 'bf16_moments', got %r"
                             % (checkpoint_dtype,))
        if checkpoint_backend not in ('msgpack', 'orbax'):
            raise ValueError("checkpoint_backend must be 'msgpack' or 'orbax', got %r"
                             % (checkpoint_backend,))
        self.checkpoint_backend = checkpoint_backend
        self.checkpoint_dtype = checkpoint_dtype
        # background checkpoint writes (utils/async_ckpt.py); false writes at the call
        self.async_checkpoint = bool(async_checkpoint)
        if grad_clip == 0:  # explicit 0 disables clipping, incl. subclass defaults
            self.grad_clip = None  # (ref: models/__init__.py:281-284)
        elif grad_clip is not None:
            self.grad_clip = grad_clip
        self.curr_epoch = 0
        self.step = 0  # optimizer updates made: the schedule's argument
        self.module = self.build_module(scale=scale, **kwargs)
        self.metadata_keys = None
        self.meta_indices = None
        self._eval_step_cache = {}
        self._warm_eval_shapes = set()
        self.eval_buckets = None  # pad eval images to multiples of this (set_eval_buckets)
        self.device_degrade = False  # the train step makes the LR (set_device_degrade)
        self.int8_mode = False  # int8 serving (set_int8)
        self.int8_residual_dtype = 'bfloat16'
        self._int8_ctx = None  # (program, quantised params, scales) once calibrated
        self.mesh = None  # the process group's view (set_mesh)
        self._ddp = None  # DistributedDataParallel around the module, for the train step
        self.init_state()
        self.optimizer, self.schedule = build_optimizer(
            self.module.parameters(), lr, scheduler, scheduler_params, optimizer_params,
            fused=self.device.type == 'cuda')
        # the perceptual term wraps the criterion for training only (ref
        # models/__init__.py:334-342): the VGG19 trunk from ``vgg_weights``, frozen,
        # on this handler's device
        use_perceptual = perceptual if (perceptual is not None and not eval_mode) else None
        vgg_apply = load_vgg_extractor(vgg_weights, device=self.device) \
            if use_perceptual is not None else None
        self.loss_fn = build_loss(self.loss_type, use_perceptual, vgg_apply)

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
        """The module on the handler's device, every Conv2d weight channels_last (HAN's
        Conv3d keeps its own layout)."""
        self.module.to(self.device)
        for m in self.module.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.to(memory_format=torch.channels_last)

    def _set_training(self, mode):
        """``module.train()`` for the train step, ``.eval()`` for eval (no-op when
        already so: the call walks every submodule)."""
        if self.module.training != mode:
            self.module.train(mode)

    def _synchronize(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def print_parameters(self):
        return sum(p.numel() for p in self.module.parameters())

    def set_epoch(self, epoch):
        self.curr_epoch = epoch

    def get_learning_rate(self):
        """The lr of the next update."""
        return float(self.schedule(self.step))

    def epoch_end_calls(self):
        pass

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
        new_indices = np.where(np.array(mask))[0]
        if self.meta_indices is None or not np.array_equal(new_indices, self.meta_indices):
            # int8 scales were calibrated on the old columns (and the metadata width may
            # differ): drop them with the cached steps
            self._invalidate_steps()
        self.meta_indices = new_indices

    def _invalidate_steps(self):
        """Drop the cached fused steps, the shapes they were warmed on and the int8
        context (quantised weights and scales)."""
        self._eval_step_cache = {}
        self._warm_eval_shapes = set()
        self._int8_ctx = None

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

    def network_input(self, x, metadata):
        """The module's input (ref handlers.py:400-407): for a ``channel_concat``
        handler the NHWC batch with the (N, M) metadata broadcast to per-pixel maps
        concatenated after its channels, else the batch as it is."""
        if self.channel_concat and metadata is not None:
            n, h, w, _ = x.shape
            maps = metadata.to(x.dtype)[:, None, None, :].expand(n, h, w, metadata.shape[-1])
            return torch.cat([x, maps], dim=-1)
        return x

    @property
    def module_input_channels(self):
        """The module's input channels: the image's, plus the metadata maps'."""
        return self.in_channels + (self.num_metadata if self.channel_concat else 0)

    @property
    def module_takes_metadata(self):
        """Whether the module takes the metadata vector as its second argument (a
        ``channel_concat`` handler's maps replace it; SFTMD's SFT layers take it
        even then)."""
        return self.uses_metadata and not self.channel_concat

    # --- forward --------------------------------------------------------------------------
    def set_device_degrade(self, enabled):
        """Online degradation in the train step (ref handlers.py:186-190): each batch
        brings HR crops and their ``blur_kernels``, and :meth:`_prep_batch` makes the
        LR from them on the device."""
        self.device_degrade = bool(enabled)

    def _prep_batch(self, batch):
        """(x, hr, metadata): uint8 transport, the /255 on the device (ref
        handlers.py:415-438); x the module's input (:meth:`network_input`: with a
        ``channel_concat`` handler the metadata maps concatenated, here and nowhere
        else) and the module's metadata input (None when it takes none).  With
        :meth:`set_device_degrade` and ``blur_kernels`` in the batch, the LR is
        :func:`~sisr_tpu_torch.ops.degradations.degrade_batch_on_device` of the HR
        (the batch's ``lr`` is a placeholder)."""
        hr = _as_f32(batch.get('hr'))
        if self.device_degrade and batch.get('blur_kernels') is not None \
                and hr is not None:
            lr = degrade_batch_on_device(hr, batch['blur_kernels'], None, self.scale)[0]
        else:
            lr = _as_f32(batch['lr'])
        metadata = self.prepare_metadata(lr, batch.get('metadata'))
        if metadata is not None and \
                metadata.shape[-1] != self._metadata_width(self.num_metadata):
            raise ValueError('%s takes %d metadata values per image, the batch has %d '
                             '(selected columns of %s)'
                             % (type(self).__name__, self._metadata_width(self.num_metadata),
                                metadata.shape[-1], self.metadata_keys))
        x = self.network_input(lr, metadata)
        return x, hr, metadata if self.module_takes_metadata else None

    def forward(self, x, metadata=None):
        """Model output for an NHWC float batch (the module's input, as
        :meth:`_prep_batch` gives it, and the module's (N, M) metadata for a model
        that takes it), as NHWC.  A contiguous NHWC tensor permuted to NCHW is
        channels_last, the layout the convs and the channel attention kernel take."""
        args = (metadata,) if self.module_takes_metadata else ()
        # the train step's forward goes through DistributedDataParallel under a mesh
        module = self._ddp if self._ddp is not None and self.module.training \
            else self.module
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            out = module(x.permute(0, 3, 1, 2), *args)
        return out.permute(0, 2, 3, 1)

    def _module_image(self, interp):
        """The image a pre-upscaled family's module takes from the upscaled RGB LR
        batch (ref handlers.py:868-873): that batch, or for a ``ycbcr`` family the Y
        channel of it clipped, (N, H, W, 1)."""
        return _y_channel(interp)[..., None] if self.colorspace == 'ycbcr' else interp

    def super_resolve(self, batch):
        """The module's output for a batch (as run_eval_fused takes it; a
        ``tiled_eval`` family's on its tile grid), clipped to [0, 1], as an NHWC
        float32 RGB numpy array (the epoch's sample images).  A pre-upscaled family
        takes the LR upscaled to the batch's HR size where the two differ; a ``ycbcr``
        family's Y output is recombined with that image's CbCr."""
        self._set_training(False)
        dev = {'lr': self._to_device(batch['lr'])}
        if self.uses_metadata:
            dev['metadata'] = self._to_device(batch['metadata']).float()
        with torch.inference_mode():
            lr = _as_f32(dev['lr'])
            if self.im_input == 'interp' and batch.get('hr') is not None:
                hr_hw = tuple(batch['hr'].shape[1:3])
                if tuple(lr.shape[1:3]) != hr_hw:
                    lr = resize_bicubic(lr, *hr_hw)
            x_img = self._module_image(lr) if self.im_input == 'interp' else lr
            if self.tiled_eval:  # each tile batch is prepared in _tile_step
                out = self._tiled_forward({**dev, 'lr': x_img})
            else:
                x, _, metadata = self._prep_batch({**dev, 'lr': x_img})
                out = self.forward(x, metadata)
            out = out.float().clamp(0.0, 1.0)
            if self.colorspace == 'ycbcr':
                ycc = rgb_to_ycbcr_nhwc(lr.float().clamp(0.0, 1.0), im_type='jpg')
                out = ycbcr_to_rgb_nhwc(torch.cat([out[..., :1], ycc[..., 1:]], dim=-1),
                                        im_type='jpg').clamp(0.0, 1.0)
            return out.cpu().numpy()

    # --- training (ref handlers.py:469-545) -----------------------------------------------
    def _train_batch_keys(self):
        """Batch entries the train step takes: with :meth:`set_device_degrade` the HR
        crops and their blur kernels (the LR is made from them), else LR and HR; and
        the metadata for a metadata model."""
        keys = ('hr', 'blur_kernels') if self.device_degrade else ('lr', 'hr')
        return keys + ('metadata',) if self.uses_metadata else keys

    def check_trainable(self, batch=None):
        """Raise unless this handler can train (on ``batch``): eval mode, or
        differently sized images in the batch."""
        if self.eval_mode:
            raise RuntimeError('Model initialized in eval mode, training not possible.')
        probe = None if batch is None else batch.get('hr' if self.device_degrade else 'lr')
        if isinstance(probe, (list, tuple)):
            raise RuntimeError('Training batch contains differently-sized images — use a '
                               'fixed crop (data "crop" option, which must be no larger '
                               'than the smallest LR image) or batch_size=1.')

    def run_train(self, **batch):
        """One training step (ref BaseModel.run_train, models/__init__.py:466-489) on a
        batch of NHWC lr/hr arrays or tensors (uint8 or float) and, for a metadata
        model, its (N, M) metadata: (the loss, a 0-dim device tensor the device may
        still be computing, None).  Under a mesh each rank steps on the batch it is
        given: its slice of a global batch, as ``DataLoader(process_shard=...)`` loads
        it (marked ``_shard_factor``), or a whole batch (a ragged tail) on every rank;
        the gradients and the returned loss are the means over the ranks."""
        batch = self._rank_batch(batch)
        self.check_trainable(batch)
        return self._train_step(batch), None

    def run_train_multi(self, batches):
        """K training steps, one after another: ``batches`` is a list of K batch dicts,
        or one dict of (K, B, ...) stacked arrays.  Returns the K losses as one device
        tensor, not waited for."""
        if isinstance(batches, dict):
            batches = self._rank_batch(batches)
            keys = [k for k in self._train_batch_keys() if batches.get(k) is not None]
            batches = [{k: batches[k][i] for k in keys} for i in range(len(batches['hr']))]
        else:
            batches = [self._rank_batch(b) for b in batches]
        losses = []
        for batch in batches:
            self.check_trainable(batch)
            losses.append(self._train_step(batch))
        return torch.stack(losses)

    def _rank_batch(self, batch):
        """The train batch without its ``_shard_factor`` mark, which only a rank of a
        mesh may be given (sisr_tpu's handlers.py:473-477)."""
        batch = dict(batch)
        factor = int(batch.pop('_shard_factor', 1) or 1)
        if factor > 1 and self.mesh is None:
            raise RuntimeError('Received a process-local batch shard but no mesh is set — '
                               'a multi-process launch trains with gpu = "multi" (or '
                               '"off" for CPU ranks).')
        return batch

    def _train_step(self, batch):
        with profiling.span('train.step', device=True):
            with profiling.span('train.forward', device=True):
                loss = self.forward_loss(batch)
            with profiling.span('train.backward', device=True):
                self.backward(loss)
            with profiling.span('train.optimizer', device=True):
                self.update()
            loss = loss.detach()
            return loss if self.mesh is None else self.mesh.mean(loss)

    def forward_loss(self, batch):
        """The step's first part: the batch on the device (uint8 divided there), the
        module's forward in train mode and the loss against HR."""
        self._set_training(True)
        dev = {k: self._to_device(batch[k]) for k in self._train_batch_keys()
               if batch.get(k) is not None}
        if 'metadata' in dev:
            dev['metadata'] = dev['metadata'].float()
        lr, hr, metadata = self._prep_batch(dev)
        return self.loss_fn(self.forward(lr, metadata), hr)

    def backward(self, loss):
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()

    def update(self):
        """Clip, lr from the schedule at the updates made so far, Adam."""
        apply_update(self.optimizer, self.schedule, self.step, self.grad_clip)
        self.step += 1

    def set_eval_buckets(self, multiple):
        """Bucketed eval (ref handlers.py:191-200): pad each eval image up to the next
        multiple of ``multiple`` per spatial axis and run the mask-exact padded forward,
        so a set of differently sized images runs at a few shapes only."""
        if multiple and not self.bucketed_eval_ok:
            print('%s: bucketed eval is not exact for this architecture '
                  '(spatial softmax/covariance or strided pooling) — ignoring.'
                  % type(self).__name__)
            return
        self.eval_buckets = int(multiple) if multiple else None

    # --- int8 serving (ref handlers.py:202-292) --------------------------------------------
    def set_int8(self, enabled=True, residual_dtype='bfloat16'):
        """Turn the int8 serving path on or off: per-channel int8 weights, static
        activation scales calibrated (absmax, 10% margin) on the first eval batch, a
        narrow residual carry ('bfloat16' or 'float32'; 'int16' is EDSR's fixed-point
        carry, and the other families take bfloat16 for it).  Metrics are then
        computed on the quantised output."""
        if enabled and self.int8_family is None:
            print('%s: no int8 serving path for this architecture — ignoring.'
                  % type(self).__name__)
            return
        if enabled and self.int8_family not in _INT8_PROGRAMS:
            raise RuntimeError('unknown int8 family %r' % self.int8_family)
        if enabled and self.int8_family in INT8_MEASURED_SLOWER:
            warnings.warn(
                'int8 measured slower than bf16 for the %s family on an %s (%s bf16 '
                'img/s; the im2col gather and the elementwise passes around each int8 '
                'GEMM cost more than the GEMMs save) — engaging anyway as requested. '
                'See PERF.md.' % (self.int8_family, INT8_CARD,
                                  INT8_MEASURED_SLOWER[self.int8_family]))
        if residual_dtype not in ('float32', 'bfloat16', 'int16'):
            raise ValueError("residual_dtype must be 'float32', 'bfloat16' or 'int16', "
                             "got %r" % (residual_dtype,))
        self.int8_mode = bool(enabled)
        self.int8_residual_dtype = residual_dtype
        self._invalidate_steps()

    def _int8_calibration_input(self, lr_f32, hr_hw=None):
        """The calibration image, matching what the int8 program takes (ref
        handlers.py:228-248): for a pre-upscaled family given the HR size ``hr_hw``
        (the fused path), the image its module takes from the RGB LR
        (:meth:`_module_image` of the LR's device bicubic at that size: VDSR's Y
        channel); for a ``tiled_eval`` family, its centre crop of at most
        ``max(16, int(sqrt(max_combined_im_size)))`` a side, a tile's size, since the
        grid runs the program tile by tile; else the f32 batch as it is (the standard
        protocol hands a pre-upscaled family its input already upscaled)."""
        if self.im_input == 'interp' and hr_hw is not None:
            return self._module_image(resize_bicubic(lr_f32, *hr_hw))
        if self.tiled_eval:
            side = max(16, int(math.sqrt(self.max_combined_im_size)))
            h, w = lr_f32.shape[1:3]
            hs, ws = (h - min(h, side)) // 2, (w - min(w, side)) // 2
            return lr_f32[:, hs:hs + min(h, side), ws:ws + min(w, side), :]
        return lr_f32

    def _ensure_int8_ctx(self, x, meta=None):
        """Quantise the weights and calibrate the activation scales on ``x`` (the
        first batch) and, for a metadata model, ``meta`` (that batch's prepared
        metadata), once; the program then runs with them."""
        if self._int8_ctx is not None:
            return
        if self.module_takes_metadata and meta is None:
            raise RuntimeError('int8 %s calibration needs a metadata batch alongside the '
                               'first LR batch.' % self.int8_family.upper())
        params = params_from_state_dict(self.model_name, self.module.state_dict())
        m, family = self.module, self.int8_family
        if family == 'rcan':
            qp = qz.quantize_rcan_params(params, m.n_resgroups, m.n_resblocks)
            scales = qz.calibrate_rcan_scales(params, [x], m.n_resgroups, m.n_resblocks,
                                              margin=1.1)
        elif family == 'edsr':
            qp = qz.quantize_edsr_params(params)
            scales = qz.calibrate_edsr_scales(params, [x], m.num_blocks, self.scale,
                                              m.res_scale, margin=1.1)
        elif family == 'qrcan':
            qp = qz.quantize_qrcan_params(params, m.n_resgroups, m.n_resblocks)
            scales = qz.calibrate_qrcan_scales(params, [x], [meta], self.style,
                                               m.n_resgroups, m.n_resblocks, margin=1.1)
        elif family == 'qedsr':
            qp = qz.quantize_qedsr_params(params, m.num_blocks)
            scales = qz.calibrate_qedsr_scales(params, [x], [meta], m.num_blocks,
                                               self.scale, m.res_scale,
                                               m.q_layer_nonlinearity, margin=1.1)
        elif family == 'han':
            qp = qz.quantize_han_params(params, m.n_resgroups, m.n_resblocks)
            scales = qz.calibrate_han_scales(params, [x], m.n_resgroups, m.n_resblocks,
                                             margin=1.1)
        elif family == 'qhan':
            qp = qz.quantize_qhan_params(params, m.n_resgroups, m.n_resblocks)
            scales = qz.calibrate_qhan_scales(params, [x], [meta], m.n_resgroups,
                                              m.n_resblocks, margin=1.1)
        elif family == 'san':
            qp = qz.quantize_san_params(params, m.n_resgroups, m.n_resblocks)
            scales = qz.calibrate_san_scales(params, [x], m.n_resgroups, m.n_resblocks,
                                             margin=1.1)
        elif family == 'qsan':
            qp = qz.quantize_qsan_params(params, m.n_resgroups, m.n_resblocks)
            scales = qz.calibrate_qsan_scales(params, [x], [meta], m.n_resgroups,
                                              m.n_resblocks, margin=1.1)
        elif family == 'srmd':  # x: the input with its metadata maps concatenated
            qp = qz.quantize_srmd_params(params)
            scales = qz.calibrate_srmd_scales(params, [x], self.scale, margin=1.1)
        elif family == 'sftmd':
            if self.channel_concat:
                raise RuntimeError('int8 SFTMD does not support concat_strategy — disable '
                                   '--int8 or the concat strategy.')
            qp = qz.quantize_sftmd_params(params, m.num_blocks, self.scale)
            scales = qz.calibrate_sftmd_scales(params, [x], [meta], margin=1.1,
                                               **self._sftmd_config())
        elif family == 'vdsr':  # x: the Y channel of the pre-upscaled LR
            if m.padding != 'same':
                raise RuntimeError("int8 VDSR supports padding='same' only.")
            qp = qz.quantize_vdsr_params(params)
            scales = qz.calibrate_vdsr_scales(params, [x], margin=1.1)
        else:
            raise RuntimeError('unknown int8 family %r' % family)
        self.load_int8_state(qp, scales)

    def load_int8_state(self, qparams, act_scales):
        """Run the int8 program with these quantised parameters and scales (from
        :meth:`_ensure_int8_ctx`, or from sisr_tpu through
        ``tools.convert_weights.int8_state_from_jax``), moved to this handler's
        device.  Every family's program is ``program(x, meta=None)``: the f32 NHWC LR
        batch and, for a metadata model, its prepared (N, M) metadata."""
        qparams = _tree_to(qparams, self.device)
        dev_scales = qz.scales_on(act_scales, self.device)
        m, family, rd = self.module, self.int8_family, self.int8_residual_dtype
        if family != 'edsr' and rd == 'int16':
            print("int8 %s: residual_dtype %r is EDSR-only (int16 grid) — using bfloat16."
                  % (family, rd))
            rd = 'bfloat16'
        if family == 'rcan':
            def program(x, meta=None):
                return qz.rcan_int8_forward_static(qparams, dev_scales, x, m.n_resgroups,
                                                   m.n_resblocks, residual_dtype=rd)
        elif family == 'edsr':
            def program(x, meta=None):
                return qz.edsr_int8_forward_static(qparams, dev_scales, x, m.num_blocks,
                                                   self.scale, m.res_scale,
                                                   residual_dtype=rd)
        elif family == 'qrcan':
            def program(x, meta=None):
                return qz.qrcan_int8_forward_static(qparams, dev_scales, x, meta,
                                                    self.style, m.n_resgroups,
                                                    m.n_resblocks, residual_dtype=rd)
        elif family == 'qedsr':
            def program(x, meta=None):
                return qz.qedsr_int8_forward_static(qparams, dev_scales, x, meta,
                                                    m.num_blocks, self.scale, m.res_scale,
                                                    m.q_layer_nonlinearity,
                                                    residual_dtype=rd)
        elif family == 'han':
            def program(x, meta=None):
                return qz.han_int8_forward_static(qparams, dev_scales, x, m.n_resgroups,
                                                  m.n_resblocks, residual_dtype=rd)
        elif family == 'qhan':
            def program(x, meta=None):
                return qz.qhan_int8_forward_static(qparams, dev_scales, x, meta,
                                                   m.n_resgroups, m.n_resblocks,
                                                   residual_dtype=rd)
        elif family == 'san':
            def program(x, meta=None):
                return qz.san_int8_forward_static(qparams, dev_scales, x, m.n_resgroups,
                                                  m.n_resblocks, residual_dtype=rd)
        elif family == 'qsan':
            def program(x, meta=None):
                return qz.qsan_int8_forward_static(qparams, dev_scales, x, meta,
                                                   m.n_resgroups, m.n_resblocks,
                                                   residual_dtype=rd)
        elif family == 'srmd':
            def program(x, meta=None):  # x: the input with its maps concatenated
                return qz.srmd_int8_forward_static(qparams, dev_scales, x, self.scale)
        elif family == 'sftmd':
            def program(x, meta=None):
                return qz.sftmd_int8_forward_static(qparams, dev_scales, x, meta,
                                                    **self._sftmd_config())
        elif family == 'vdsr':
            def program(x, meta=None):
                return qz.vdsr_int8_forward_static(qparams, dev_scales, x)
        else:
            raise RuntimeError('unknown int8 family %r' % family)
        self._int8_ctx = (program, qparams, dict(act_scales))

    def _int8_forward(self, batch):
        """The int8 program on a device batch (ref handlers.py:251) and its prepared
        input (:meth:`_prep_batch`): quantises the weights and calibrates the scales on
        the first batch it sees (and its prepared metadata), then runs with them."""
        x, _, meta = self._prep_batch({'lr': batch['lr'].float(),
                                       'metadata': batch.get('metadata')})
        self._ensure_int8_ctx(self._int8_calibration_input(x), meta)
        return self._int8_ctx[0](x, meta)

    # --- standard eval (ref handlers.py:547-618, training/state.py:123-167) ----------------
    def _eval_step(self, batch):
        """The plain eval step (ref training/state.py make_eval_step): (SR, loss
        against batch['hr'] or None)."""
        lr, hr, metadata = self._prep_batch(batch)
        out = self.forward(lr, metadata)
        return out, (self.loss_fn(out.float(), hr) if hr is not None else None)

    def _masked_eval_step(self, batch):
        """The bucketed eval step (ref training/state.py make_masked_eval_step): the
        zero-padded input (and metadata maps) masked, the forward under the conv mask
        hooks, inside a mask context of batch['valid_hw']."""
        with spatial_masks(batch['lr'].shape[1:3], batch['valid_hw']):
            lr, _, metadata = self._prep_batch(batch)
            lr = apply_mask(lr, spatial_dims=(1, 2))
            if metadata is not None and metadata.dim() == 4:
                metadata = apply_mask(metadata, spatial_dims=(1, 2))
            with conv_mask_hooks(self.module):
                return self.forward(lr, metadata)

    def _bucketed_forward(self, batch):
        """Zero-pad the LR batch to the bucket grid, run the mask-exact padded step and
        slice the SR output back to the true size (ref handlers.py:919-936)."""
        x = batch['lr']
        n, h, w, c = x.shape
        m = self.eval_buckets
        bh, bw = -(-h // m) * m, -(-w // m) * m
        padded = {'lr': torch.nn.functional.pad(x, (0, 0, 0, bw - w, 0, bh - h)),
                  'valid_hw': (h, w)}
        if batch.get('metadata') is not None:
            padded['metadata'] = batch['metadata']
        out = self._masked_eval_step(padded)
        factor = out.shape[1] // bh
        return out[:, :h * factor, :w * factor, :]

    def run_eval(self, x, y=None, request_loss=False, metadata=None, timing=False,
                 **kwargs):
        """Eval of one batch for the host (ref BaseModel.run_eval, handlers.py:554-618):
        NHWC float images (numpy or tensors) in [0, 1], and for a metadata model its
        (N, M) metadata.  The forward is the tile grid for a ``tiled_eval`` family
        (the int8 program on each tile batch under ``set_int8``, calibrated first on a
        tile-sized crop), else the int8 program under ``set_int8``, else the bucketed
        forward under ``set_eval_buckets``, else the module (sisr_tpu's order, so
        ``--int8 --eval_buckets`` runs int8 unpadded).  With ``timing`` the card is
        synchronised around the forward, and the first call of each (path, shape) runs
        once untimed first (set-up: cuDNN heuristics, kernel builds).  Under a mesh a
        batch that divides the world size is split over the ranks (int8 calibrated on
        the whole first batch before) and the SR gathered in rank order, the loss the
        mean over the ranks; a ``tiled_eval`` family shares out its tiles instead.

        :return: (SR as an NHWC float32 numpy array, the loss against ``y`` when
            ``request_loss``, else None, the forward's seconds or None).
        """
        self._set_training(False)
        batch = {'lr': self._to_device(x).float()}
        if metadata is not None and self.uses_metadata:
            batch['metadata'] = self._to_device(metadata).float()
        if y is not None and request_loss:
            batch['hr'] = self._to_device(y).float()
        if self.tiled_eval and self.int8_mode and self._int8_ctx is None:
            # calibrate before the grid, on a tile-sized crop of the image
            x_cal = self._int8_calibration_input(batch['lr'])
            self._ensure_int8_ctx(x_cal, self.prepare_metadata(x_cal, batch.get('metadata')))
        sharded = False
        if self.mesh is not None and not self.tiled_eval:
            if self.int8_mode and self._int8_ctx is None:
                # every rank calibrates on the whole first batch, as one process does
                x_cal, _, meta_cal = self._prep_batch({'lr': batch['lr'],
                                                       'metadata': batch.get('metadata')})
                self._ensure_int8_ctx(self._int8_calibration_input(x_cal), meta_cal)
            batch = self.mesh.shard_batch(batch)
            sharded = batch.pop('_shard_factor', 1) > 1
        path = 'tiled' if self.tiled_eval else 'int8' if self.int8_mode \
            else 'buckets' if self.eval_buckets else 'module'
        fwd = {'tiled': self._tiled_forward, 'int8': self._int8_forward,
               'buckets': self._bucketed_forward}.get(path)
        step = self._eval_step if fwd is None else (lambda b: (fwd(b), None))
        runtime = None
        with torch.inference_mode():
            warm_key = ('eval', path, tuple(batch['lr'].shape))
            if timing and warm_key not in self._warm_eval_shapes:
                step(batch)
            self._warm_eval_shapes.add(warm_key)
            if timing:
                self._synchronize()
                tic = time.perf_counter()
            out, loss = step(batch)
            if timing:
                self._synchronize()  # model compute only: the loss comes after
                runtime = time.perf_counter() - tic
            if request_loss and y is not None:
                if loss is None:
                    loss = self.loss_fn(out.float(), batch['hr'])
                loss = float(self.mesh.mean(loss) if sharded else loss)
            else:
                loss = None
            if sharded:
                out = self.mesh.gather(out)
            return out.float().cpu().numpy(), loss, runtime

    def _tile_step(self, batch):
        """One forward of the tile grid (ref handlers.py:620-632) over a batch of
        tiles (and their metadata rows): the calibrated int8 program under
        ``set_int8``, else the plain eval step."""
        if self.int8_mode and self._int8_ctx is not None:
            lr, _, metadata = self._prep_batch(batch)
            return self._int8_ctx[0](lr, metadata)
        return self._eval_step(batch)[0]

    def _tiled_forward(self, batch, shave=10):
        """The static tile grid (ref handlers.py:634-718), in place of the reference's
        recursive ``forward_chop``: the LR batch is cut into grid x grid overlapping
        tiles, each ``shave`` pixels of halo on every side, with the grid halved from
        the image until a tile's area (halo included) is under
        ``max_combined_im_size`` (and doubled back while a tile would not fit the
        image); the tiles run as one batch, tile-major (tile t's n images at rows
        t*n..t*n+n-1, and the metadata repeated grid^2 times, not interleaved); their
        centres are stitched.  Anchors are clamped inside the image, so border tiles
        see the image's own edge.  Without a grid, one :meth:`_tile_step` of the
        batch.  Under a mesh the tile batch is padded to a multiple of the world size,
        each rank runs its share and the SR tiles are gathered, so every rank stitches
        the whole image (sisr_tpu's context-parallel eval)."""
        if self.max_combined_im_size <= shave * shave:
            # a tile's area never falls under it: sisr_tpu's loop does not end
            raise ValueError('max_combined_im_size must exceed %d (a tile\'s halo alone), '
                             'got %r' % (shave * shave, self.max_combined_im_size))
        x = batch['lr']
        n, h, w, _ = x.shape
        level = 0
        while (h // (2 ** level) + shave) * (w // (2 ** level) + shave) \
                >= self.max_combined_im_size:
            level += 1
        if level == 0:
            return self._tile_step(batch)
        grid = 2 ** level
        tile_h, tile_w = -(-h // grid), -(-w // grid)
        span_h, span_w = tile_h + 2 * shave, tile_w + 2 * shave
        while grid > 1 and (span_h > h or span_w > w):  # the image is too small
            grid //= 2
            tile_h, tile_w = -(-h // grid), -(-w // grid)
            span_h, span_w = tile_h + 2 * shave, tile_w + 2 * shave
        if grid == 1:
            return self._tile_step(batch)
        anchors, tiles = [], []
        for i in range(grid):
            for j in range(grid):
                src_i = min(max(i * tile_h - shave, 0), h - span_h)
                src_j = min(max(j * tile_w - shave, 0), w - span_w)
                anchors.append((i, j, i * tile_h - src_i, j * tile_w - src_j))
                tiles.append(x[:, src_i:src_i + span_h, src_j:src_j + span_w, :])
        tile_batch = {'lr': torch.cat(tiles)}
        if batch.get('metadata') is not None:
            tile_batch['metadata'] = batch['metadata'].repeat(grid * grid, 1)
        mesh = self.mesh
        if mesh is None or mesh.n_devices == 1:
            sr_tiles = self._tile_step(tile_batch)
        else:
            n_tiles = tile_batch['lr'].shape[0]
            local = mesh.shard_batch(mesh.pad_batch_to_devices(tile_batch,
                                                               keys=('lr', 'metadata')))
            sr_tiles = mesh.gather(self._tile_step(local))[:n_tiles]
        s = self.scale
        out = sr_tiles.new_zeros((n, grid * tile_h * s, grid * tile_w * s,
                                  sr_tiles.shape[-1]))
        for idx, (i, j, off_i, off_j) in enumerate(anchors):
            # a last tile's centre may run past its span: the slice then clips, as
            # sisr_tpu's does, and the part that exists covers the image to its edge
            tile = sr_tiles[idx * n:(idx + 1) * n, off_i * s:(off_i + tile_h) * s,
                            off_j * s:(off_j + tile_w) * s, :]
            out[:, i * tile_h * s:i * tile_h * s + tile.shape[1],
                j * tile_w * s:j * tile_w * s + tile.shape[2], :] = tile
        return out[:, :h * s, :w * s, :]

    def supports_fused_eval(self):
        """Whether the fused protocol can run this handler (ref handlers.py:711-722):
        not under bucketed eval, which keeps its own path."""
        return not self.eval_buckets

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

    def run_eval_fused(self, batch, metrics=('PSNR', 'SSIM'), timing=False, include_lr=True,
                       request_loss=False):
        """Eval fast path (ref handlers.py:724): one device step runs forward + bicubic
        LR baseline + YCbCr + PSNR/SSIM, and only per-image scalars stay for the host.

        Without ``timing`` the returned (K, N) metric matrix is still being computed
        when this returns (CUDA runs asynchronously); copy it to the host to wait.

        :return: ((keys, values): keys a K-tuple like ('LR>PSNR', 'model>PSNR', ...)
            and values the matching (K, N) float32 device tensor, runtime seconds or
            None).  ``include_lr=False`` omits the LR-baseline rows.  With
            ``request_loss`` a last 'model>loss' row carries the batch-mean loss of SR
            against HR, once per image (the training-time validation's loss).

        Under a mesh each rank runs its slice of a batch that divides the world size
        (or the slice it was given: ``_shard_factor``) and the (K, n) rows are gathered
        in global order; int8 calibrates on the whole first batch (its slices
        gathered).  A ``tiled_eval`` family runs the whole batch on every rank and
        shares out its tiles; a ragged batch runs whole, image by image.
        """
        sides = ('LR', 'model') if include_lr else ('model',)
        keys = tuple('%s>%s' % (side, met) for met in metrics for side in sides)
        if request_loss:
            keys = keys + ('model>loss',)
        factor = int(batch.get('_shard_factor', 1) or 1)
        if factor > 1 and (self.mesh is None or self.tiled_eval):
            raise RuntimeError('run_eval_fused got a batch slice (_shard_factor %d) '
                               'without a mesh, or for a tile-grid family, which runs '
                               'whole batches' % factor)
        if self.mesh is not None and factor == 1 and not self.tiled_eval:
            batch = self.mesh.shard_batch(batch)
            factor = batch.get('_shard_factor', 1)
        meta = batch.get('metadata') if self.uses_metadata else None
        if isinstance(batch['lr'], (list, tuple)):
            # ragged batch (mixed-size eval images at bs>1): run per image, each with
            # its own metadata row
            parts, total = [], 0.0
            for i, (lr, hr) in enumerate(zip(batch['lr'], batch['hr'])):
                one = {'lr': lr[None], 'hr': hr[None],
                       'metadata': None if meta is None else meta[i:i + 1]}
                (_, vals), rt = self.run_eval_fused(one, metrics=metrics, timing=timing,
                                                    include_lr=include_lr,
                                                    request_loss=request_loss)
                parts.append(vals)
                total += rt or 0.0
            return (keys, torch.cat(parts, dim=1)), (total if timing else None)

        dev_batch = {'lr': self._to_device(self._as_u8_if_lossless(batch['lr'])),
                     'hr': self._to_device(self._as_u8_if_lossless(batch['hr']))}
        if meta is not None:
            dev_batch['metadata'] = self._to_device(meta).float()
        if self.int8_mode and self._int8_ctx is None:
            # calibrate outside the step, on the input (and metadata) the program takes:
            # of the whole batch, the ranks' slices gathered under a mesh
            whole = dict(dev_batch)
            if factor > 1:
                whole['lr'] = self.mesh.gather(_as_f32(dev_batch['lr']))
                if 'metadata' in dev_batch:
                    whole['metadata'] = self.mesh.gather(dev_batch['metadata'])
            x_cal = self._int8_calibration_input(_as_f32(whole['lr']),
                                                 dev_batch['hr'].shape[1:3])
            x, _, metadata = self._prep_batch({**whole, 'lr': x_cal})
            self._ensure_int8_ctx(x, metadata)
        key = ('fused', tuple(metrics), include_lr, self.int8_mode, request_loss)
        if key not in self._eval_step_cache:
            self._eval_step_cache[key] = self._make_fused_step(tuple(metrics), include_lr,
                                                               request_loss)
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
        if factor > 1:
            out = self.mesh.gather(out, dim=1)
        return (keys, out), runtime

    def _make_fused_step(self, metrics, include_lr=True, request_loss=False):
        """(ref handlers.py:835) The per-batch device program as one function.  A
        pre-upscaled family's module takes :meth:`_module_image` of the LR's device
        bicubic at HR size, the tensor that also gives the LR baseline; a ``ycbcr``
        family's output is read as Y, clipped."""
        fns = {'PSNR': lambda a, b: psnr_nhw(a, b, 1.0),
               'SSIM': lambda a, b: ssim_nhw(a, b, 1.0)}
        interp_input = self.im_input == 'interp'

        @torch.inference_mode()
        def step(batch):
            self._set_training(False)
            with profiling.span('eval.prep', device=True):
                lr = _as_f32(batch['lr'])  # the RGB LR, without any metadata maps
                hr = _as_f32(batch['hr'])
                hr_y = _y_channel(hr)
                lr_y, x_img = None, lr
                if include_lr or interp_input:
                    # device bicubic stands in for the host PIL prep (same filter
                    # weights; <=1 uint8 LSB fixed-point difference)
                    interp = resize_bicubic(lr, hr.shape[1], hr.shape[2])
                    lr_y = _y_channel(interp)
                    if interp_input:  # the module's input: that tensor, or its Y
                        x_img = lr_y[..., None] if self.colorspace == 'ycbcr' else interp
                x, _, metadata = self._prep_batch({**batch, 'lr': x_img, 'hr': None})
            with profiling.span('eval.forward', device=True):
                if self.tiled_eval:
                    # the tile grid; each tile batch through the int8 program or the
                    # module
                    sr = self._tiled_forward({'lr': x_img,
                                              'metadata': batch.get('metadata')})
                elif self.int8_mode:  # the calibrated int8 program
                    sr = self._int8_ctx[0](x, metadata)
                else:
                    sr = self.forward(x, metadata)
            with profiling.span('eval.metrics', device=True):
                if self.colorspace == 'ycbcr':  # the model gives Y
                    sr_y = sr[..., 0].float().clamp(0.0, 1.0)
                    target = hr_y[..., None]
                else:
                    sr_y, target = _y_channel(sr), hr
                rows = []
                for met in metrics:  # row order matches run_eval_fused's keys tuple
                    if include_lr:
                        rows.append(fns[met](lr_y, hr_y))
                    rows.append(fns[met](sr_y, hr_y))
                if request_loss:
                    # the train step's loss on the model's output (against the model's
                    # colorspace: Y for a ycbcr family), once per image so the (K, N)
                    # matrix stays rectangular
                    rows.append(self.loss_fn(sr, target).float().expand(hr.shape[0]))
                return torch.stack(rows)

        return step

    # --- checkpointing (ref: models/__init__.py:349-464) -----------------------------------
    def save_model(self, model_save_name, model_idx, model_save_dir, background=False):
        """Write ``<model_save_dir>/<name>_<idx>``: ``network`` (the state_dict),
        ``optimizer`` (Adam's state_dict; training handlers), ``step``, ``model_name``
        and ``model_epoch``, as one ``torch.save`` file, or with ``checkpoint_backend
        = 'orbax'`` as a directory (``utils/orbax_ckpt.py``); either replaces the other
        at that path.  ``checkpoint_dtype = 'bf16_moments'`` casts Adam's moments to
        bfloat16 on the device, before the copy.  The state is copied to host tensors
        here, before any later step can change it.  With ``background`` (the epoch
        loop's saves) a training handler with ``async_checkpoint`` writes on the
        background writer (fence: :meth:`wait_pending_checkpoints`); otherwise the
        checkpoint is written before this returns."""
        state = {'network': self.module.state_dict(), 'model_name': self.model_name,
                 'model_epoch': int(self.curr_epoch), 'step': int(self.step)}
        if not self.eval_mode:
            state['optimizer'] = self.optimizer.state_dict()
            if self.checkpoint_dtype == 'bf16_moments':
                state['optimizer'] = async_ckpt.narrow_moments(state['optimizer'])
        state = async_ckpt.to_host(state)
        path = os.path.join(model_save_dir, '%s_%s' % (model_save_name, model_idx))
        if self.checkpoint_backend == 'orbax':
            job = lambda: orbax_ckpt.save_dir(path, state)  # noqa: E731
        else:
            job = lambda: async_ckpt.atomic_save(state, path)  # noqa: E731
        if background and self.async_checkpoint and not self.eval_mode:
            async_ckpt.WRITER.submit(path, job)
        else:
            job()

    def wait_pending_checkpoints(self, timeout=None):
        """Fence: block until every background checkpoint write of the process is on
        disk, re-raising the first failure."""
        async_ckpt.WRITER.wait(timeout=timeout)

    def load_model(self, model_save_name, model_idx, model_save_dir, load_override=None):
        """Load ``<load_override or model_save_dir>/<name>_<idx>``, a file or a
        directory checkpoint: the network, and for a training handler the Adam state
        (bfloat16 moments cast back to the parameters' type) and the step (a reference
        checkpoint's, which carries ``optimizer`` and ``scheduler_G`` but no step: its
        Adam state's update count), so the moments and the schedule continue."""
        self.wait_pending_checkpoints()  # a just-saved epoch may still be in flight
        path = os.path.join(load_override or model_save_dir,
                            '%s_%s' % (model_save_name, model_idx))
        if os.path.isdir(path):
            state_dict = orbax_ckpt.restore_dir(path)
        else:
            state_dict = torch.load(path, map_location='cpu', weights_only=True)
        # strict: layouts must match, once the parameters a reference checkpoint
        # carries and its forward never uses (SAN's) are dropped and its aged keys
        # (SFTMD's) renamed
        self.module.load_state_dict(repair_reference_keys(self.model_name,
                                                          state_dict['network']))
        self._place()
        self._sync_replicas()  # rank 0's weights on every rank, and a new DDP wrapper
        if not self.eval_mode and state_dict.get('optimizer'):
            self._load_optimizer(state_dict['optimizer'])
        if self._int8_ctx is not None or self.int8_mode:
            # the quantised weights came from the replaced parameters: requantise and
            # recalibrate on the next eval batch
            self._invalidate_steps()
        # the reference's own layout has no ``step``: its Adam state counts the updates
        self.step = int(state_dict['step']) if 'step' in state_dict \
            else _adam_updates(state_dict.get('optimizer'))
        self.set_epoch(int(state_dict['model_epoch']))
        print('Loaded model uses the following architecture:', state_dict['model_name'])
        return state_dict

    # --- parallelism (ref handlers.py:1091-1096) ------------------------------------------
    def set_mesh(self, mesh_ctx):
        """Data parallelism over the ranks of the process group (sisr_tpu's ``set_mesh``
        over a device mesh, the replacement for the reference's ``nn.DataParallel``):
        rank 0's parameters and buffers on every rank, the train step's forward through
        ``DistributedDataParallel`` (its gradient all-reduce averages before
        :meth:`update` clips, so the clip sees the global gradient), BatchNorm on the
        global batch's statistics, and eval split over the ranks (:meth:`run_eval`,
        :meth:`run_eval_fused`, :meth:`_tiled_forward`).  ``self.module`` stays the
        unwrapped module: checkpoints keep the reference's keys."""
        if mesh_ctx.device != self.device:
            raise ValueError('the mesh puts this rank on %s, the handler is on %s'
                             % (mesh_ctx.device, self.device))
        self.mesh = mesh_ctx
        for m in self.module.modules():
            if hasattr(m, 'sync_stats'):  # sparnet.FlaxBatchNorm2d
                m.sync_stats = mesh_ctx.n_devices > 1
        self._sync_replicas()

    def _sync_replicas(self):
        """Under a mesh: rank 0's state replicated, and (training handlers, once a
        process group is up) the DistributedDataParallel wrapper made anew around the
        module as it now is."""
        if self.mesh is None:
            return
        self.mesh.replicate(self.module)
        self._ddp = None
        if not self.eval_mode and self.mesh.group_up:
            cuda = self.device.type == 'cuda'
            # every registered family's train forward gives each parameter a gradient,
            # so none needs find_unused_parameters (tests/test_torch_parallel.py)
            self._ddp = torch.nn.parallel.DistributedDataParallel(
                self.module, device_ids=[self.device.index] if cuda else None)

    def _load_optimizer(self, saved):
        """Adam's moments and counts from a checkpoint (``load_state_dict`` casts a
        'bf16_moments' checkpoint's bfloat16 moments to their parameters' type); the
        hyperparameters stay the configured ones (the schedule sets the lr before
        every update)."""
        groups = [{**current, 'params': old['params']} for current, old in
                  zip(self.optimizer.state_dict()['param_groups'], saved['param_groups'])]
        self.optimizer.load_state_dict({'state': saved['state'], 'param_groups': groups})


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


@register_model('han')
class HANHandler(BaseHandler):
    """(ref: advanced/handlers.py:42-55).  The reference handler hardcodes the
    full-size net; like sisr_tpu's, this one takes the size parameters as an optional
    superset (defaults identical)."""

    int8_family = 'han'

    def build_module(self, scale, **kwargs):
        cfg = {k: v for k, v in kwargs.items()
               if k in ('n_resgroups', 'n_resblocks', 'n_feats', 'reduction')
               and v is not None}
        return advanced.HAN(scale=scale, **cfg)


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
                     **kwargs):
        # like sisr_tpu's QRCANHandler this takes no ``reduction``: a config's key falls
        # into kwargs and every QCALayer reduces by 16, so one config.toml builds the
        # same network in both packages
        return qmodels.QRCAN(
            n_resblocks=n_resblocks or 20, n_resgroups=n_resgroups or 10,
            n_feats=self.n_feats, in_feats=in_features or 3, scale=scale,
            style=self.style, num_metadata=self.num_metadata,
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


@register_model('qedsr')
class QEDSRHandler(QHandler):
    """(ref: attention_manipulators/handlers.py:57-76).  EDSR with a ParaCALayer gate
    on the metadata in every block; ``q_layer_nonlinearity`` puts a ReLU between the
    gate's two layers."""

    colorspace = 'augmented_rgb'
    int8_family = 'qedsr'

    def build_module(self, scale, in_features=3, num_features=64, num_blocks=16,
                     res_scale=0.1, q_layer_nonlinearity=False, **kwargs):
        return qmodels.QEDSR(num_features=num_features or 64, num_blocks=num_blocks or 16,
                             scale=scale, res_scale=res_scale if res_scale is not None
                             else 0.1, in_features=in_features or 3,
                             input_para=self.num_metadata,
                             q_layer_nonlinearity=bool(q_layer_nonlinearity))


@register_model('qhan')
class QHANHandler(QHandler):
    """(ref: attention_manipulators/handlers.py:156-171).  HAN whose residual groups
    are QRCAB groups (``standard`` QCALayer, a q_node in every block) taking the
    selected metadata columns."""

    int8_family = 'qhan'

    def build_module(self, scale, n_feats=None, n_resgroups=None, n_resblocks=None,
                     reduction=None, **kwargs):
        arch = {k: v for k, v in (('n_feats', n_feats), ('n_resgroups', n_resgroups),
                                  ('n_resblocks', n_resblocks),
                                  ('reduction', reduction)) if v is not None}
        return qmodels.QHAN(scale=scale, num_metadata=self.num_metadata, **arch)


@register_model('san')
class SANHandler(BaseHandler):
    """(ref: advanced/handlers.py:58-129): the static tile grid in place of the
    reference's ``forward_chop``.  Like sisr_tpu's, it takes the size parameters as an
    optional superset (defaults identical)."""

    tiled_eval = True
    bucketed_eval_ok = False  # the non-local spatial softmax and SOCA's covariance
    int8_family = 'san'

    def build_module(self, scale, **kwargs):
        cfg = {k: v for k, v in kwargs.items()
               if k in ('n_resgroups', 'n_resblocks', 'n_feats', 'reduction')
               and v is not None}
        return san.SAN(scale=scale, **cfg)


@register_model('qsan')
class QSANHandler(QHandler):
    """(ref: attention_manipulators/handlers.py:79-153): SAN with a ParaCALayer gate on
    the selected metadata columns in every block, on the tile grid."""

    tiled_eval = True
    bucketed_eval_ok = False  # the non-local spatial softmax and SOCA's covariance
    int8_family = 'qsan'

    def build_module(self, scale, n_feats=None, n_resgroups=None, n_resblocks=None,
                     reduction=None, **kwargs):
        arch = {k: v for k, v in (('n_feats', n_feats), ('n_resgroups', n_resgroups),
                                  ('n_resblocks', n_resblocks),
                                  ('reduction', reduction)) if v is not None}
        return qmodels.QSAN(scale=scale, input_para=self.num_metadata, **arch)


@register_model('srmd')
class SRMDHandler(QHandler):
    """(ref: advanced/handlers.py:132-158): the metadata broadcast to per-pixel maps
    and concatenated onto the LR image, a plain conv chain of ``nb`` convs of ``nc``
    features.  int8 runs the whole chain in int8 on the concatenated input."""

    colorspace = 'augmented_rgb'
    channel_concat = True
    int8_family = 'srmd'

    def build_module(self, scale, in_features=3, nc=128, nb=12, **kwargs):
        self.in_channels = in_features or 3
        return advanced.SRMD(in_nc=self.module_input_channels, nc=nc or 128, nb=nb or 12,
                             scale=scale)


@register_model('sftmd')
class SFTMDHandler(QHandler):
    """(ref: SFTMD_variants/handlers.py:6-60): the metadata vector feeds every SFT
    layer as per-pixel maps (and, with ``q_injection``, ParaCALayer gates as the
    vector); ``concat_strategy`` also concatenates the maps onto the LR image, and
    the module still takes the vector.  int8 runs the conv spine in int8, the SFT
    branches in bf16 and the gates in f32, and refuses ``concat_strategy``, as
    sisr_tpu does.

    Bucketed eval stays exact although the maps are non-zero in the pad: the conv
    hooks zero every conv's input and output there, so an SFT layer's product or
    concat sees zeros in the pad from the features' side, and each conv re-zeroes
    the maps' pad before it reads them."""

    colorspace = 'augmented_rgb'
    int8_family = 'sftmd'

    def __init__(self, concat_strategy=False, q_injection=False, **kwargs):
        self.channel_concat = bool(concat_strategy)
        self.q_injection = bool(q_injection)
        super().__init__(**kwargs)

    @property
    def module_takes_metadata(self):
        return True  # the SFT layers take the vector, with concat_strategy too

    def build_module(self, scale, in_nc=3, num_features=64, num_blocks=16,
                     SFT_type='standard', sft_type=None, mask_para=False, repeats=None,
                     q_layers=2, **kwargs):
        self.in_channels = in_nc or 3
        return sftmd.SFTMD(in_nc=self.module_input_channels,
                           num_features=num_features or 64, num_blocks=num_blocks or 16,
                           scale=scale, input_para=self.num_metadata,
                           sft_type=sft_type or SFT_type or 'standard',
                           mask_para=bool(mask_para), repeats=repeats,
                           q_injection=self.q_injection, q_layers=q_layers or 2)

    def _sftmd_config(self):
        """The int8 program's structure arguments."""
        m = self.module
        return dict(num_blocks=m.num_blocks, scale=self.scale, sft_type=m.sft_type,
                    mask_para=m.mask_para, repeats=m.repeats)


@register_model('srcnn')
class SRCNNHandler(BaseHandler):
    """(ref: basic/handlers.py:6-17): the Y channel of the pre-upscaled LR in, the
    restored Y channel out, the MSE loss."""

    colorspace = 'ycbcr'
    im_input = 'interp'
    loss_type = 'mse'
    in_channels = 1

    def build_module(self, scale, kernel_pattern=None, channel_pattern=None,
                     padding='same', **kwargs):
        return basic.SRCNN(kernel_pattern=kernel_pattern, channel_pattern=channel_pattern,
                           padding=padding or 'same')


@register_model('vdsr')
class VDSRHandler(SRCNNHandler):
    """(ref: basic/handlers.py:20-35): SRCNN's contract, 20 convs with a global
    residual, gradients clipped to a norm of 0.1 by default.  int8 runs the whole conv
    chain in int8 at HR size (``padding = 'same'`` only)."""

    grad_clip = 0.1
    int8_family = 'vdsr'

    def build_module(self, scale, kernel_pattern=None, channel_pattern=None,
                     padding='same', **kwargs):
        return basic.VDSR(kernel_pattern=kernel_pattern, channel_pattern=channel_pattern,
                          padding=padding or 'same')


def _sparnet_structure(kwargs):
    """The structure parameters SPARNet takes among a config's keys (ref:
    SPARNet/handlers.py:6-34), those set."""
    keys = ('min_ch', 'max_ch', 'in_size', 'out_size', 'min_feat_size', 'res_depth',
            'relu_type', 'norm_type', 'att_name', 'bottleneck_size')
    return {k: v for k, v in kwargs.items() if k in keys and v is not None}


@register_model('sparnet')
class SPARNetHandler(BaseHandler):
    """(ref: SPARNet/handlers.py:6-18): the RGB LR pre-upscaled to HR size.  Its
    BatchNorms run on the batch's statistics in the train step and on the running
    ones in every eval, and the running statistics travel in the checkpoint.  No
    bucketed eval (the strided hourglass and the norms see the pad), no int8 program,
    as in sisr_tpu."""

    im_input = 'interp'
    bucketed_eval_ok = False  # strided hourglass + spatial instance norm

    def build_module(self, scale, **kwargs):
        return sparnet.SPARNet(**_sparnet_structure(kwargs))


@register_model('qsparnet')
class QSPARNetHandler(QHandler):
    """(ref: SPARNet/handlers.py:21-34): SPARNet with a ParaCALayer gate on the
    selected metadata columns after every residual block (the encoder's only with
    ``metadata_encoder_only``)."""

    im_input = 'interp'
    bucketed_eval_ok = False  # strided hourglass + spatial instance norm

    def build_module(self, scale, metadata_encoder_only=False, **kwargs):
        return sparnet.QSPARNet(metadata_count=self.num_metadata,
                                metadata_encoder_only=bool(metadata_encoder_only),
                                **_sparnet_structure(kwargs))
