"""Serving export: freeze a trained experiment into one ``torch.export`` program (PyTorch
port of sisr_tpu's ``tools/export_serving.py``).

``export_serving`` loads an experiment checkpoint, closes the forward over its weights
(:class:`ServingProgram`, or the calibrated int8 program, :class:`Int8ServingProgram`),
traces it with ``torch.export.export`` at one static shape and saves it with
``torch.export.save`` as a ``.pt2`` file, with a JSON sidecar manifest
(``<artifact>.json``) that ``run_serving`` reads.  Loading needs torch and the port's
custom-op modules, ``sisr_tpu_torch.ops.channel_attention``, which registers the
channel-attention kernels the program calls (``sisr::ca``, ``sisr::ca_res``), and
``sisr_tpu_torch.ops.quantization`` (an int8 program's convs, ``sisr::conv_int8_static``),
and no checkpoint:

    from sisr_tpu_torch.tools.export_serving import load_serving
    fn = load_serving('rcan_0_8x128x128.pt2')   # imports the op module first
    sr = fn(lr_batch)                           # or fn(lr_batch, metadata)

An artifact runs on the device it was exported on (``--gpu``, the default, is the
card: the kernels run inside the program).  Shapes are static: export one artifact per
shape.  ``--int8`` freezes the quantised serving program (int8 conv spine, f32
attention, static activation scales calibrated on the images of
``--calibration_images``; a metadata model also reads its
``degradation_metadata.csv``).
"""
from collections import Counter, defaultdict, deque
import json
import os

import click
import numpy as np
import torch
from torch import nn

from ..ops import channel_attention, quantization  # noqa: F401 (register the custom ops)

FILE_SUFFIX = '.pt2'
MANIFEST_FORMAT = 'sisr-torch-export-manifest/1'


class ServingProgram(nn.Module):
    """The handler's forward closed over its weights (sisr_tpu's ``build_serving_fn``):
    ``forward(x)`` or ``forward(x, metadata)`` with x NHWC float32 in [0, 1] or uint8
    0-255 and metadata (B, num_keys) float32, through the handler's input preparation
    (``_prep_batch``: the metadata columns, the channel concat) and its compute type;
    returns SR NHWC float32."""

    def __init__(self, handler):
        super().__init__()
        self.network = handler.module  # registers the weights
        self.handler = handler

    def forward(self, x, metadata=None):
        batch = {'lr': x} if metadata is None else {'lr': x, 'metadata': metadata}
        xx, _, meta = self.handler._prep_batch(batch)
        return self.handler.forward(xx, meta).float()


class Int8ServingProgram(nn.Module):
    """The calibrated int8 program of the handler (sisr_tpu's
    ``build_int8_serving_fn``), with the contract of :class:`ServingProgram`: the
    quantised weights and the activation scales are the program's constants."""

    def __init__(self, handler):
        super().__init__()
        if handler._int8_ctx is None:
            raise RuntimeError('int8 export needs a calibrated context — set_int8(True) '
                               'and run _ensure_int8_ctx on a real calibration batch '
                               'first (the CLI does this via --calibration_images)')
        self.handler = handler

    def forward(self, x, metadata=None):
        batch = {'lr': x.float() / 255.0 if x.dtype == torch.uint8 else x.float()}
        if metadata is not None:
            batch['metadata'] = metadata
        xx, _, meta = self.handler._prep_batch(batch)
        return self.handler._int8_ctx[0](xx, meta).float()


def _key_counts(keys):
    """Compact 'name xN' rendering of a metadata-column layout, in order."""
    out = []
    for k in keys:
        if out and out[-1][0] == k:
            out[-1][1] += 1
        else:
            out.append([k, 1])
    return ['%s x%d' % (k, n) if n > 1 else k for k, n in out]


def _layout_permutation(src_keys, dst_keys):
    """Indices into ``src_keys`` that rearrange it into ``dst_keys`` (the same multiset;
    repeats of a key keep their order, as vector metadata expands one column per
    element on both sides)."""
    slots = defaultdict(deque)
    for i, k in enumerate(src_keys):
        slots[k].append(i)
    return np.array([slots[k].popleft() for k in dst_keys], np.intp)


def _load_calibration_batch(handler, calibration_dir, limit=8):
    """The --int8 calibration inputs: up to ``limit`` images of ``calibration_dir``,
    centre-cropped to the smallest common size and stacked (N, H, W, 3) float32, and
    for a metadata model each image's row of its ``degradation_metadata.csv`` in the
    model's column layout (the column identities checked and reordered, not only
    counted).  Pre-upscaled families take images already in their input form, as the
    serving contract has it."""
    from PIL import Image
    from ..data.datasets import read_augmentation_list
    names = sorted(f for f in os.listdir(calibration_dir)
                   if f.lower().endswith(('.png', '.jpg', '.jpeg', '.bmp')))[:limit]
    if not names:
        raise RuntimeError('no calibration images found in %s' % calibration_dir)
    imgs = [np.asarray(Image.open(os.path.join(calibration_dir, n)).convert('RGB'),
                       np.float32) / 255.0 for n in names]
    hmin = min(i.shape[0] for i in imgs)
    wmin = min(i.shape[1] for i in imgs)

    def crop(i):
        hs, ws = (i.shape[0] - hmin) // 2, (i.shape[1] - wmin) // 2
        return i[hs:hs + hmin, ws:ws + wmin]

    x = np.stack([crop(i) for i in imgs])
    meta = None
    if handler.uses_metadata or handler.channel_concat:
        csv_path = os.path.join(calibration_dir, 'degradation_metadata.csv')
        if not os.path.isfile(csv_path):
            raise RuntimeError(
                'metadata model: the --calibration_images directory needs a '
                'degradation_metadata.csv (the data-layer contract, keyed by '
                'filename) so the int8 gates calibrate on real metadata')
        try:
            aug, keys = read_augmentation_list(csv_path, filenames=names)
        except KeyError as exc:
            raise RuntimeError(
                'calibration image %s has no row in %s — the CSV must be keyed '
                'by the exact filenames in --calibration_images (the data-layer '
                'contract written by image_manipulate)' % (exc, csv_path)) from exc
        expected = list(handler.metadata_keys or [])
        if sorted(keys) != sorted(expected):
            raise RuntimeError(
                'calibration metadata columns %s do not match the model\'s '
                'serving layout %s — point --calibration_images at data '
                'prepared like the training set'
                % (_key_counts(list(keys)), _key_counts(expected)))
        perm = _layout_permutation(list(keys), expected)
        meta = np.stack([np.asarray(aug[n], np.float32)[perm] for n in names])
    return x, meta


def export_handler(handler, batch_size, height, width, input_dtype=torch.float32,
                   int8=False):
    """The handler's serving program traced by ``torch.export`` at a static shape, on
    the handler's device: an ``ExportedProgram`` whose channel-attention calls are the
    custom ops ``sisr::ca`` and ``sisr::ca_res`` (and each static int8 conv one
    ``sisr::conv_int8_static``)."""
    handler._set_training(False)
    program = (Int8ServingProgram if int8 else ServingProgram)(handler).eval()
    x = torch.zeros((batch_size, height, width, handler.in_channels), dtype=input_dtype,
                    device=handler.device)
    args = (x,)
    if handler.uses_metadata or handler.channel_concat:
        n_meta = len(handler.metadata_keys or [])
        if not n_meta:
            raise RuntimeError('metadata model: call set_metadata_keys before export')
        args += (torch.zeros((batch_size, n_meta), device=handler.device),)
    return _trace(program, args, autocast=handler.dtype == torch.bfloat16 and not int8)


def _trace(program, args, autocast):
    """``program`` traced without grad.  A program under a bf16 autocast is traced to
    ATen IR, the autocast's casts recorded as ops (``torch.export._trace._export`` with
    ``pre_dispatch=False``): the training IR of ``torch.export.export`` would wrap each
    autocast region in a higher-order op, a pass whose time grows with the square of
    the regions (Q-RCAN's f32 vector products make two a block: minutes at 10 x 20)."""
    with torch.no_grad():
        if autocast:
            from torch.export._trace import _export
            return _export(program, args, strict=False, pre_dispatch=False)
        return torch.export.export(program, args, strict=False)


def load_exported(path):
    """An artifact as its ``ExportedProgram`` (the port's custom ops are registered:
    this module imports their modules)."""
    return torch.export.load(path)


def custom_op_calls(program):
    """{op name: calls} of the port's custom ops in an ``ExportedProgram``'s graph and
    its nested graphs (an autocast region is one)."""
    counts = Counter()
    for module in program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            counts.update(str(node.target) for node in module.graph.nodes
                          if node.op == 'call_function' and
                          str(node.target).startswith(channel_attention.OP_NAMESPACE + '.'))
    return dict(counts)


def load_serving(path):
    """An artifact as a callable ``fn(x[, metadata]) -> SR``."""
    return load_exported(path).module()


def _serving_metadata_keys(handler, metadata_keys):
    """The serving input's metadata columns (sisr_tpu's layout, data/datasets.py
    226-273): 40 CelebA attributes first for 'all', one column per scalar key, 441 per
    unmodified blur kernel, the 10 blur-kernel values last; set on the handler, which
    must select as many columns as its model takes."""
    cfg, seen = [], set()
    for k in metadata_keys or getattr(handler, 'metadata', None) or ['blur_kernel']:
        if k not in seen:  # a pre-expanded list must not expand twice
            seen.add(k)
            cfg.append(k)
    keys = ['celeba_attribute'] * 40 if 'all' in cfg else []
    for k in cfg:
        if k in ('all', 'blur_kernel'):
            continue
        keys.extend(['unmodified_blur_kernel'] * 441 if k == 'unmodified_blur_kernel'
                    else [k])
    if 'blur_kernel' in cfg:
        keys.extend(['blur_kernel'] * 10)
    handler.set_metadata_keys(keys)
    expected = getattr(handler, 'num_metadata', None)
    selected = len(keys) if handler.meta_indices is None else len(handler.meta_indices)
    if handler.uses_metadata and expected is not None and selected != expected:
        raise RuntimeError(
            'metadata expansion mismatch: keys %s select %d of %d serving columns but '
            'the model was built for %d (config metadata: %s) — pass --metadata with '
            'the unexpanded config key names'
            % (cfg, selected, len(keys), expected, getattr(handler, 'metadata', None)))


def load_for_export(model_loc, experiment, epoch, metadata_keys=None, int8=False,
                    calibration_images=None, int8_residual='bfloat16', device=None):
    """The experiment loaded as ``eval_sisr`` loads it, on ``device`` (default: cuda),
    ready to export: its metadata columns set (a metadata model) and, with ``int8``, its
    int8 context calibrated on ``calibration_images`` (as the first batch of an int8
    eval calibrates).  Returns the ``ModelInterface``."""
    from ..models.interface import ModelInterface
    from ..utils.helpers import resolve_device

    iface = ModelInterface(model_loc, experiment, mode='eval', load_epoch=epoch,
                           device=resolve_device(device))
    handler = iface.model
    if handler.uses_metadata or handler.channel_concat:
        _serving_metadata_keys(handler, metadata_keys)
    if int8:
        if handler.int8_family is None:
            raise RuntimeError('no int8 serving path for this architecture (%s) — '
                               'export without --int8' % type(handler).__name__)
        if calibration_images is None:
            raise RuntimeError('--int8 needs --calibration_images: activation scales '
                               'are calibrated on real images, not random data')
        handler.set_int8(True, residual_dtype=int8_residual)
        x_cal, meta_cal = _load_calibration_batch(handler, calibration_images)
        batch = {'lr': torch.as_tensor(x_cal, device=handler.device)}
        if meta_cal is not None:
            batch['metadata'] = torch.as_tensor(meta_cal, device=handler.device)
        with torch.inference_mode():
            x_net, _, meta_net = handler._prep_batch(batch)
            handler._ensure_int8_ctx(handler._int8_calibration_input(x_net), meta_net)
    return iface


def export_experiment(model_loc, experiment, epoch, batch_size, height, width,
                      out_path=None, metadata_keys=None, uint8_input=False, int8=False,
                      calibration_images=None, int8_residual='bfloat16', device=None):
    """Load an experiment on ``device`` (default: cuda; :func:`load_for_export`),
    export its serving program and write the ``.pt2`` and its manifest; returns the
    path."""
    iface = load_for_export(model_loc, experiment, epoch, metadata_keys, int8,
                            calibration_images, int8_residual, device)
    handler = iface.model
    program = export_handler(handler, batch_size, height, width,
                             input_dtype=torch.uint8 if uint8_input else torch.float32,
                             int8=int8)
    if out_path is None:
        out_path = '%s_%s_%dx%dx%d%s%s' % (experiment, iface.model_epoch, batch_size,
                                           height, width, '_int8' if int8 else '',
                                           FILE_SUFFIX)
    torch.export.save(program, out_path)
    # what a runner needs beyond the program's signature: scale, the colorspace and
    # interpolated-input contract, the metadata columns, and the ops to register
    manifest = {
        'format': MANIFEST_FORMAT,
        'model': iface.name, 'experiment': experiment,
        'epoch': iface.model_epoch, 'scale': handler.scale,
        'colorspace': handler.colorspace, 'im_input': handler.im_input,
        'in_channels': handler.in_channels,
        'batch_size': batch_size, 'height': height, 'width': width,
        'input_dtype': 'uint8' if uint8_input else 'float32',
        'metadata_keys': list(handler.metadata_keys)
        if (handler.uses_metadata or handler.channel_concat) else None,
        'int8': bool(int8),
        'int8_residual': int8_residual if int8 else None,
        'platforms': [handler.device.type],
        'custom_ops': {'namespace': channel_attention.OP_NAMESPACE,
                       'calls': custom_op_calls(program),
                       'modules': ['sisr_tpu_torch.ops.channel_attention',
                                   'sisr_tpu_torch.ops.quantization']},
    }
    with open(out_path + '.json', 'w') as f:
        json.dump(manifest, f, indent=1)
    return out_path


@click.command(help='Export a trained experiment as a torch.export serving program '
                    '(.pt2: weights and graph; loading needs torch and the port\'s '
                    'custom-op module).')
@click.option('--model_loc', required=True, help='Experiment parent directory.')
@click.option('--experiment', required=True, help='Experiment name.')
@click.option('--epoch', default='best', show_default=True,
              help='Checkpoint epoch (number, "best" or "last").')
@click.option('--batch_size', default=1, show_default=True)
@click.option('--height', default=128, show_default=True, help='LR input height.')
@click.option('--width', default=128, show_default=True, help='LR input width.')
@click.option('--out', default=None, help='Output path (default: derived name).')
@click.option('--metadata', multiple=True,
              help='Metadata keys the serving input will carry (q-models; '
                   'default: the model config\'s list).')
@click.option('--uint8', 'uint8_input', is_flag=True,
              help='Take uint8 0-255 input (minimal-transport serving).')
@click.option('--int8', is_flag=True,
              help='Freeze the int8-quantized serving program (int8 conv spine, '
                   'f32 attention).')
@click.option('--calibration_images', default=None,
              type=click.Path(exists=True, file_okay=False),
              help='Directory of real images (+ degradation_metadata.csv for '
                   'metadata models) to calibrate int8 activation scales on. '
                   'Required with --int8.')
@click.option('--int8_residual', default='bfloat16', show_default=True,
              type=click.Choice(['float32', 'bfloat16']),
              help='Residual-carry dtype of the int8 program.')
@click.option('--gpu/--no-gpu', default=True, show_default=True,
              help='Export for the CUDA card (raises when there is none) or the CPU; '
                   'the artifact runs on that device.')
def export_serving_cli(model_loc, experiment, epoch, batch_size, height, width, out,
                       metadata, uint8_input, int8, calibration_images, int8_residual,
                       gpu):
    if epoch not in ('best', 'last'):
        epoch = int(epoch)
    path = export_experiment(model_loc, experiment, epoch, batch_size, height, width,
                             out_path=out, metadata_keys=list(metadata) or None,
                             uint8_input=uint8_input, int8=int8,
                             calibration_images=calibration_images,
                             int8_residual=int8_residual, device='cuda' if gpu else 'cpu')
    print('exported %s (%.1f MB)' % (path, os.path.getsize(path) / 1e6))


if __name__ == '__main__':
    export_serving_cli()
