"""Serving runtime: run an exported ``.pt2`` program over a directory of images (PyTorch
port of sisr_tpu's ``tools/run_serving.py``).

The deployment half of ``export_serving``: load the program and its sidecar manifest,
then batch a directory through it — decode, the family's input preparation (the
host's Pillow-exact bicubic pre-upscale for interpolated-input families, the Y
channel in and the chroma recombined for ycbcr families, the metadata CSV in the
manifest's column layout for metadata models), fitting to the static shape
(centre crop, edge pad), SR PNGs out, and optional Y-channel PSNR/SSIM against a
ground-truth directory (``serving_metrics.csv``).  No checkpoint is read: the program,
torch, and the port's custom-op modules (imported with ``export_serving``) are
enough.  The program runs on the card (``--gpu``, the default) or on the
CPU (``--no-gpu``), and must have been exported for that device.
"""
import json
import os

import click
import numpy as np
import torch

from .export_serving import _key_counts, _layout_permutation, load_exported


def load_manifest(artifact_path):
    """The sidecar JSON written by ``export_experiment`` (``<artifact>.json``), or None
    for a bare artifact (the direct-RGB serving contract is then assumed)."""
    path = artifact_path + '.json'
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _fit_static(img, height, width):
    """An (h, w, C) array fitted to the static (height, width): larger axes
    centre-cropped, smaller ones edge-padded.  Returns (fitted, (vh, vw)), the top-left
    (vh, vw) region holding real pixels."""
    h, w = img.shape[:2]
    hs, ws = max(0, (h - height) // 2), max(0, (w - width) // 2)
    img = img[hs:hs + height, ws:ws + width]
    vh, vw = img.shape[:2]
    if vh < height or vw < width:
        img = np.pad(img, ((0, height - vh), (0, width - vw), (0, 0)), mode='edge')
    return img, (vh, vw)


def _load_metadata(names, n_meta, metadata_csv, manifest):
    """Each image's metadata row in the artifact's column layout: the manifest's keys
    checked by identity and the CSV's columns reordered to them (the contract of
    int8 calibration); without a manifest, only the width is checked."""
    from ..data.datasets import read_augmentation_list
    try:
        aug, keys = read_augmentation_list(metadata_csv, filenames=names)
    except KeyError as exc:
        raise RuntimeError('image %s has no row in %s — the metadata CSV must be keyed by '
                           'the exact input filenames' % (exc, metadata_csv)) from exc
    keys = list(keys)
    expected = (manifest or {}).get('metadata_keys')
    if expected is not None:
        if sorted(keys) != sorted(expected):
            raise RuntimeError('metadata CSV columns %s do not match the artifact\'s '
                               'layout %s (manifest %s.json)'
                               % (_key_counts(keys), _key_counts(expected),
                                  manifest.get('experiment', '?')))
        perm = _layout_permutation(keys, expected)
    else:
        if len(keys) != n_meta:
            raise RuntimeError('metadata CSV supplies %d columns (%s) but the artifact '
                               'takes %d (no manifest to reorder by — re-export to get '
                               'one)' % (len(keys), _key_counts(keys), n_meta))
        perm = np.arange(n_meta)
    return np.stack([np.asarray(aug[n], np.float32)[perm] for n in names])


def _signature(program):
    """((input shape, dtype) of each user input, output shape) of an
    ``ExportedProgram``."""
    user = set(program.graph_signature.user_inputs)
    inputs = [(tuple(n.meta['val'].shape), n.meta['val'].dtype)
              for n in program.graph.nodes if n.op == 'placeholder' and n.name in user]
    out = [n for n in program.graph.nodes if n.op == 'output'][0].args[0][0]
    return inputs, tuple(out.meta['val'].shape)


def serve_directory(artifact, input_dir, out_dir=None, gt_dir=None, metadata_csv=None,
                    metrics=('PSNR', 'SSIM'), save_images=True, device=None, program=None):
    """Run every image of ``input_dir`` through the artifact on ``device`` (default:
    cuda); ``{name: {'file': out_path or None, metric: value, ...}}``, with a
    ``'[mean]'`` row when ``gt_dir`` is given.  ``program``: the artifact already
    loaded (``export_serving.load_exported``), so a caller serving several folders
    loads it once."""
    from PIL import Image
    from ..models.interface import ModelInterface
    from ..ops.resize import resize_uint8
    from ..utils.helpers import resolve_device

    device = resolve_device(device)
    program = program or load_exported(artifact)
    inputs_sig, out_shape = _signature(program)
    (batch_size, height, width, channels), x_dtype = inputs_sig[0]
    n_meta = inputs_sig[1][0][1] if len(inputs_sig) > 1 else 0
    out_ratio = out_shape[1] // height
    uint8_input = x_dtype == torch.uint8

    man = load_manifest(artifact) or {}
    exported_on = (man.get('platforms') or [device.type])[0]
    if exported_on != device.type:
        raise RuntimeError('%s was exported for %s and runs there only: re-export it '
                           'for %s' % (artifact, exported_on, device.type))
    colorspace = man.get('colorspace', 'rgb')
    im_input = man.get('im_input', 'unmodified')
    scale = man.get('scale', out_ratio)
    if channels == 1 and 'colorspace' not in man:
        raise RuntimeError(
            '%s takes 1-channel input but has no sidecar manifest — the ycbcr serving '
            'contract (Y in, chroma recombined) needs <artifact>.json; re-export with '
            'the current export_serving' % artifact)

    names = sorted(f for f in os.listdir(input_dir)
                   if f.lower().endswith(('.png', '.jpg', '.jpeg', '.bmp')))
    if not names:
        raise RuntimeError('no images found in %s' % input_dir)
    if n_meta:
        metadata_csv = metadata_csv or os.path.join(input_dir, 'degradation_metadata.csv')
        if not os.path.isfile(metadata_csv):
            raise RuntimeError('the artifact takes a %d-column metadata input: pass '
                               '--metadata_csv or place degradation_metadata.csv in the '
                               'input directory' % n_meta)
        meta_rows = _load_metadata(names, n_meta, metadata_csv, man)

    inputs, chromas, valid = [], [], []
    for name in names:
        rgb = np.asarray(Image.open(os.path.join(input_dir, name)).convert('RGB'),
                         np.float32) / 255.0
        if im_input == 'interp':  # the model takes the bicubic-upscaled image
            h, w = rgb.shape[:2]
            u8 = (rgb * 255).astype(np.uint8)  # ToPILImage's truncation
            rgb = resize_uint8(u8, (w * scale, h * scale)).astype(np.float32) / 255.0
        if colorspace == 'ycbcr':
            ycbcr = ModelInterface.colorspace_convert(rgb[None], colorspace='rgb')[0]
            x, chroma = ycbcr[..., :1], ycbcr[..., 1:]
        else:
            x, chroma = rgb, None
        x, hw = _fit_static(x, height, width)
        inputs.append(x)
        chromas.append(None if chroma is None else _fit_static(chroma, height, width)[0])
        valid.append(hw)

    if save_images:
        out_dir = out_dir or (input_dir.rstrip('/\\') + '_sr')
        os.makedirs(out_dir, exist_ok=True)

    fn = program.module()
    results, sr_images = {}, {}
    for start in range(0, len(names), batch_size):
        chunk = inputs[start:start + batch_size]
        pad = batch_size - len(chunk)
        x = np.stack(chunk + [chunk[-1]] * pad)
        if uint8_input:
            x = np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)
        args = [torch.from_numpy(x).to(device)]
        if n_meta:
            m = meta_rows[start:start + batch_size]
            m = np.concatenate([m] + [m[-1:]] * pad) if pad else m
            args.append(torch.from_numpy(m).to(device))
        with torch.inference_mode():
            y = fn(*args).float().cpu().numpy()
        for j in range(len(chunk)):
            name = names[start + j]
            vh, vw = valid[start + j]
            sr = np.clip(y[j, :vh * out_ratio, :vw * out_ratio], 0.0, 1.0)
            if colorspace == 'ycbcr':
                ycbcr = np.concatenate([sr, chromas[start + j][:vh, :vw]], axis=-1)
                # clip before the uint8 cast: the matrix can leave [0, 1]
                sr = np.clip(ModelInterface.colorspace_convert(
                    ycbcr[None], colorspace='ycbcr')[0], 0.0, 1.0)
            sr_images[name] = sr
            results[name] = {'file': None}
            if save_images:
                out_path = os.path.join(out_dir, name)
                Image.fromarray((sr * 255.0).round().astype(np.uint8)).save(out_path)
                results[name]['file'] = out_path

    if gt_dir is not None:
        _run_gt_metrics(sr_images, gt_dir, list(metrics), results,
                        out_dir if save_images else None)
    return results


def _run_gt_metrics(sr_images, gt_dir, metrics, results, out_dir):
    """Y-channel metrics against the ground truth: the GT centre-cropped to the SR
    size (the eval protocol's alignment), RGB -> YCbCr 'jpg', the metric on Y."""
    from PIL import Image
    from ..models.interface import ModelInterface
    from ..ops.metrics import Metrics

    hub = Metrics(metrics, delimeter='>')
    sums = {m: 0.0 for m in metrics}
    for name, sr in sr_images.items():
        gt_path = os.path.join(gt_dir, name)
        if not os.path.isfile(gt_path):
            raise RuntimeError('no ground-truth image %s in %s' % (name, gt_dir))
        gt = np.asarray(Image.open(gt_path).convert('RGB'), np.float32) / 255.0
        gt = _fit_static(gt, sr.shape[0], sr.shape[1])[0]
        sr_y = ModelInterface.colorspace_convert(sr[None], colorspace='rgb')
        gt_y = ModelInterface.colorspace_convert(gt[None], colorspace='rgb')
        out, _ = hub.run_metrics(sr_y, references=gt_y, key='SR')
        for m in metrics:
            val = float(np.asarray(out['SR>%s' % m]).ravel()[0])
            results[name][m] = val
            sums[m] += val
    n = max(1, len(sr_images))
    results['[mean]'] = {m: sums[m] / n for m in metrics}
    if out_dir is not None:
        with open(os.path.join(out_dir, 'serving_metrics.csv'), 'w') as f:
            f.write('image,' + ','.join(metrics) + '\n')
            for name in sorted(sr_images):
                f.write(name + ',' + ','.join('%.6f' % results[name][m]
                                              for m in metrics) + '\n')
            f.write('[mean],' + ','.join('%.6f' % results['[mean]'][m]
                                         for m in metrics) + '\n')


@click.command(help='Run a directory of images through an exported .pt2 serving program '
                    '(no model code or checkpoint needed).')
@click.option('--artifact', required=True, type=click.Path(exists=True, dir_okay=False),
              help='Path to the .pt2 artifact.')
@click.option('--input_dir', required=True, type=click.Path(exists=True, file_okay=False),
              help='Directory of input (LR) images.')
@click.option('--out_dir', default=None, help='SR output directory (default: '
                                              '<input_dir>_sr).')
@click.option('--gt_dir', default=None, type=click.Path(file_okay=False),
              help='Ground-truth directory: adds Y-channel metrics and '
                   'serving_metrics.csv.')
@click.option('--metadata_csv', default=None, type=click.Path(dir_okay=False),
              help='Metadata CSV for q-model artifacts (default: '
                   '<input_dir>/degradation_metadata.csv).')
@click.option('--metric', 'metrics', multiple=True, default=('PSNR', 'SSIM'),
              show_default=True, help='Metrics to run against --gt_dir.')
@click.option('--no_save', is_flag=True, help='Skip writing SR images.')
@click.option('--gpu/--no-gpu', default=True, show_default=True,
              help='Run on the CUDA card (raises when there is none) or on the CPU.')
def run_serving_cli(artifact, input_dir, out_dir, gt_dir, metadata_csv, metrics, no_save,
                    gpu):
    results = serve_directory(artifact, input_dir, out_dir=out_dir, gt_dir=gt_dir,
                              metadata_csv=metadata_csv, metrics=list(metrics),
                              save_images=not no_save, device='cuda' if gpu else 'cpu')
    for name in sorted(n for n in results if n != '[mean]'):
        row = results[name]
        extras = ' '.join('%s %.4f' % (m, row[m]) for m in metrics if m in row)
        print('%s -> %s %s' % (name, row.get('file') or '(not saved)', extras))
    if '[mean]' in results:
        print('mean: ' + ' '.join('%s %.4f' % (m, results['[mean]'][m]) for m in metrics))


if __name__ == '__main__':
    run_serving_cli()
