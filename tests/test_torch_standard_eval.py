"""sisr_tpu_torch's standard eval protocol and standard validation epoch against
sisr_tpu's on the CPU, on small models with the same weights (through the weights
bridge): the host Metrics hub; net_run_and_process and run_eval; the standard
protocol through the CLI (individual/average CSVs, --save_im images, the comparison
collages, --model_only, --lr_dir_interp, --decoded_cache_dir, --eval_buckets), for
RCAN, Q-RCAN, HAN and Q-HAN (LAM's and CSAM's gammas non-zero); the collage page's
PDF decoded back to its drawn pixels; int8 standard against int8 fused; and
train_sisr with fused_val = false in both packages.  Bars: forward and loss 5e-4 abs
in f32, PSNR within 0.01 dB and SSIM within 1e-3 per image, saved images within 1
uint8 LSB."""
import json
import os
import re
import zlib

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.models.interface import ModelInterface as JaxModelInterface
from sisr_tpu.net_train import experiment_setup as jax_experiment_setup
from sisr_tpu.ops.metrics import Metrics as JaxMetrics
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu_torch import net_eval, net_train
from sisr_tpu_torch.data.datasets import SuperResImages
from sisr_tpu_torch.evaluation.standard_eval import EvalHub
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.models.interface import ModelInterface
from sisr_tpu_torch.ops.metrics import Metrics
from sisr_tpu_torch.tools import visualization
from sisr_tpu_torch.tools.convert_weights import state_dict_from_jax
from sisr_tpu_torch.training.handler import TrainingHandler
from sisr_tpu_torch.utils import toml_io

RCAN = {'scale': 4, 'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 16}
QRCAN = {'scale': 4, 'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 16,
         'style': 'max_concat', 'include_q_layer': True, 'metadata': ['blur_kernel']}
HAN = {'scale': 4, 'n_resgroups': 2, 'n_resblocks': 1, 'n_feats': 16, 'reduction': 16}
QHAN = {**HAN, 'metadata': ['blur_kernel']}
MODELS = {'rcan': RCAN, 'qrcan': QRCAN, 'han': HAN, 'qhan': QHAN}
META_MODELS = ('qrcan', 'qhan')
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}
# HR sizes of the mixed-size set (multiples of 4); 12 x 12 LR appears twice
HR_SIZES = ((48, 48), (44, 64), (48, 48), (64, 36))


def _params(handler):
    return jax.tree.map(np.asarray, handler.state.params)


@pytest.fixture(scope='module')
def jax_models():
    out = {}
    for name, internal in MODELS.items():
        handler = jax_define_model(name, eval_mode=True, **internal)
        if name in META_MODELS:
            handler.set_metadata_keys(['blur_kernel'] * 10)
        handler.init_state(spatial=(12, 12))
        if name in ('han', 'qhan'):
            # LAM and CSAM start as the identity (gamma 0): make them act
            params = _params(handler)
            params = {**params, 'la': {'gamma': np.array([0.5], np.float32)},
                      'csa': {**params['csa'], 'gamma': np.array([-0.7], np.float32)}}
            handler.state = handler.state.replace(params=jax.tree.map(jnp.asarray, params))
        out[name] = handler
    return out


def _port(name, jax_handler, **kwargs):
    handler = define_model(name, device='cpu', **{**MODELS[name], **kwargs})
    if name in META_MODELS:
        handler.set_metadata_keys(['blur_kernel'] * 10)
    handler.module.load_state_dict(state_dict_from_jax(name, _params(jax_handler)))
    return handler


def test_metrics_hub_matches_sisr_tpu():
    """Per image, over the batch, over every channel, at max_value 255, and the
    diagnostic string, to 1e-6; on-device metrics (here the CPU) within 1e-4 dB and
    1e-5; an unknown metric raises ValueError, as in sisr_tpu."""
    rng = np.random.RandomState(0)
    a = rng.rand(3, 24, 20, 3)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    ours, theirs = Metrics(['PSNR', 'SSIM'], delimeter='>'), JaxMetrics(['PSNR', 'SSIM'],
                                                                      delimeter='>')
    for metric in ('PSNR', 'SSIM'):
        for kwargs in ({'single_values': True}, {'multichannel': True}, {},
                       {'single_values': True, 'max_value': 255}):
            scale = kwargs.get('max_value', 1)
            np.testing.assert_allclose(
                ours.run_image_metric(metric, a * scale, b * scale, **kwargs),
                theirs.run_image_metric(metric, a * scale, b * scale, **kwargs),
                atol=1e-6, rtol=0, err_msg='%s %s' % (metric, kwargs))
    out, diag = ours.run_metrics(a, b, key='LR', probe_names=['x', 'y', 'z'])
    ref, ref_diag = theirs.run_metrics(a, b, key='LR', probe_names=['x', 'y', 'z'])
    assert list(out) == list(ref) == ['LR>PSNR', 'LR>SSIM'] and diag == ref_diag
    device = Metrics(['PSNR', 'SSIM'], delimeter='>', device='cpu').run_metrics(a, b)[0]
    for key, bar in (('>PSNR', 1e-4), ('>SSIM', 1e-5)):
        np.testing.assert_allclose(device[key], ref['LR' + key], atol=bar, rtol=0)
    with pytest.raises(ValueError, match='Unknown metric'):
        ours.run_metrics(a, b, metrics=['LPIPS'])


@pytest.mark.parametrize('name', sorted(MODELS))
def test_run_eval_and_net_run_and_process_match_sisr_tpu(jax_models, name):
    rng = np.random.RandomState(1)
    lr = rng.rand(2, 12, 16, 3).astype(np.float32)
    hr = rng.rand(2, 48, 64, 3).astype(np.float32)
    meta = rng.rand(2, 10).astype(np.float32) if name in META_MODELS else None
    port = _port(name, jax_models[name])
    out, loss, runtime = port.run_eval(lr, hr, request_loss=True, metadata=meta, timing=True)
    ref, ref_loss, _ = jax_models[name].run_eval(lr, hr, request_loss=True, metadata=meta)
    assert out.dtype == np.float32 and runtime > 0
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=0)
    assert loss == pytest.approx(ref_loss, abs=5e-4)
    assert port.run_eval(lr, hr, metadata=meta)[1:] == (None, None)

    interface = ModelInterface.__new__(ModelInterface)
    interface.model, interface.configuration = port, {'input': 'unmodified',
                                                      'colorspace': port.colorspace}
    jax_interface = JaxModelInterface.__new__(JaxModelInterface)
    jax_interface.model = jax_models[name]
    jax_interface.configuration = {'input': 'unmodified',
                                   'colorspace': jax_models[name].colorspace}
    ours = interface.net_run_and_process(lr=lr, hr=hr, metadata=meta, request_loss=True)
    theirs = jax_interface.net_run_and_process(lr=lr, hr=hr, metadata=meta,
                                               request_loss=True)
    for a, b in zip(ours[:2], theirs[:2]):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=0)
    assert ours[2] == pytest.approx(theirs[2], abs=5e-4) and ours[3] is None


def _write_image(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope='module')
def workload(tmp_path_factory, jax_models):
    """Mixed-size HR/LR pairs (PIL bicubic LR), their interpolated LR, a blur-kernel
    degradation_metadata.csv, and each model as a sisr_tpu and a sisr_tpu_torch
    experiment with the same weights."""
    root = str(tmp_path_factory.mktemp('standard_eval'))
    rng = np.random.RandomState(2)
    dirs = {k: os.path.join(root, k) for k in ('lr', 'hr', 'interp')}
    with_meta = []
    for i, (h, w) in enumerate(HR_SIZES):
        name = 'im_%d.png' % i
        yy, xx = np.mgrid[0:h, 0:w] / 16.0
        hr = np.stack([np.sin(xx + c) * np.cos(yy * (c + 1)) for c in range(3)], -1)
        hr = np.clip((hr * 0.4 + 0.5) * 255 + rng.normal(0, 8, hr.shape), 0, 255)
        hr_im = Image.fromarray(hr.astype(np.uint8))
        lr_im = hr_im.resize((w // 4, h // 4), Image.BICUBIC)
        _write_image(os.path.join(dirs['hr'], name), np.asarray(hr_im))
        _write_image(os.path.join(dirs['lr'], name), np.asarray(lr_im))
        _write_image(os.path.join(dirs['interp'], name),
                     np.asarray(lr_im.resize((w, h), Image.BICUBIC)))
        with_meta.append('%s,"%s"' % (name, json.dumps(rng.dirichlet(np.ones(10) * 5)
                                                      .tolist())))
    meta_dir = os.path.join(root, 'lr_meta')
    os.makedirs(meta_dir)
    for name in sorted(os.listdir(dirs['lr'])):
        os.link(os.path.join(dirs['lr'], name), os.path.join(meta_dir, name))
    with open(os.path.join(meta_dir, 'degradation_metadata.csv'), 'w') as f:
        f.write('image,blur_kernel\n' + '\n'.join(with_meta) + '\n')
    dirs['lr_meta'] = meta_dir
    models = os.path.join(root, 'Results')
    for name, internal in MODELS.items():
        for package in ('jax', 'torch'):
            base = os.path.join(models, '%s_%s' % (package, name))
            os.makedirs(os.path.join(base, 'saved_models'))
            toml_io.dump({'model': {'name': name, 'internal_params': internal}},
                         os.path.join(base, 'config.toml'))
        jax_models[name].save_model('train_model', 0,
                                    os.path.join(models, 'jax_' + name, 'saved_models'))
        jax_models[name].wait_pending_checkpoints()
        _port(name, jax_models[name]).save_model(
            'train_model', 0, os.path.join(models, 'torch_' + name, 'saved_models'))
    return root, dirs, models


def _hub_kwargs(dirs, models, out, name, **kwargs):
    return {'hr_dir': dirs['hr'], 'lr_dir': dirs['lr_meta' if name in META_MODELS else 'lr'],
            'results_name': 'r', 'gpu': False, 'metrics': ['PSNR', 'SSIM'],
            'data_split': None, 'save_im': True, 'batch_size': 1, 'full_directory': True,
            'lr_dir_interp': None, 'model_only': False, 'scale': 4, 'model_loc': models,
            'out_loc': out, 'use_test_group': False, 'no_image_comparison': False,
            'num_image_save': 100, 'qpi_selection': (None, None), 'data_attributes': None,
            'dataset_name': None, 'image_shortlist': None, 'metadata_file': None,
            'sp_gpu': 0, 'time_models': True, 'recursive': False, **kwargs}


def _cli(dirs, models, out, name, *extra):
    args = ['--hr_dir', dirs['hr'],
            '--lr_dir', dirs['lr_meta' if name in META_MODELS else 'lr'],
            '-me', 'torch_' + name, '0', '--model_loc', models, '--out_loc', out,
            '--results_name', 'r', '-m', 'PSNR', '-m', 'SSIM', '--full_directory',
            '--save_im', '--no-gpu', *extra]
    net_eval.eval_run.main(args=args, standalone_mode=False)


def _metrics(out, results='r'):
    return [pd.read_csv(os.path.join(out, results, 'standard_metrics', f), header=[0, 1],
                        index_col=0) for f in ('individual_metrics.csv',
                                               'average_metrics.csv')]


def _assert_frames_match(ours, theirs, our_exp, their_exp):
    """Same images, same columns (the experiment renamed), metrics within the bars."""
    assert list(ours.index) == list(theirs.index)
    assert [(their_exp if c[0] == our_exp else c[0], c[1]) for c in ours.columns] == \
        list(theirs.columns)
    for side, their_side in (('LR', 'LR'), (our_exp, their_exp)):
        for met, bar in BARS.items():
            np.testing.assert_allclose(ours[(side, met)], theirs[(their_side, met)],
                                       atol=bar, rtol=0, err_msg='%s %s' % (side, met))


@pytest.mark.parametrize('name', sorted(MODELS))
def test_standard_protocol_cli_matches_sisr_tpu(workload, name, tmp_path):
    """eval_sisr without --fused_eval, --save_im and comparisons on: CSVs, images
    within 1 uint8 LSB, one collage per image with sisr_tpu's file names (one-page
    PDFs)."""
    _, dirs, models = workload
    ours_out, theirs_out = str(tmp_path / 'port'), str(tmp_path / 'ref')
    _cli(dirs, models, ours_out, name)
    JaxEvalHub(**_hub_kwargs(dirs, models, theirs_out, name,
                             model_and_epoch=[('jax_' + name, '0')])).full_image_protocol()
    ours, theirs = _metrics(ours_out), _metrics(theirs_out)
    _assert_frames_match(ours[0], theirs[0], 'torch_' + name, 'jax_' + name)
    assert ours[0][('torch_' + name, 'runtime')].gt(0).all()
    assert ours[0][('LR', 'runtime')].gt(0).all()
    assert ours[1].shape == theirs[1].shape
    for image in sorted(os.listdir(dirs['hr'])):
        a = np.asarray(Image.open(os.path.join(ours_out, 'r', 'torch_' + name, image)))
        b = np.asarray(Image.open(os.path.join(theirs_out, 'r', 'jax_' + name, image)))
        assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= 1
    stems = [sorted(os.listdir(os.path.join(out, 'r', 'model_comparisons')))
             for out in (ours_out, theirs_out)]
    assert stems[0] == stems[1] and len(stems[0]) == len(HR_SIZES)
    assert all(name.endswith('.pdf') for name in stems[0])
    page = _pdf_page(os.path.join(ours_out, 'r', 'model_comparisons',
                                  'image_comparison_im_1.pdf'))
    assert page.shape[2] == 3 and page.shape[1] > 3 * 64


def _pdf_page(path):
    """The pixels of a one-page PDF written by write_pdf_page, read with no PDF
    library: the image XObject's FlateDecode stream, shaped by its /Width and
    /Height."""
    with open(path, 'rb') as f:
        data = f.read()
    assert data.startswith(b'%PDF-') and data.rstrip().endswith(b'%%EOF')
    head = re.search(rb'/Subtype /Image /Width (\d+) /Height (\d+) /ColorSpace /DeviceRGB '
                     rb'/BitsPerComponent 8 /Filter /FlateDecode /Length (\d+) >>\nstream\n',
                     data)
    width, height, length = (int(v) for v in head.groups())
    pixels = zlib.decompress(data[head.end():head.end() + length])
    return np.frombuffer(pixels, np.uint8).reshape(height, width, 3)


def test_collage_pdf_holds_the_drawn_pixels(tmp_path, monkeypatch):
    """A collage page parsed back from its PDF is the page PIL drew, pixel for pixel,
    and the HR panel sits in it unchanged; the xref table points at every object."""
    drawn = []
    write = visualization.write_pdf_page
    monkeypatch.setattr(visualization, 'write_pdf_page',
                        lambda image, path: drawn.append(np.asarray(image)) or write(image,
                                                                                     path))
    rng = np.random.RandomState(3)
    hr = rng.rand(2, 40, 52, 3).astype(np.float32)
    package = {'HR': hr, 'LR': rng.rand(2, 40, 52, 3).astype(np.float32),
               'exp': rng.rand(2, 40, 52, 3).astype(np.float32)}
    visualization.interpret_sisr_images(package, {'exp>PSNR': [30.0, 31.5]}, ['PSNR'],
                                        str(tmp_path), ['a.pdf', 'b.pdf'], config='rgb',
                                        extra_info={'exp': [['epoch', 3]]})
    for index, name in enumerate(('a.pdf', 'b.pdf')):
        page = _pdf_page(str(tmp_path / name))
        np.testing.assert_array_equal(page, drawn[index])
        top = visualization._MARGIN + visualization._LINE * 2  # two title lines: exp, epoch
        panel = page[top:top + 40, visualization._MARGIN:visualization._MARGIN + 52]
        np.testing.assert_array_equal(panel, (hr[index] * 255).astype(np.uint8))
        data = (tmp_path / name).read_bytes()
        xref = int(data.rsplit(b'startxref\n', 1)[1].split()[0])
        offsets = [int(line[:10]) for line in data[xref:].split(b'\n')[3:8]]
        assert [data[o:].split(b' ', 1)[0] for o in offsets] == [b'1', b'2', b'3', b'4', b'5']


def test_model_only_and_lr_dir_interp_match_sisr_tpu(workload, tmp_path):
    _, dirs, models = workload
    for label, extra, kwargs in (('model_only', ['--model_only'], {'model_only': True}),
                                 ('interp', ['--lr_dir_interp', dirs['interp']],
                                  {'lr_dir_interp': dirs['interp']})):
        ours_out, theirs_out = str(tmp_path / (label + '_port')), str(tmp_path / label)
        _cli(dirs, models, ours_out, 'rcan', *extra)
        hub = JaxEvalHub(**_hub_kwargs(dirs, models, theirs_out, 'rcan',
                                       model_and_epoch=[('jax_rcan', '0')], **kwargs))
        hub.direct_model_protocol() if label == 'model_only' else hub.full_image_protocol()
        written = sorted(os.listdir(os.path.join(ours_out, 'r', 'torch_rcan')))
        assert written == sorted(os.listdir(dirs['lr']))  # one SR image per LR image
        for image in written:
            a = np.asarray(Image.open(os.path.join(ours_out, 'r', 'torch_rcan', image)))
            b = np.asarray(Image.open(os.path.join(theirs_out, 'r', 'jax_rcan', image)))
            assert np.abs(a.astype(int) - b).max() <= 1
        if label == 'model_only':
            assert not os.path.isdir(os.path.join(ours_out, 'r', 'standard_metrics'))
        else:  # the LR baseline is the interpolated folder's, and no resize is timed
            ours, theirs = _metrics(ours_out)[0], _metrics(theirs_out)[0]
            _assert_frames_match(ours, theirs, 'torch_rcan', 'jax_rcan')
            assert ('LR', 'runtime') not in ours.columns


def test_decoded_cache_dir_and_eval_buckets(workload, tmp_path, monkeypatch):
    """--decoded_cache_dir: the second run decodes no image; --eval_buckets gives the
    unbucketed metrics (within 1e-4 dB / 1e-6) and images."""
    _, dirs, models = workload
    cache = str(tmp_path / 'decoded')
    decodes = []
    read = SuperResImages.read_image
    monkeypatch.setattr(SuperResImages, 'read_image',
                        staticmethod(lambda f: decodes.append(f) or read(f)))
    _cli(dirs, models, str(tmp_path / 'first'), 'qrcan', '--decoded_cache_dir', cache)
    first = len(decodes)
    _cli(dirs, models, str(tmp_path / 'second'), 'qrcan', '--decoded_cache_dir', cache)
    assert first == 2 * len(HR_SIZES) and len(decodes) == first
    assert len(os.listdir(cache)) == 2 * len(HR_SIZES)
    _cli(dirs, models, str(tmp_path / 'buckets'), 'qrcan', '--eval_buckets', '8')
    plain, bucketed = _metrics(str(tmp_path / 'first'))[0], _metrics(
        str(tmp_path / 'buckets'))[0]
    for met, bar in (('PSNR', 1e-4), ('SSIM', 1e-6)):
        np.testing.assert_allclose(bucketed[('torch_qrcan', met)],
                                   plain[('torch_qrcan', met)], atol=bar, rtol=0)
    for image in sorted(os.listdir(dirs['hr'])):
        a, b = (np.asarray(Image.open(os.path.join(str(tmp_path / run), 'r', 'torch_qrcan',
                                                   image))) for run in ('first', 'buckets'))
        assert np.abs(a.astype(int) - b).max() <= 1


def test_int8_standard_matches_int8_fused_and_takes_precedence(workload, tmp_path):
    """--int8 on the standard protocol against the fused protocol on the same images
    and batches (one calibration batch alike): within the bars; with --eval_buckets
    the int8 program still runs unpadded (sisr_tpu's order)."""
    _, dirs, models = workload
    same_size = [n for n, s in zip(sorted(os.listdir(dirs['hr'])), HR_SIZES)
                 if s == (48, 48)]
    shortlist = tmp_path / 'shortlist.txt'
    shortlist.write_text('\n'.join(same_size) + '\n')
    base = ['--image_shortlist', str(shortlist), '--batch_size', '2', '--int8',
            '--no_image_comparison']
    out = str(tmp_path / 'int8')
    for results, extra in (('standard', []), ('fused', ['--fused_eval']),
                           ('buckets', ['--eval_buckets', '8'])):
        args = ['--hr_dir', dirs['hr'], '--lr_dir', dirs['lr'], '-me', 'torch_rcan', '0',
                '--model_loc', models, '--out_loc', out, '--results_name', results,
                '-m', 'PSNR', '-m', 'SSIM', '--full_directory', '--no-gpu', *base, *extra]
        net_eval.eval_run.main(args=args, standalone_mode=False)
    standard, fused, buckets = (_metrics(out, r)[0] for r in ('standard', 'fused', 'buckets'))
    assert len(standard) == 2
    for met, bar in BARS.items():
        np.testing.assert_allclose(standard[('torch_rcan', met)],
                                   fused[('torch_rcan', met)], atol=bar, rtol=0)
        np.testing.assert_array_equal(buckets[('torch_rcan', met)],
                                      standard[('torch_rcan', met)])


def _train_config(path, results, dirs, experiment, fused_val, metrics=('PSNR', 'SSIM')):
    data_set = {'lr': dirs['lr_meta'], 'hr': dirs['hr'], 'degradation_metadata': 'on_site',
                'metadata': ['blur_kernel']}
    internal = {**{k: v for k, v in QRCAN.items() if k != 'scale'}, 'scale': 4, 'lr': 1e-3}
    toml_io.dump({
        'experiment': experiment, 'experiment_save_loc': results,
        'data': {'batch_size': 1, 'dataloader_threads': 1,
                 'training_sets': {'data_1': {**data_set, 'crop': 8}},
                 'eval_sets': {'data_1': {**data_set, 'cutoff': len(HR_SIZES)}}},
        'model': {'name': 'qrcan', 'internal_params': internal},
        'training': {'gpu': 'off', 'seed': 8, 'metrics': list(metrics),
                     'logging': 'none', 'save_samples': True,
                     **({'fused_val': True} if fused_val else {})}}, path)
    return path


def test_standard_validation_matches_sisr_tpu(workload, tmp_path):
    """train_sisr with no fused_val key (the standard validation epoch) for 2 epochs in
    both packages from the same weights: val-loss, val-PSNR and val-SSIM within the
    bars; in the port, a fused validation of the same checkpoint gives the same
    numbers; an unknown metric fails in the validation epoch, as in sisr_tpu."""
    _, dirs, _ = workload
    results = str(tmp_path / 'Results')
    port = define_model('qrcan', device='cpu', seed=5, **{**QRCAN, 'lr': 1e-3})
    theirs = jax_define_model('qrcan', eval_mode=False, **{**QRCAN, 'lr': 1e-3})
    theirs.set_metadata_keys(['blur_kernel'] * 10)
    theirs.init_state(spatial=(8, 8), batch=1)
    sd = {k: v.numpy().copy() for k, v in port.module.state_dict().items()}
    theirs.state = theirs.state.replace(params=convert_torch_state_dict(
        'qrcan', sd, n_resgroups=1, n_resblocks=2, scale=4, style='max_concat',
        include_q_layer=True))
    for name, handler in (('port', port), ('jax', theirs)):
        base = os.path.join(results, name)
        os.makedirs(os.path.join(base, 'saved_models'))
        os.makedirs(os.path.join(base, 'result_outputs'))
        toml_io.dump({'model': {'name': 'qrcan', 'internal_params': QRCAN}},
                     os.path.join(base, 'config.toml'))
        handler.save_model('train_model', 0, os.path.join(base, 'saved_models'))
        handler.wait_pending_checkpoints()
        pd.DataFrame({'epoch': [0], 'train-loss': [1.0], 'learning-rate': [1e-3],
                      'val-loss': [1.0], 'val-PSNR': [0.0], 'val-SSIM': [0.0]}).to_csv(
            os.path.join(base, 'result_outputs', 'summary.csv'), index=False)
    for cli, name in ((net_train.experiment_setup, 'port'), (jax_experiment_setup, 'jax')):
        cfg = _train_config(str(tmp_path / (name + '.toml')), results, dirs, name, False)
        cli.main(args=['--parameters', cfg, '--num_epochs', '2', '--continue_from_epoch',
                       '0'], standalone_mode=False)
    ours, theirs = (pd.read_csv(os.path.join(results, n, 'result_outputs', 'summary.csv'))
                    for n in ('port', 'jax'))
    assert list(ours.columns) == list(theirs.columns)
    assert list(ours['epoch']) == list(theirs['epoch']) == [0, 1, 2]
    for key, bar in (('val-loss', 5e-4), ('val-PSNR', 0.01), ('val-SSIM', 1e-3)):
        np.testing.assert_allclose(ours[key][1:], theirs[key][1:], atol=bar, rtol=0,
                                   err_msg=key)
    samples = os.path.join(results, 'port', 'result_outputs', 'epoch_2_samples')
    assert os.listdir(samples) == ['im_0.png']

    # the same checkpoint through the fused and the standard validation epoch
    cfg = toml_io.load(_train_config(str(tmp_path / 'v.toml'), results, dirs, 'port', True))
    handler = TrainingHandler(experiment_name='port', save_loc=results,
                              model_params=cfg['model'], data_params=cfg['data'],
                              gpu='off', num_epochs=1, continue_from_epoch=2,
                              metrics=['PSNR', 'SSIM'], save_samples=False, fused_val=True)
    assert handler._use_fused_val()
    fused = handler.eval(3)
    handler.fused_val = False
    host = handler.eval(3)
    np.testing.assert_allclose(fused['val-loss'], host['val-loss'], rtol=1e-4, atol=1e-6)
    for met, bar in BARS.items():
        np.testing.assert_allclose(fused['val-' + met], host['val-' + met], atol=bar, rtol=0)
    assert handler.eval(3)['val-PSNR'] == host['val-PSNR']

    unknown = TrainingHandler(experiment_name='port', save_loc=results,
                              model_params=cfg['model'], data_params=cfg['data'],
                              gpu='off', num_epochs=1, continue_from_epoch=2,
                              metrics=['LPIPS'], save_samples=False, fused_val=True)
    assert not unknown._use_fused_val()
    with pytest.raises(ValueError, match='Unknown metric LPIPS'):
        unknown.eval(3)
