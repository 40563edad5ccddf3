"""sisr_tpu_torch's FACE_SIM metric against sisr_tpu's on the CPU: the standard protocol
with ``-m PSNR -m SSIM -m FACE_SIM`` run in both packages on 4 small pairs, the same
RCAN weights and one seeded LightCNN-29 file in the reference's checkpoint layout
(the CSV columns equal, FACE_SIM within 1e-5, PSNR/SSIM within the usual bars); the
cosine of the Metrics hub itself; FACE_SIM turns the fused protocol off; --model_only
loads no face weights; a missing weights file raises."""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
from sisr_tpu.models.feature_extractors import load_face_extractor as jax_face
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.ops.metrics import Metrics as JaxMetrics
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval
from sisr_tpu_torch.evaluation.standard_eval import EvalHub
from sisr_tpu_torch.models.feature_extractors import LightCNN29, load_face_extractor
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops.metrics import Metrics
from sisr_tpu_torch.tools.convert_weights import state_dict_from_jax
from sisr_tpu_torch.utils import toml_io

RCAN = {'scale': 4, 'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 16}


@pytest.fixture(scope='module')
def workload(tmp_path_factory):
    """4 pairs 12² -> 48², RCAN experiments of the same weights for both packages, and
    a LightCNN-29 checkpoint (10 classes, numpy-seeded weights, 'module.' keys under
    'state_dict')."""
    root = str(tmp_path_factory.mktemp('face_sim'))
    lr_dir, hr_dir = build_workload(os.path.join(root, 'data'), 4, lr_size=12, scale=4)
    models = os.path.join(root, 'Results')
    theirs = jax_define_model('rcan', eval_mode=True, **RCAN)
    theirs.init_state(spatial=(12, 12))
    params = jax.tree.map(np.asarray, theirs.state.params)
    port = define_model('rcan', device='cpu', **RCAN)
    port.module.load_state_dict(state_dict_from_jax('rcan', params))
    for package, handler in (('jax', theirs), ('torch', port)):
        base = os.path.join(models, '%s_rcan' % package)
        os.makedirs(os.path.join(base, 'saved_models'))
        toml_io.dump({'model': {'name': 'rcan', 'internal_params': RCAN}},
                     os.path.join(base, 'config.toml'))
        handler.save_model('train_model', 0, os.path.join(base, 'saved_models'))
    theirs.wait_pending_checkpoints()
    face = LightCNN29(10)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in face.parameters():
            std = np.sqrt(0.25 / np.prod(p.shape[1:])) if p.dim() > 1 else 0.01
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape, dtype=np.float32) * std))
    weights = os.path.join(root, 'LightCNN_29Layers_checkpoint.pth.tar')
    torch.save({'state_dict': {'module.' + k: v for k, v in face.state_dict().items()}},
               weights)
    return {'lr': lr_dir, 'hr': hr_dir, 'models': models, 'weights': weights, 'root': root}


def _frames(out):
    return [pd.read_csv(os.path.join(out, 'r', 'standard_metrics', f), header=[0, 1],
                        index_col=0) for f in ('individual_metrics.csv',
                                               'average_metrics.csv')]


def _cli(w, out, *extra):
    net_eval.eval_run.main(args=[
        '--hr_dir', w['hr'], '--lr_dir', w['lr'], '-me', 'torch_rcan', '0', '--model_loc',
        w['models'], '--out_loc', out, '--results_name', 'r', '-m', 'PSNR', '-m', 'SSIM',
        '-m', 'FACE_SIM', '--face_model', 'lightcnn', '--face_weights', w['weights'],
        '--full_directory', '--no_image_comparison', '--no-gpu', *extra],
        standalone_mode=False)


def test_face_sim_cli_matches_sisr_tpu(workload, tmp_path):
    ours_out, theirs_out = str(tmp_path / 'port'), str(tmp_path / 'ref')
    _cli(workload, ours_out)
    JaxEvalHub(hr_dir=workload['hr'], lr_dir=workload['lr'], results_name='r', gpu=False,
               metrics=['PSNR', 'SSIM', 'FACE_SIM'], data_split=None, save_im=False,
               batch_size=1, full_directory=True, lr_dir_interp=None, model_only=False,
               scale=4, model_loc=workload['models'], out_loc=theirs_out,
               use_test_group=False, no_image_comparison=True, num_image_save=100,
               qpi_selection=(None, None), data_attributes=None, dataset_name=None,
               image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=True,
               recursive=False, face_model='lightcnn', face_weights=workload['weights'],
               model_and_epoch=[('jax_rcan', '0')]).full_image_protocol()
    for ours, theirs in zip(_frames(ours_out), _frames(theirs_out)):
        assert [('jax_rcan' if c[0] == 'torch_rcan' else c[0], c[1])
                for c in ours.columns] == list(theirs.columns)
    ours, theirs = _frames(ours_out)[0], _frames(theirs_out)[0]
    assert ('LR', 'FACE_SIM') in ours.columns and ('torch_rcan', 'FACE_SIM') in ours.columns
    for ours_side, theirs_side in (('LR', 'LR'), ('torch_rcan', 'jax_rcan')):
        np.testing.assert_allclose(ours[(ours_side, 'FACE_SIM')],
                                   theirs[(theirs_side, 'FACE_SIM')], atol=1e-5, rtol=0)
        for met, bar in (('PSNR', 0.01), ('SSIM', 1e-3)):
            np.testing.assert_allclose(ours[(ours_side, met)], theirs[(theirs_side, met)],
                                       atol=bar, rtol=0)
    sims = ours[[('LR', 'FACE_SIM'), ('torch_rcan', 'FACE_SIM')]].to_numpy()
    assert np.all(np.abs(sims) <= 1 + 1e-6)


def test_metrics_hub_face_sim_matches_sisr_tpu(workload):
    rng = np.random.RandomState(2)
    a, b = rng.rand(3, 40, 36, 3), rng.rand(3, 40, 36, 3)
    ours = Metrics(['FACE_SIM'], face_extractor=load_face_extractor(
        'lightcnn', workload['weights'], device='cpu'))
    theirs = JaxMetrics(['FACE_SIM'], face_extractor=jax_face('lightcnn',
                                                              workload['weights']))
    for single in (True, False):
        np.testing.assert_allclose(
            ours.run_image_metric('FACE_SIM', a, b, single_values=single),
            theirs.run_image_metric('FACE_SIM', a, b, single_values=single),
            atol=1e-5, rtol=0)
    assert ours.run_image_metric('FACE_SIM', a, a, single_values=False) == \
        pytest.approx(1.0, abs=1e-6)
    with pytest.raises(RuntimeError, match='face extractor'):
        Metrics(['FACE_SIM']).run_image_metric('FACE_SIM', a, b)


def test_face_sim_turns_fused_off_and_model_only_skips_weights(workload, tmp_path, capsys):
    """--fused_eval with FACE_SIM runs the standard protocol (with sisr_tpu's notice);
    --model_only computes no metric and reads no face weights; without a weights
    file the metric raises."""
    out = str(tmp_path / 'fused')
    _cli(workload, out, '--fused_eval')
    assert 'fused_eval needs metrics and no image outputs' in capsys.readouterr().out
    assert ('torch_rcan', 'FACE_SIM') in _frames(out)[0].columns
    kwargs = dict(hr_dir=workload['hr'], lr_dir=workload['lr'], results_name='m', gpu=False,
                  metrics=['PSNR', 'FACE_SIM'], data_split=None, save_im=False, batch_size=1,
                  full_directory=True, lr_dir_interp=None, scale=4,
                  model_loc=workload['models'], out_loc=str(tmp_path / 'm'),
                  use_test_group=False, no_image_comparison=True, num_image_save=100,
                  qpi_selection=(None, None), data_attributes=None, dataset_name=None,
                  image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=False,
                  recursive=False, face_model='lightcnn',
                  face_weights=str(tmp_path / 'missing.pth'),
                  model_and_epoch=[('torch_rcan', '0')])
    hub = EvalHub(model_only=True, **kwargs)
    assert not hub.face_metric and hub.metric_hub.face_extractor is None
    hub.direct_model_protocol()
    assert len(os.listdir(os.path.join(str(tmp_path / 'm'), 'm', 'torch_rcan'))) == 4
    with pytest.raises(RuntimeError, match='No lightcnn weights'):
        EvalHub(model_only=False, **kwargs)
