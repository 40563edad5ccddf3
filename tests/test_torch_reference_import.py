"""The reference's whole checkpoint layout and its import, on the CPU.

A Q-RCAN checkpoint as the reference saves it — ``network``, torch's own Adam
``optimizer`` state, ``scheduler_G`` (MultiStepLR or CosineAnnealingWarmRestarts), the
legacy ``model_name`` 'qpircan' and ``model_epoch`` — loads with ``weights_only``:
``load_model`` reads it for eval, and for a resumed train run that keeps the step
count (the Adam state's updates); ``import_reference_experiment`` (and its CLI) turns
it into an experiment that ``eval_sisr`` runs, with sisr_tpu's config and structure
flags (``infer_structure_kwargs``); ``--verify`` without the reference code tree says
so and exits non-zero."""
import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from sisr_tpu.tools.convert_weights import infer_structure_kwargs as jax_infer
from sisr_tpu_torch import net_eval
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.models.interface import ModelInterface
from sisr_tpu_torch.tools import convert_weights
from sisr_tpu_torch.utils import toml_io

QRCAN = {'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 4,
         'style': 'standard', 'include_q_layer': True, 'metadata': ['blur_kernel']}
SCHEDULERS = {
    'multistep': lambda opt: torch.optim.lr_scheduler.MultiStepLR(opt, [2, 4], gamma=0.5),
    'cosine_warm_restarts': lambda opt: torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(
        opt, T_0=3, eta_min=1e-7)}


def _reference_checkpoint(path, scheduler, updates=3, seed=5):
    """A reference-layout Q-RCAN checkpoint after ``updates`` Adam steps on numpy-seeded
    grads; returns its network state."""
    handler = define_model('qrcan', device='cpu', seed=seed, scale=2, **QRCAN)
    params = list(handler.module.parameters())
    optimizer = torch.optim.Adam(params, lr=1e-4)
    sched = SCHEDULERS[scheduler](optimizer)
    rng = np.random.RandomState(seed)
    for _ in range(updates):
        for p in params:
            p.grad = torch.from_numpy(rng.normal(0, 1e-3, p.shape).astype(np.float32))
        optimizer.step()
        sched.step()
    network = {k: v.clone() for k, v in handler.module.state_dict().items()}
    torch.save({'network': network, 'optimizer': optimizer.state_dict(),
                'scheduler_G': sched.state_dict(), 'model_name': 'qpircan',
                'model_epoch': 7}, path)
    return network, optimizer.state_dict()


@pytest.mark.parametrize('scheduler', sorted(SCHEDULERS))
def test_reference_layout_loads_for_eval_and_resumed_training(tmp_path, scheduler):
    saved = tmp_path / 'saved_models'
    saved.mkdir()
    network, adam = _reference_checkpoint(str(saved / 'train_model_7'), scheduler)
    evaluator = define_model('qrcan', device='cpu', eval_mode=True, scale=2, **QRCAN)
    state = evaluator.load_model('train_model', 7, str(saved))
    assert state['model_name'] == 'qpircan' and evaluator.curr_epoch == 7
    for k, v in evaluator.module.state_dict().items():
        assert torch.equal(v, network[k]), k
    trainer = define_model('qrcan', device='cpu', scale=2, **QRCAN)
    trainer.load_model('train_model', 7, str(saved))
    assert trainer.step == 3  # the updates the reference's Adam made, not 0
    ours = trainer.optimizer.state_dict()['state']
    for index, entry in adam['state'].items():
        assert torch.equal(ours[index]['exp_avg'], entry['exp_avg'])
        assert int(ours[index]['step']) == 3
    trainer.set_metadata_keys(['blur_kernel'] * 10)
    rng = np.random.RandomState(1)
    trainer.run_train(lr=rng.rand(2, 8, 8, 3).astype(np.float32),
                      hr=rng.rand(2, 16, 16, 3).astype(np.float32),
                      metadata=rng.rand(2, 10).astype(np.float32))
    assert trainer.step == 4


def test_infer_structure_kwargs_matches_sisr_tpu():
    cases = [define_model('qrcan', device='cpu', scale=2, **QRCAN),
             define_model('qrcan', device='cpu', scale=2, **{**QRCAN, 'include_q_layer': False}),
             define_model('qrcan', device='cpu', scale=2, include_pixel_attention=True,
                          selective_meta_blocks=[True, False], **QRCAN),
             define_model('rcan', device='cpu', scale=2, n_resgroups=1, n_resblocks=1,
                          n_feats=16, reduction=4)]
    for handler, name in zip(cases, ('qpircan', 'qrcan', 'qrcan', 'rcan')):
        keys = {k: v.numpy() for k, v in handler.module.state_dict().items()}
        assert convert_weights.infer_structure_kwargs(name, keys) == jax_infer(name, keys)
    assert convert_weights.infer_structure_kwargs(
        'qrcan', cases[2].module.state_dict()) == {
            'include_q_layer': True, 'selective_meta_blocks': [True, False],
            'include_pixel_attention': True}


def test_import_writes_an_experiment_eval_sisr_runs(tmp_path):
    """The CLI's import (config with the inferred flags, the port's checkpoint with a
    fresh Adam state and the reference's epoch), then eval_sisr on it: the live
    model's output."""
    from sisr_tpu.tools.e2e_bench import build_workload
    network, _ = _reference_checkpoint(str(tmp_path / 'qpircan_x2.pth'), 'multistep')
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 2, lr_size=8, scale=2,
                                    metadata_cols=10)
    base = convert_weights.import_reference_experiment(
        str(tmp_path / 'qpircan_x2.pth'), str(tmp_path / 'Results'), scale=2,
        n_resgroups=2, n_resblocks=2, n_feats=16, reduction=4, style='standard',
        metadata=['blur_kernel'])
    assert os.path.basename(base) == 'qpircan_x2'
    config = toml_io.load(os.path.join(base, 'config.toml'))['model']
    assert config['name'] == 'qrcan' and config['internal_params']['include_q_layer']
    saved = torch.load(os.path.join(base, 'saved_models', 'train_model_7'),
                       weights_only=True)
    assert saved['model_name'] == 'qrcan' and saved['model_epoch'] == 7
    assert saved['step'] == 0 and saved['optimizer']['state'] == {}
    result = CliRunner().invoke(net_eval.eval_run, [
        '--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'qpircan_x2', '7', '--model_loc',
        str(tmp_path / 'Results'), '--out_loc', str(tmp_path / 'out'), '--scale', '2',
        '-m', 'PSNR', '--full_directory', '--fused_eval', '--no_image_comparison',
        '--no-gpu'], catch_exceptions=False)
    assert result.exit_code == 0, result.output
    live = define_model('qrcan', device='cpu', eval_mode=True, scale=2, **QRCAN)
    live.module.load_state_dict(network)
    imported = ModelInterface(str(tmp_path / 'Results'), 'qpircan_x2', load_epoch=7,
                              device='cpu').model
    x = np.random.RandomState(2).rand(1, 8, 8, 3).astype(np.float32)
    meta = np.random.RandomState(3).rand(1, 10).astype(np.float32)
    for handler in (live, imported):
        handler.set_metadata_keys(['blur_kernel'] * 10)
    np.testing.assert_array_equal(imported.run_eval(x, metadata=meta)[0],
                                  live.run_eval(x, metadata=meta)[0])


def test_import_cli_and_verify_without_the_reference_tree(tmp_path, monkeypatch):
    """A bare state_dict (EDSR at its defaults, the CLI passing no structure) imports
    under --model_name; --verify then refuses without the tree; a missing name or a
    structure the weights do not fit raises."""
    torch.save(define_model('edsr', device='cpu', scale=2).module.state_dict(),
               str(tmp_path / 'bare.pth'))
    monkeypatch.delenv('SISR_REFERENCE_CODE', raising=False)
    args = ['--checkpoint', str(tmp_path / 'bare.pth'), '--out_dir', str(tmp_path / 'R'),
            '--model_name', 'edsr', '--epoch', '2', '--scale', '2']
    monkeypatch.setattr('sys.argv', ['import_reference_model_torch'] + args + ['--verify'])
    with pytest.raises(SystemExit) as exc:
        convert_weights.import_reference_model_cli()
    assert 'SISR_REFERENCE_CODE' in str(exc.value.code)
    assert os.path.isfile(str(tmp_path / 'R' / 'bare' / 'saved_models' / 'train_model_2'))
    with pytest.raises(RuntimeError, match='no model_name'):
        convert_weights.import_reference_experiment(str(tmp_path / 'bare.pth'),
                                                    str(tmp_path / 'R2'))
    with pytest.raises(RuntimeError, match='Missing key|Unexpected key|size mismatch'):
        convert_weights.import_reference_experiment(str(tmp_path / 'bare.pth'),
                                                    str(tmp_path / 'R3'), model_name='edsr',
                                                    num_blocks=8)
