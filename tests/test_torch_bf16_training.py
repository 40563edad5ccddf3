"""sisr_tpu_torch's bf16 training, directory checkpoints and bf16 moments on the CPU:
bf16 train steps of a narrow Q-RCAN against sisr_tpu's bf16 steps on the same weights,
the CA op's backward in f32 under autocast, checkpoints as files and as directories
with and without ``bf16_moments`` (a resume bit-equal to an unbroken run in f32; a
file and a directory replacing each other; sisr_tpu's orbax directory refused with the
route that works), and train_sisr at a tiny size with all of them: bf16, online
degradation in the train step, directory checkpoints with bf16 moments, a resume and
eval_sisr --fused_eval of the best epoch from its directory.

Bars: bf16 losses rtol 1e-4 of sisr_tpu's over 3 steps (measured on this CPU: at most
1.9e-5; the port's own f32 steps are 1.9e-4 away from its bf16 ones, so the bar tells
the types apart); the CA's grads under autocast equal to plain autograd of the f32
inputs (the same f32 computation); restored bf16 moments equal to the saved moments
rounded to bf16; the f32 resume bit-equal."""
import os

import numpy as np
import pytest
import torch

from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu.utils import orbax_ckpt as jax_orbax_ckpt
from sisr_tpu_torch import net_eval, net_train
from sisr_tpu_torch.data import datasets as torch_datasets
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.utils import async_ckpt, toml_io

QRCAN = {'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 16, 'style': 'max_concat',
         'include_q_layer': True, 'metadata': ['blur_kernel']}
CONVERT = {'n_resgroups': 2, 'n_resblocks': 2, 'style': 'max_concat',
           'include_q_layer': True}
KEYS = ['blur_kernel'] * 10
EDSR = {'scale': 2, 'num_features': 8, 'num_blocks': 1, 'lr': 1e-3}


def _batches(n, lr_size=32, seed=0):
    rng = np.random.RandomState(seed)
    return [{'lr': rng.rand(2, lr_size, lr_size, 3).astype(np.float32),
             'hr': rng.rand(2, 2 * lr_size, 2 * lr_size, 3).astype(np.float32),
             'metadata': rng.rand(2, 10).astype(np.float32)} for _ in range(n)]


def test_bf16_train_steps_match_sisr_tpu():
    port = define_model('qrcan', device='cpu', seed=3, scale=2, lr=1e-4, dtype='bf16',
                        **QRCAN)
    port.set_metadata_keys(KEYS)
    sd = {k: v.detach().numpy().copy() for k, v in port.module.state_dict().items()}
    theirs = jax_define_model('qrcan', eval_mode=False, scale=2, lr=1e-4, dtype='bf16',
                              **QRCAN)
    theirs.set_metadata_keys(KEYS)
    theirs.init_state(spatial=(8, 8), batch=2)
    theirs.state = theirs.state.replace(params=convert_torch_state_dict(
        'qrcan', sd, scale=2, **CONVERT))
    batches = _batches(3)
    ours = [float(port.run_train(**b)[0]) for b in batches]
    ref = [float(theirs.run_train(**b)[0]) for b in batches]
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=0)
    # f32 parameters, grads and moments under the bf16 forward (flax's param_dtype)
    assert {p.dtype for p in port.module.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in port.module.parameters()} == {torch.float32}
    assert {v.dtype for s in port.optimizer.state.values() for k, v in s.items()
            if k in async_ckpt.MOMENT_KEYS} == {torch.float32}


@pytest.mark.parametrize('extras', ['none', 'meta_gate'])
def test_ca_backward_is_f32_under_autocast(extras):
    """A bf16 map with f32 weights under autocast: the forward keeps the map's type,
    and the grads are plain autograd's of the f32 inputs, each in its input's type."""
    rng = np.random.RandomState(1)
    x32 = torch.from_numpy(rng.randn(2, 6, 5, 16).astype(np.float32)).bfloat16().float()
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.3)
              for s in ((16 + 3, 4), (4,), (4, 16), (16,))]
    meta = torch.from_numpy(rng.rand(2, 3).astype(np.float32))
    gate = torch.from_numpy(rng.rand(2, 16).astype(np.float32))
    if extras == 'none':
        params[0] = params[0][:16].contiguous()
        meta = gate = None
    grad_out = torch.from_numpy(rng.randn(2, 6, 5, 16).astype(np.float32)).bfloat16()

    x = x32.bfloat16().requires_grad_(True)
    leaves = [p.clone().requires_grad_(True) for p in params]
    with torch.autocast('cpu', dtype=torch.bfloat16):
        out = ca.fused_channel_attention(x, *leaves, meta=meta, gate=gate)
    assert out.dtype == torch.bfloat16
    out.backward(grad_out)

    x_ref = x32.clone().requires_grad_(True)
    ref_leaves = [p.clone().requires_grad_(True) for p in params]
    ref = ca.reference_channel_attention(x_ref, *ref_leaves, meta, gate)
    ref.backward(grad_out.float())
    assert x.grad.dtype == torch.bfloat16
    torch.testing.assert_close(x.grad, x_ref.grad.bfloat16(), atol=0, rtol=0)
    for got, want in zip(leaves, ref_leaves):
        assert got.grad.dtype == torch.float32
        torch.testing.assert_close(got.grad, want.grad, atol=0, rtol=0)


# --- checkpoints ----------------------------------------------------------------------------
def _edsr(**kwargs):
    return define_model('edsr', device='cpu', seed=5, **{**EDSR, **kwargs})


def _steps(handler, batches):
    for batch in batches:
        handler.run_train(lr=batch['lr'][..., :8, :8, :], hr=batch['hr'][..., :16, :16, :])


@pytest.mark.parametrize('backend', ['msgpack', 'orbax'])
@pytest.mark.parametrize('checkpoint_dtype', ['f32', 'bf16_moments'])
def test_checkpoint_round_trip(tmp_path, backend, checkpoint_dtype):
    batches = _batches(4, lr_size=8, seed=2)
    options = {'checkpoint_backend': backend, 'checkpoint_dtype': checkpoint_dtype}
    saved = _edsr(**options)
    _steps(saved, batches[:2])
    saved.set_epoch(1)
    saved.save_model('train_model', 1, str(tmp_path), background=True)
    saved.wait_pending_checkpoints()
    path = tmp_path / 'train_model_1'
    assert path.is_dir() == (backend == 'orbax')
    if backend == 'orbax':
        assert sorted(os.listdir(path)) == ['handler_meta.json', 'network.pt',
                                            'optimizer.pt']
        on_disk = torch.load(path / 'optimizer.pt', weights_only=True)
    else:
        on_disk = torch.load(path, weights_only=True)['optimizer']
    narrow = checkpoint_dtype == 'bf16_moments'
    moments = [(i, k, v) for i, s in on_disk['state'].items() for k, v in s.items()
               if k in async_ckpt.MOMENT_KEYS]
    assert len(moments) == 2 * len(list(saved.module.parameters()))
    assert {v.dtype for _, _, v in moments} == {torch.bfloat16 if narrow else torch.float32}

    resumed = _edsr(**options)
    resumed.load_model('train_model', 1, str(tmp_path))
    assert resumed.step == 2 and resumed.curr_epoch == 1
    for (index, key, disk), live in zip(moments, (
            resumed.optimizer.state[p][k] for p in resumed.module.parameters()
            for k in async_ckpt.MOMENT_KEYS)):
        assert live.dtype == torch.float32
        want = saved.optimizer.state[list(saved.module.parameters())[index]][key]
        torch.testing.assert_close(live, want.bfloat16().float() if narrow else want,
                                   atol=0, rtol=0)
    for a, b in zip(saved.module.parameters(), resumed.module.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # two more steps each: in f32 the resume continues bit-equal to the unbroken run
    _steps(saved, batches[2:])
    _steps(resumed, batches[2:])
    for a, b in zip(saved.module.parameters(), resumed.module.parameters()):
        if narrow:
            assert torch.isfinite(b).all()
        else:
            torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_file_and_directory_checkpoints_replace_each_other(tmp_path):
    handler = _edsr(checkpoint_backend='orbax')
    path = tmp_path / 'train_model_0'
    handler.save_model('train_model', 0, str(tmp_path))
    assert path.is_dir()
    handler.checkpoint_backend = 'msgpack'
    handler.save_model('train_model', 0, str(tmp_path))
    assert path.is_file()
    handler.checkpoint_backend = 'orbax'
    handler.save_model('train_model', 0, str(tmp_path))
    assert path.is_dir() and os.listdir(tmp_path) == ['train_model_0']
    assert _edsr().load_model('train_model', 0, str(tmp_path))['model_name'] == 'edsr'
    with pytest.raises(ValueError, match='checkpoint_backend'):
        _edsr(checkpoint_backend='zarr')


def test_sisr_tpu_orbax_directory_is_refused_with_the_route_that_works(tmp_path):
    """A directory in the layout of sisr_tpu's orbax backend (its tree and its meta
    sidecar, by sisr_tpu's own names) raises, naming the msgpack route and the bridge."""
    path = tmp_path / 'train_model_0'
    os.makedirs(path / jax_orbax_ckpt._TREE_NAME)
    (path / jax_orbax_ckpt._META_NAME).write_text(
        '{"model_name": "edsr", "model_epoch": 0, "step": 0}')
    with pytest.raises(RuntimeError, match='msgpack.*state_dict_from_jax'):
        _edsr().load_model('train_model', 0, str(tmp_path))


# --- train_sisr in bf16 on device-degraded data, directory checkpoints ----------------------
@pytest.fixture
def few_pca_kernels(monkeypatch):
    """The online degradation's PCA from 300 kernels (30000 in a real run): the
    path is under test here, the PCA in tests/test_torch_degradations.py."""
    monkeypatch.setattr(torch_datasets, 'PCA_KERNELS', 300)


def test_train_sisr_bf16_device_degradation_directory_checkpoints(tmp_path,
                                                                  few_pca_kernels):
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 6, lr_size=10, scale=2,
                                    metadata_cols=10)
    internal = {'scale': 2, 'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16,
                'style': 'standard', 'include_q_layer': True,
                'metadata': ['blur_kernel'], 'lr': 1e-3, 'dtype': 'bf16',
                'checkpoint_backend': 'orbax', 'checkpoint_dtype': 'bf16_moments'}
    results = str(tmp_path / 'Results')
    cfg = str(tmp_path / 'run.toml')
    toml_io.dump({
        'experiment': 'online', 'experiment_save_loc': results,
        'data': {'batch_size': 2, 'dataloader_threads': 1,
                 'training_sets': {'data_1': {
                     'hr': hr_dir, 'crop': 4, 'online_degradations': True,
                     'online_degradation_params': {'device': True, 'noise': False}}},
                 'eval_sets': {'data_1': {'lr': lr_dir, 'hr': hr_dir, 'cutoff': 3,
                                          'degradation_metadata': 'on_site',
                                          'metadata': ['blur_kernel']}}},
        'model': {'name': 'qrcan', 'internal_params': internal},
        'training': {'gpu': 'off', 'seed': 8, 'metrics': ['PSNR', 'SSIM'],
                     'logging': 'none', 'fused_val': True}}, cfg)
    seen = []
    forward = define_model.__globals__['BaseHandler'].forward

    def spy(self, x, metadata=None):
        seen.append((float(x.abs().max()), x.dtype))
        return forward(self, x, metadata)

    define_model.__globals__['BaseHandler'].forward = spy
    try:
        for args in (['--num_epochs', '2'], ['--num_epochs', '1', '--continue_from_epoch',
                                             '1']):
            net_train.experiment_setup.main(args=['--parameters', cfg, *args],
                                            standalone_mode=False)
    finally:
        define_model.__globals__['BaseHandler'].forward = forward
    saved = os.path.join(results, 'online', 'saved_models')
    assert sorted(os.listdir(saved)) == ['train_model_0', 'train_model_1', 'train_model_2']
    for epoch in range(3):
        assert os.path.isdir(os.path.join(saved, 'train_model_%d' % epoch))
    last = async_ckpt.torch.load(os.path.join(saved, 'train_model_2', 'optimizer.pt'),
                                 weights_only=True)
    assert {v.dtype for s in last['state'].values() for k, v in s.items()
            if k in async_ckpt.MOMENT_KEYS} == {torch.bfloat16}
    # 3 training epochs of 3 steps on degraded HR crops (not the zero placeholder)
    assert len(seen) >= 9 and min(m for m, _ in seen[:3]) > 0.05
    out = str(tmp_path / 'out')
    net_eval.eval_run.main(args=[
        '--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'online', 'best', '--model_loc',
        results, '--out_loc', out, '--results_name', 'r', '-m', 'PSNR', '--batch_size',
        '2', '--scale', '2', '--full_directory', '--fused_eval', '--no_image_comparison',
        '--no-time_models', '--no-gpu'], standalone_mode=False)
    metrics = os.path.join(out, 'r', 'standard_metrics', 'individual_metrics.csv')
    assert os.path.isfile(metrics)
