"""sisr_tpu_torch's SRMD against sisr_tpu's on the same weights, on the CPU, and the
channel concat of the metadata maps (``BaseHandler.network_input``) on every path.
Model: 4 convs of 16 features (``nb`` 4, ``nc`` 16), 4x, 10 blur-kernel values, so the
first conv takes 3 + 10 channels.

Each case holds: the concat itself against sisr_tpu's ``network_input``; the f32
forward; the concat made once on every path that builds the module's input (the eval
step, the bucketed step, the int8 program and its calibration, the fused step, the
train step, the epoch samples), with the fused step's LR baseline from the RGB LR;
the bf16 autocast; the fused eval (f32 and bf16); eval_sisr --fused_eval and the
standard protocol end to end; --eval_buckets against the unbucketed run; the weights
bridge through sisr_tpu's converter (KAIR's ``model.<2i>`` keys read as they are), a
reference checkpoint loaded strictly, and the full-size model's keys and shapes;
training against sisr_tpu's and train_sisr on the shipped recipe's model.  int8 is in
test_torch_int8_sftmd.py.

Bars: the concat bit-equal; the forward 5e-4 abs in f32; PSNR within 0.01 dB and
SSIM within 1e-3 per image; bucketed against unbucketed 2e-6; training losses rtol
2e-4, parameters 5e-5 after the steps."""
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

import jax
import jax.numpy as jnp

from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval, net_train
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.tools.convert_weights import (params_from_state_dict,
                                                  repair_reference_keys, state_dict_from_jax)
from sisr_tpu_torch.utils import toml_io

KEYS = ['blur_kernel'] * 10
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}
FAMILIES = {'srmd': ('srmd', {'scale': 4, 'nc': 16, 'nb': 4, 'metadata': ['blur_kernel']})}
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_handler(case, dtype=None, params=None, families=FAMILIES, **kwargs):
    """sisr_tpu's handler of ``families[case]`` (with ``params`` when given)."""
    name, cfg = families[case]
    handler = jax_define_model(name, eval_mode=True, dtype=dtype, **{**cfg, **kwargs})
    handler.set_metadata_keys(keys_of(cfg))
    handler.init_state(spatial=(16, 16))
    if params is not None:
        handler.state = handler.state.replace(params=jax.tree.map(jnp.asarray, params))
    return handler


def keys_of(cfg):
    return ['qpi'] if cfg['metadata'] == ['qpi'] else KEYS


def params_of(handler):
    return jax.tree.map(np.asarray, handler.state.params)


def port_handler(case, params, families=FAMILIES, **kwargs):
    """The port's handler of ``families[case]`` on sisr_tpu's ``params``."""
    name, cfg = families[case]
    handler = define_model(name, device='cpu', **{**cfg, **kwargs})
    handler.set_metadata_keys(keys_of(cfg))
    handler.module.load_state_dict(state_dict_from_jax(name, params))
    return handler


@pytest.fixture(scope='module')
def jax_model():
    """(case, dtype) -> sisr_tpu's handler; every dtype of a case on one set of
    weights."""
    cache = {}

    def get(case, dtype=None):
        if (case, dtype) not in cache:
            params = params_of(cache[case, None]) if (case, None) in cache else None
            if dtype is not None and params is None:
                params = params_of(get(case))
            cache[case, dtype] = jax_handler(case, dtype, params)
        return cache[case, dtype]
    return get


def inputs(seed, n_meta=10, n=2, size=(13, 15)):
    rng = np.random.RandomState(seed)
    return rng.rand(n, *size, 3).astype(np.float32), rng.rand(n, n_meta).astype(np.float32)


def forward_both(jax_h, port, x, meta):
    """Each handler's f32 forward of its own prepared input: (ours, theirs)."""
    xj, _, mj = jax_h._prep_batch({'lr': jnp.asarray(x), 'metadata': jnp.asarray(meta)})
    kwargs = {} if mj is None else {'metadata': mj}
    theirs = np.asarray(jax_h.state.apply_fn({'params': jax_h.state.params}, xj, **kwargs))
    with torch.inference_mode():
        xt, _, mt = port._prep_batch({'lr': torch.from_numpy(x),
                                      'metadata': torch.from_numpy(meta)})
        ours = port.forward(xt, mt).numpy()
    return ours, theirs


def test_network_input_matches_sisr_tpu(jax_model):
    """The metadata broadcast to maps and concatenated after the RGB channels, bit-equal
    to sisr_tpu's; the module takes 13 channels and no metadata argument."""
    jax_h = jax_model('srmd')
    port = port_handler('srmd', params_of(jax_h))
    x, meta = inputs(0)
    theirs = np.asarray(jax_h.network_input(jnp.asarray(x), jnp.asarray(meta)))
    ours = port.network_input(torch.from_numpy(x), torch.from_numpy(meta))
    assert ours.shape == (2, 13, 15, 13)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(ours[:, 4, 7, 3:].numpy(), meta)
    assert port.module_input_channels == jax_h.module_input_channels == 13
    assert not port.module_takes_metadata and port.channel_concat
    xt, _, mt = port._prep_batch({'lr': torch.from_numpy(x), 'metadata': torch.from_numpy(meta)})
    assert mt is None and torch.equal(xt, ours)


def test_forward_matches_sisr_tpu_f32(jax_model):
    jax_h = jax_model('srmd')
    ours, theirs = forward_both(jax_h, port_handler('srmd', params_of(jax_h)), *inputs(1))
    assert ours.shape == theirs.shape == (2, 52, 60, 3)
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=0)


def uint8_batch(seed, n=3, lr=16, n_meta=10, scale=4):
    rng = np.random.RandomState(seed)
    return {'lr': rng.randint(0, 256, (n, lr, lr, 3)).astype(np.uint8),
            'hr': rng.randint(0, 256, (n, scale * lr, scale * lr, 3)).astype(np.uint8),
            'metadata': rng.rand(n, n_meta).astype(np.float32)}


def test_the_concat_is_made_once_on_every_path(jax_model, monkeypatch):
    """Every path that builds the module's input concatenates once: the first conv (or
    the int8 program, and its calibration) sees 13 channels; network_input runs once a
    call; the fused step's LR baseline is the RGB LR's bicubic."""
    from sisr_tpu_torch.models import handlers as port_handlers
    port = port_handler('srmd', params_of(jax_model('srmd')))
    calls, widths = [], []
    network_input = port.network_input
    monkeypatch.setattr(port, 'network_input',
                        lambda x, m: calls.append(x.shape[-1]) or network_input(x, m))
    port.module.model[0].register_forward_pre_hook(
        lambda mod, args: widths.append(args[0].shape[1]))
    resized = []
    resize = port_handlers.resize_bicubic
    monkeypatch.setattr(port_handlers, 'resize_bicubic',
                        lambda x, h, w: resized.append(x.shape[-1]) or resize(x, h, w))
    x, meta = inputs(2, size=(16, 16))
    hr = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    batch = uint8_batch(4, n=2)

    def run(path):
        if path == 'eval':
            port.run_eval(x, hr, request_loss=True, metadata=meta)
        elif path == 'buckets':
            port.set_eval_buckets(8)
            port.run_eval(x[:, :13, :11], metadata=meta)
            port.set_eval_buckets(None)
        elif path == 'fused':
            port.run_eval_fused(batch)
        elif path == 'train':
            port.run_train(lr=x, hr=hr, metadata=meta)
        elif path == 'samples':
            port.super_resolve({'lr': x, 'metadata': meta})
        elif path == 'int8':
            port.set_int8(True)
            port.run_eval(x, metadata=meta)
        else:  # int8 fused: the program calibrated above
            port.run_eval_fused(batch)
            port.set_int8(False)

    for path in ('eval', 'buckets', 'fused', 'train', 'samples', 'int8', 'int8_fused'):
        del calls[:], widths[:]
        if path == 'int8_fused':  # calibrated by the int8 path on the 13 channels
            assert port._int8_ctx[1]['conv_0']['kernel'].shape[2] == 13
        run(path)
        assert calls == [3], (path, calls)
        assert widths == ([] if path.startswith('int8') else [13]), (path, widths)
    assert resized == [3, 3]  # both fused steps: the RGB LR


@pytest.mark.parametrize('dtype', [None, 'bf16'])
@pytest.mark.parametrize('case', sorted(FAMILIES))
def test_run_eval_fused_matches_sisr_tpu(jax_model, case, dtype):
    """The fused step on a uint8 batch with its metadata, f32 and bf16."""
    jax_h = jax_model(case, dtype)
    port = port_handler(case, params_of(jax_h), dtype=dtype)
    batch = uint8_batch(5)
    (keys, theirs), _ = jax_h.run_eval_fused(batch)
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert our_keys == keys and ours.shape == (len(keys), 3)
    assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))


def test_bf16_autocast_forward(jax_model):
    """The bf16 forward gives bf16, finite, within bf16's reach of the f32 forward."""
    port = port_handler('srmd', params_of(jax_model('srmd')), dtype='bf16')
    x, meta = inputs(6)
    with torch.inference_mode():
        xt, _, _ = port._prep_batch({'lr': torch.from_numpy(x),
                                     'metadata': torch.from_numpy(meta)})
        out = port.forward(xt)
        port.dtype = torch.float32
        ref = port.forward(xt)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert 0 < (out.float() - ref).abs().max() < 0.05


def assert_metric_rows(keys, ours, theirs):
    for i, key in enumerate(keys):
        bar = BARS[key.split('>')[1]]
        np.testing.assert_allclose(ours[i], theirs[i], atol=bar, rtol=0, err_msg=key)


def read_metrics(out_loc, results):
    return pd.read_csv(os.path.join(out_loc, results, 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


def experiments(model_loc, name, jax_h, port, internal):
    """A jax_exp and a torch_exp experiment of the same weights."""
    for exp in ('jax_exp', 'torch_exp'):
        os.makedirs(os.path.join(model_loc, exp, 'saved_models'))
        toml_io.dump({'model': {'name': name, 'internal_params': internal}},
                     os.path.join(model_loc, exp, 'config.toml'))
    jax_h.save_model('train_model', 0, os.path.join(model_loc, 'jax_exp', 'saved_models'))
    jax_h.wait_pending_checkpoints()
    port.save_model('train_model', 0, os.path.join(model_loc, 'torch_exp', 'saved_models'))


def jax_hub(hr_dir, lr_dir, model_loc, out_loc, batch_size=1, **kwargs):
    return JaxEvalHub(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('jax_exp', '0')],
                      results_name='ref', gpu=False, metrics=['PSNR', 'SSIM'],
                      data_split=None, batch_size=batch_size, full_directory=True,
                      lr_dir_interp=None, model_only=False, scale=4, model_loc=model_loc,
                      out_loc=out_loc, use_test_group=False, num_image_save=100,
                      qpi_selection=(None, None), data_attributes=None, dataset_name=None,
                      image_shortlist=None, metadata_file=None, sp_gpu=0, recursive=False,
                      **kwargs)


def assert_frames(ours, theirs, n):
    assert list(ours.index) == list(theirs.index) and len(ours) == n
    for side_ours, side_theirs in (('LR', 'LR'), ('torch_exp', 'jax_exp')):
        for met, bar in BARS.items():
            np.testing.assert_allclose(ours[(side_ours, met)], theirs[(side_theirs, met)],
                                       atol=bar, rtol=0, err_msg='%s %s' % (side_ours, met))


# HR (h, w) of the mixed-size set
MIXED_HR = ((48, 64), (60, 44), (64, 64))


@pytest.fixture(scope='module')
def mixed(tmp_path_factory):
    """Three LR/HR PNG pairs of different sizes with a blur-kernel CSV and a
    one-value qpi CSV (for the weak SFT type)."""
    root = str(tmp_path_factory.mktemp('concat_mixed'))
    rng = np.random.RandomState(5)
    dirs = {'lr': os.path.join(root, 'lr'), 'hr': os.path.join(root, 'hr')}
    for d in dirs.values():
        os.makedirs(d)
    rows = []
    for i, (h, w) in enumerate(MIXED_HR):
        name = 'im_%d.png' % i
        yy, xx = np.mgrid[0:h, 0:w] / 9.0
        hr = np.stack([np.sin(xx + c) * np.cos(yy * (c + 1)) for c in range(3)], -1)
        hr = np.clip((hr * 0.4 + 0.5) * 255 + rng.normal(0, 8, hr.shape), 0, 255)
        hr_im = Image.fromarray(hr.astype(np.uint8))
        hr_im.save(os.path.join(dirs['hr'], name))
        hr_im.resize((w // 4, h // 4), Image.BICUBIC).save(os.path.join(dirs['lr'], name))
        rows.append('%s,"%s"' % (name, json.dumps(rng.dirichlet(np.ones(10) * 5).tolist())))
    with open(os.path.join(dirs['lr'], 'degradation_metadata.csv'), 'w') as f:
        f.write('image,blur_kernel\n' + '\n'.join(rows) + '\n')
    return dirs['lr'], dirs['hr']


def cli_against_sisr_tpu(tmp_path, jax_h, port, name, internal, lr_dir, hr_dir, fused,
                         n_images, int8=False):
    """eval_sisr --no-gpu (--fused_eval at batch 2, or the standard protocol at batch 1
    with --save_im; with ``int8`` --int8) against sisr_tpu's EvalHub on the same
    weights: the metrics within the bars and, on the standard protocol, each SR image
    within 1 uint8 LSB."""
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    experiments(model_loc, name, jax_h, port, internal)
    extra = ['--fused_eval', '--no-time_models', '--batch_size', '2'] if fused \
        else ['--save_im']
    extra += ['--int8'] if int8 else []
    net_eval.eval_run.main(
        args=['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'torch_exp', '0',
              '--model_loc', model_loc, '--out_loc', out_loc, '--results_name', 'port',
              '-m', 'PSNR', '-m', 'SSIM', '--full_directory', '--no_image_comparison',
              '--no-gpu', *extra], standalone_mode=False)
    jax_hub(hr_dir, lr_dir, model_loc, out_loc, batch_size=2 if fused else 1,
            save_im=not fused, no_image_comparison=True, time_models=not fused,
            fused_eval=fused, int8=int8).full_image_protocol()
    assert_frames(read_metrics(out_loc, 'port'), read_metrics(out_loc, 'ref'), n_images)
    if not fused:
        for image in sorted(os.listdir(hr_dir)):
            a = np.asarray(Image.open(os.path.join(out_loc, 'port', 'torch_exp', image)))
            b = np.asarray(Image.open(os.path.join(out_loc, 'ref', 'jax_exp', image)))
            assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= 1


@pytest.mark.parametrize('protocol', ['fused', 'standard'])
def test_cli_protocols_match_sisr_tpu(tmp_path, jax_model, mixed, protocol):
    jax_h = jax_model('srmd')
    if protocol == 'fused':
        lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=16,
                                        metadata_cols=10)
    else:
        lr_dir, hr_dir = mixed
    cli_against_sisr_tpu(tmp_path, jax_h, port_handler('srmd', params_of(jax_h)), 'srmd',
                         FAMILIES['srmd'][1], lr_dir, hr_dir, protocol == 'fused',
                         4 if protocol == 'fused' else len(MIXED_HR))


def bucketed_against_unbucketed(port, n_meta=10):
    """run_eval of three odd-sized images, unbucketed and with --eval_buckets 8: within
    2e-6 (the pad's metadata maps are non-zero until a conv hook zeroes them)."""
    rng = np.random.RandomState(7)
    images = [rng.rand(1, h, w, 3).astype(np.float32) for h, w in ((13, 17), (9, 20),
                                                                    (16, 16))]
    meta = rng.rand(1, n_meta).astype(np.float32)
    base = [port.run_eval(x, metadata=meta)[0] for x in images]
    port.set_eval_buckets(8)
    assert port.eval_buckets == 8 and not port.supports_fused_eval()
    bucketed = [port.run_eval(x, metadata=meta)[0] for x in images]
    port.set_eval_buckets(None)
    for ref, got in zip(base, bucketed):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)


def test_eval_buckets_match_unbucketed(jax_model):
    bucketed_against_unbucketed(port_handler('srmd', params_of(jax_model('srmd'))))


def test_bridge_round_trips_through_sisr_tpu_converter(jax_model, tmp_path):
    """sisr_tpu tree -> port state_dict (KAIR's model.<2i> keys) -> sisr_tpu's
    convert_torch_state_dict (no prefix strip for SRMD) and the port's reader both
    give the tree back; load_model takes the checkpoint strictly."""
    params = params_of(jax_model('srmd'))
    state = state_dict_from_jax('srmd', params)
    assert sorted(state) == sorted('model.%d.%s' % (2 * i, p) for i in range(4)
                                   for p in ('weight', 'bias'))
    assert repair_reference_keys('srmd', state) is state
    back = convert_torch_state_dict('srmd', {k: v.numpy() for k, v in state.items()}, nb=4)
    ours = jax.tree.map(np.asarray, params_from_state_dict('srmd', state))
    for tree in (back, ours):
        assert jax.tree.structure(tree) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match='unread'):
        params_from_state_dict('srmd', {**state, 'model.9.weight': torch.zeros(1)})
    with pytest.raises(RuntimeError, match='unconsumed'):
        state_dict_from_jax('srmd', {**params, 'stray': {'kernel': np.zeros(1)}})
    base = tmp_path / 'saved_models'
    base.mkdir()
    torch.save({'network': state, 'model_name': 'srmd', 'model_epoch': 2},
               str(base / 'train_model_2'))
    fresh = define_model('srmd', device='cpu', eval_mode=True, seed=9, **FAMILIES['srmd'][1])
    fresh.load_model('train_model', 2, str(base))
    for k, v in fresh.module.state_dict().items():
        torch.testing.assert_close(v, state[k], atol=0, rtol=0)


def recipe_internal(name, keep):
    recipe = toml_io.load(os.path.join(HERE, 'configs', 'div2k', name + '.toml'))
    return {k: v for k, v in recipe['model']['internal_params'].items() if k in keep}


def test_full_size_model_has_the_reference_keys():
    """configs/div2k/srmd.toml builds 12 convs of 128 features over 3 + 10 channels,
    4x: KAIR's keys model.0 .. model.22 with their shapes; sisr_tpu's converter reads
    every key."""
    internal = recipe_internal('srmd', ('scale', 'nc', 'nb', 'metadata'))
    handler = define_model('srmd', device='cpu', **internal)
    state = handler.module.state_dict()
    assert handler.num_metadata == 10 and handler.module_input_channels == 13
    expected = {'model.0.weight': (128, 13, 3, 3), 'model.22.weight': (48, 128, 3, 3),
                'model.22.bias': (48,)}
    expected.update({'model.%d.weight' % (2 * i): (128, 128, 3, 3) for i in range(1, 11)})
    for key, shape in expected.items():
        assert tuple(state[key].shape) == shape, key
    assert len(state) == 24
    convert_torch_state_dict('srmd', {k: v.numpy() for k, v in state.items()}, nb=12)


TRAIN = {'lr': 1e-3, 'scale': 2, 'scheduler': 'cosine_annealing_warm_restarts',
         'scheduler_params': {'t_mult': 1, 'restart_period': 4, 'lr_min': 1e-6},
         'grad_clip': 0.5}


def trajectory_against_sisr_tpu(name, cfg, n_meta=10, steps=6):
    """``steps`` train steps of the port against sisr_tpu's from the same weights and
    batches: losses within rtol 2e-4, parameters within 5e-5 after."""
    arch = {**cfg, **TRAIN}
    port = define_model(name, device='cpu', seed=3, **arch)
    port.set_metadata_keys(keys_of(cfg))
    theirs = jax_define_model(name, eval_mode=False, **arch)
    theirs.set_metadata_keys(keys_of(cfg))
    theirs.init_state(spatial=(12, 12), batch=2)
    port.module.load_state_dict(state_dict_from_jax(name, params_of(theirs)))
    rng = np.random.RandomState(42)
    ours_losses, their_losses = [], []
    for _ in range(steps):
        batch = {'lr': rng.rand(2, 12, 12, 3).astype(np.float32),
                 'hr': rng.rand(2, 24, 24, 3).astype(np.float32),
                 'metadata': rng.rand(2, n_meta).astype(np.float32)}
        ours_losses.append(float(port.run_train(**batch)[0]))
        their_losses.append(float(theirs.run_train(**batch)[0]))
    np.testing.assert_allclose(ours_losses, their_losses, rtol=2e-4, atol=2e-6)
    ours = jax.tree.map(lambda t: t.detach().numpy(),
                        params_from_state_dict(name, port.module.state_dict()))
    deltas = jax.tree.leaves(jax.tree.map(lambda a, b: float(np.abs(a - np.asarray(b)).max()),
                                          ours, theirs.state.params))
    assert max(deltas) < 5e-5


def test_training_trajectory_matches_sisr_tpu():
    trajectory_against_sisr_tpu('srmd', FAMILIES['srmd'][1])


def train_sisr_on_recipe(tmp_path, name, arch):
    """train_sisr (the standard validation epoch) on configs/div2k/<name>.toml as
    shipped, its model cut by ``arch`` and its data pointed at a seeded folder with a
    blur-kernel CSV: two epochs, finite losses and metrics, checkpoints."""
    config = toml_io.load(os.path.join(HERE, 'configs', 'div2k', name + '.toml'))
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=10, scale=4,
                                    metadata_cols=10)
    config['experiment_save_loc'] = str(tmp_path / 'Results')
    config['data']['batch_size'] = 2
    config['data']['dataloader_threads'] = 1
    for table in list(config['data']['training_sets'].values()) + \
            [config['data']['eval_sets']['data_1']]:
        table['lr'], table['hr'] = lr_dir, hr_dir
        table.pop('crop', None)
    config['data']['eval_sets']['data_1']['cutoff'] = 2
    config['model']['internal_params'].update(arch)
    config['training'].update(gpu='off', epoch_cutoff=2, save_samples=True, logging='none')
    path = str(tmp_path / 'recipe.toml')
    toml_io.dump(config, path)
    result = CliRunner().invoke(net_train.experiment_setup, ['--parameters', path],
                                catch_exceptions=False)
    assert result.exit_code == 0, result.output
    base = os.path.join(config['experiment_save_loc'], config['experiment'])
    summary = pd.read_csv(os.path.join(base, 'result_outputs', 'summary.csv'))
    assert list(summary['epoch']) == [0, 1]
    assert np.isfinite(summary[['train-loss', 'val-loss', 'val-PSNR', 'val-SSIM']]
                       .to_numpy()).all()
    saved = torch.load(os.path.join(base, 'saved_models', 'train_model_1'),
                       weights_only=True, map_location='cpu')
    assert saved['model_name'] == name and saved['step'] == 2 * 2 * 2  # 2 sets of 4, batch 2


def test_train_sisr_runs_the_shipped_recipe(tmp_path):
    train_sisr_on_recipe(tmp_path, 'srmd', {'nc': 16, 'nb': 3})
