"""sisr_tpu_torch's Q-RCAN (RCAN with meta-attention) against sisr_tpu's on the same
weights: forwards in f32 for every QCALayer style, with and without q_node and
pa_node and with selective_meta_blocks; the weights bridge both ways and through
sisr_tpu's own converter; the fused eval with metadata in f32 and bf16 (with the
modulate style's scale_qpi, and a ragged batch); the metadata CSV parser; and
eval_sisr --fused_eval end to end on a folder with a degradation_metadata.csv.  Bars:
forward 5e-4 abs, PSNR within 0.01 dB and SSIM within 1e-3 per image."""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from sisr_tpu.data.datasets import read_augmentation_list as jax_read_augmentation_list
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval
from sisr_tpu_torch.data.datasets import SuperResImages, read_augmentation_list
from sisr_tpu_torch.evaluation.standard_eval import EvalHub
from sisr_tpu_torch.models import q_layers
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.tools.convert_weights import params_from_state_dict, state_dict_from_jax
from sisr_tpu_torch.utils import toml_io

QRCAN = {'scale': 4, 'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 32, 'reduction': 16}
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}
# case -> (style, structure flags)
CASES = {
    'max_concat_q': ('max_concat', {'include_q_layer': True}),  # the e2e_bench config
    'max_concat_pa': ('max_concat', {'include_pixel_attention': True}),
    'max_concat_pa_q': ('max_concat', {'include_pixel_attention': True,
                                       'include_q_layer': True}),
    'max_concat_selective': ('max_concat', {'include_q_layer': True,
                                            'selective_meta_blocks': [False, True],
                                            'num_q_layers_inner_residual': 1}),
    'standard_q': ('standard', {'include_q_layer': True}),
    'modulate_q': ('modulate', {'include_q_layer': True}),
    'mini_concat_q': ('mini_concat', {'include_q_layer': True}),
    'softmax': ('softmax', {}),
    'extended_attention_pa': ('extended_attention', {'include_pixel_attention': True}),
}


def _internal(case):
    style, flags = CASES[case]
    return {**QRCAN, 'style': style,
            'metadata': ['qpi'] if style == 'modulate' else ['blur_kernel'], **flags}


def _keys(case):
    """The dataset's metadata keys: one QPI column, or a 10-value blur kernel."""
    return ['qpi'] if CASES[case][0] == 'modulate' else ['blur_kernel'] * 10


@pytest.fixture(scope='module')
def jax_model():
    cache = {}

    def get(case, dtype=None):
        if (case, dtype) not in cache:
            handler = jax_define_model('qrcan', eval_mode=True, dtype=dtype, **_internal(case))
            handler.set_metadata_keys(_keys(case))
            handler.init_state(spatial=(16, 16))
            cache[case, dtype] = handler
        return cache[case, dtype]
    return get


def _params(jax_handler):
    return jax.tree.map(np.asarray, jax_handler.state.params)


def _port(jax_handler, case, **kwargs):
    handler = define_model('qrcan', device='cpu', **{**_internal(case), **kwargs})
    handler.set_metadata_keys(_keys(case))
    handler.module.load_state_dict(state_dict_from_jax('qrcan', _params(jax_handler)))
    return handler


def _batch(case, seed, n=3, lr=16):
    rng = np.random.RandomState(seed)
    return {'lr': rng.randint(0, 256, (n, lr, lr, 3)).astype(np.uint8),
            'hr': rng.randint(0, 256, (n, 4 * lr, 4 * lr, 3)).astype(np.uint8),
            'metadata': rng.rand(n, len(_keys(case))).astype(np.float32)}


def _assert_metric_rows(keys, ours, theirs):
    for i, key in enumerate(keys):
        bar = BARS[key.split('>')[1]]
        np.testing.assert_allclose(ours[i], theirs[i], atol=bar, rtol=0, err_msg=key)


@pytest.mark.parametrize('case', sorted(CASES))
def test_forward_matches_sisr_tpu_f32(jax_model, case, monkeypatch):
    """Each case's forward on the same weights and metadata (prepared by each
    handler: column selection, and for 'modulate' the scale_qpi expansion); the
    kernel styles make one CA call per block, the others none."""
    jax_handler = jax_model(case)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    meta = rng.rand(2, len(_keys(case))).astype(np.float32)
    meta_in = jax_handler.prepare_metadata(jax.numpy.asarray(x), jax.numpy.asarray(meta))
    theirs = np.asarray(jax_handler.state.apply_fn({'params': jax_handler.state.params}, x,
                                                   metadata=meta_in))
    port = _port(jax_handler, case)
    calls = []
    monkeypatch.setattr(q_layers, 'fused_channel_attention',
                        lambda *a, **k: calls.append(k) or ca.fused_channel_attention(*a, **k))
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        ours = port.forward(xt, port.prepare_metadata(xt, torch.from_numpy(meta))).numpy()
    assert ours.shape == theirs.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=0)
    assert len(calls) == (4 if CASES[case][0] in q_layers.KERNEL_STYLES else 0)


def test_q_node_gate_is_fused_unless_pixel_attention_sits_between(jax_model):
    """Without pa_node every QRCAB hands its q_node's gate to the CA call; with it,
    the gate is applied after the pixel attention."""
    for case, fused in (('max_concat_q', True), ('max_concat_pa_q', False)):
        port = _port(jax_model(case), case)
        blocks = [b for g in port.module.body for b in g.body]
        seen = []
        for block in blocks:
            block.final_body.register_forward_hook(
                lambda mod, args, out: seen.append(args[2] is not None))
        x = torch.rand(1, 8, 8, 3)
        with torch.inference_mode():
            port.forward(x, torch.rand(1, 10))
        assert seen == [fused] * 4


@pytest.mark.parametrize('case', sorted(CASES))
def test_bridge_round_trips_through_sisr_tpu_converter(jax_model, case):
    """sisr_tpu tree -> port state_dict -> sisr_tpu's convert_torch_state_dict (no
    leftover keys) gives the tree back; the port's own reader gives it too."""
    params = _params(jax_model(case))
    port = _port(jax_model(case), case)
    state = {k: v.numpy() for k, v in port.module.state_dict().items()}
    style, flags = CASES[case]
    back = convert_torch_state_dict('qrcan', state, n_resgroups=2, n_resblocks=2, scale=4,
                                    style=style, **flags)
    ours = jax.tree.map(np.asarray, params_from_state_dict('qrcan', port.module.state_dict()))
    for tree in (back, ours):
        assert jax.tree.structure(tree) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)


def test_bridge_rejects_mismatched_trees(jax_model):
    params = _params(jax_model('max_concat_q'))
    extra = {**params, 'stray': {'kernel': np.zeros(1)}}
    with pytest.raises(RuntimeError, match='unconsumed'):
        state_dict_from_jax('qrcan', extra)
    missing = {k: v for k, v in params.items() if k != 'final_body'}
    with pytest.raises(KeyError, match='final_body'):
        state_dict_from_jax('qrcan', missing)
    # a q_node where the port's model has none: the load refuses the extra keys
    no_q = define_model('qrcan', device='cpu', **{**_internal('max_concat_q'),
                                                  'include_q_layer': False})
    with pytest.raises(RuntimeError, match='q_node'):
        no_q.module.load_state_dict(state_dict_from_jax('qrcan', params))


def test_qpircan_alias(jax_model):
    params = _params(jax_model('modulate_q'))
    port = define_model('qpircan', device='cpu', **_internal('modulate_q'))
    assert port.model_name == 'qrcan' and port.uses_metadata
    port.module.load_state_dict(state_dict_from_jax('qpircan', params))
    assert sorted(params_from_state_dict('qpircan', port.module.state_dict())) \
        == sorted(params)


@pytest.mark.parametrize('case,dtype', [('max_concat_q', None), ('max_concat_q', 'bf16'),
                                        ('modulate_q', None), ('modulate_q', 'bf16')])
def test_run_eval_fused_matches_sisr_tpu(jax_model, case, dtype):
    """The fused step with a (N, M) metadata batch.  In bf16 the two round in other
    places: sisr_tpu's QCALayer and ParaCALayer run their vectors in bf16 and round
    x * att and then * q_node's gate; the port excites in f32 and rounds once,
    x * (att * gate)."""
    jax_handler = jax_model(case, dtype)
    batch = _batch(case, seed=3)
    (keys, theirs), _ = jax_handler.run_eval_fused(batch)
    port = _port(jax_handler, case, dtype=dtype)
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert our_keys == keys and ours.shape == (len(keys), 3)
    _assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))


def test_run_eval_fused_ragged_with_metadata(jax_model):
    """Differently sized images at bs>1 run one by one, each with its own metadata
    row."""
    case = 'max_concat_q'
    rng = np.random.RandomState(4)
    sizes = ((16, 16), (12, 20))
    lrs = [rng.randint(0, 256, s + (3,)).astype(np.uint8) for s in sizes]
    hrs = [rng.randint(0, 256, (4 * s[0], 4 * s[1], 3)).astype(np.uint8) for s in sizes]
    meta = rng.rand(2, 10).astype(np.float32)
    port = _port(jax_model(case), case)
    (keys, ours), _ = port.run_eval_fused({'lr': lrs, 'hr': hrs, 'metadata': meta})
    assert ours.shape == (4, 2)
    for i in range(2):
        (_, theirs), _ = jax_model(case).run_eval_fused(
            {'lr': lrs[i][None], 'hr': hrs[i][None], 'metadata': meta[i:i + 1]})
        _assert_metric_rows(keys, ours.numpy()[:, i:i + 1], np.asarray(theirs))


def test_metadata_width_and_presence_are_checked(jax_model):
    port = _port(jax_model('max_concat_q'), 'max_concat_q')
    batch = _batch('max_concat_q', seed=5, n=1)
    port.set_metadata_keys(['blur_kernel'] * 4)  # a dataset with a 4-value kernel
    with pytest.raises(ValueError, match='takes 10 metadata values'):
        port.run_eval_fused({**batch, 'metadata': batch['metadata'][:, :4]})
    with pytest.raises(RuntimeError, match='Metadata needs to be specified'):
        port.run_eval_fused({'lr': batch['lr'], 'hr': batch['hr']})


def test_set_metadata_keys_selects_the_configured_columns():
    port = define_model('qrcan', device='cpu', **{**_internal('max_concat_q'),
                                                   'metadata': ['qpi']})
    port.set_metadata_keys(['blur_kernel'] * 3 + ['qpi'])
    meta = torch.arange(8.0).view(2, 4)
    assert port.prepare_metadata(torch.zeros(2, 4, 4, 3), meta).tolist() == [[3.0], [7.0]]
    port.metadata = ['all']
    port.set_metadata_keys(['blur_kernel'] * 3 + ['qpi'])
    assert list(port.meta_indices) == [0, 1, 2, 3]


def _write_csv(path):
    """Six images: an int QPI column, a float column, a constant column and a JSON
    blur-kernel column (as the reference's degradation_metadata.csv)."""
    rng = np.random.RandomState(6)
    rows = ['image,qpi,noise,const,blur_kernel']
    for i in range(6):
        kernel = rng.dirichlet(np.ones(10) * 5).tolist()
        rows.append('im_%d.png,%d,%r,7,"%s"' % (i, 20 + 4 * i, float(rng.rand()), kernel))
    with open(path, 'w') as f:
        f.write('\n'.join(rows) + '\n')
    return ['im_%d.png' % i for i in range(6)]


@pytest.mark.parametrize('qpi_selection', [None, (None, None), (24, 32)])
def test_read_augmentation_list_matches_sisr_tpu(tmp_path, qpi_selection):
    path = str(tmp_path / 'degradation_metadata.csv')
    names = _write_csv(path)
    ours, our_keys = read_augmentation_list(path, filenames=names, qpi_selection=qpi_selection)
    theirs, keys = jax_read_augmentation_list(path, filenames=names,
                                              qpi_selection=qpi_selection)
    assert our_keys == keys == ['qpi', 'noise', 'const'] + ['blur_kernel'] * 10
    assert sorted(ours) == sorted(theirs)
    assert len(ours) == (3 if qpi_selection == (24, 32) else 6)  # QPI 24, 28 and 32
    for name in ours:
        np.testing.assert_array_equal(ours[name], theirs[name])
    assert all(ours[n][2] == 0.0 for n in ours)  # the constant column


def test_dataset_serves_metadata_and_the_loader_keeps_keys_as_a_list(tmp_path):
    from sisr_tpu_torch.data.loader import DataLoader, device_prefetch
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 3, lr_size=8, metadata_cols=10)
    dataset = SuperResImages(lr_dir, hr_dir, split='all',
                             degradation_metadata_file=os.path.join(
                                 lr_dir, 'degradation_metadata.csv'), metadata='all')
    item = dataset[0]
    assert item['metadata'].dtype == np.float32 and item['metadata'].shape == (10,)
    assert item['metadata_keys'] == ['blur_kernel'] * 10
    batch = next(device_prefetch(iter(DataLoader(dataset, batch_size=2)), 'cpu'))
    assert batch['metadata'].dtype == torch.float32 and batch['metadata'].shape == (2, 10)
    assert batch['metadata_keys'] == ['blur_kernel'] * 10
    # CelebA attributes are ported (tests/test_torch_celeba.py): a missing file fails
    # to read, as in sisr_tpu
    with pytest.raises(FileNotFoundError):
        SuperResImages(lr_dir, hr_dir, split='all', metadata='all', data_attributes='a.txt')


def _eval_kwargs(lr_dir, hr_dir, model_loc, out_loc, **overrides):
    return {**dict(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('jax_exp', '0')],
                   results_name='ref', gpu=False, metrics=['PSNR', 'SSIM'], data_split=None,
                   save_im=False, batch_size=2, full_directory=True, lr_dir_interp=None,
                   model_only=False, scale=4, model_loc=model_loc, out_loc=out_loc,
                   use_test_group=False, no_image_comparison=True, num_image_save=0,
                   qpi_selection=(None, None), data_attributes=None, dataset_name=None,
                   image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=False,
                   recursive=False, fused_eval=True), **overrides}


def _write_experiments(root, jax_handler, port, internal):
    """The same weights as a sisr_tpu experiment and as a sisr_tpu_torch one."""
    for name in ('jax_exp', 'torch_exp'):
        os.makedirs(os.path.join(root, name, 'saved_models'))
        toml_io.dump({'model': {'name': 'qrcan', 'internal_params': internal}},
                     os.path.join(root, name, 'config.toml'))
    jax_handler.save_model('train_model', 0, os.path.join(root, 'jax_exp', 'saved_models'))
    jax_handler.wait_pending_checkpoints()
    port.save_model('train_model', 0, os.path.join(root, 'torch_exp', 'saved_models'))


def _read_metrics(out_loc, name):
    return pd.read_csv(os.path.join(out_loc, name, 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


def test_cli_fused_eval_matches_sisr_tpu(tmp_path, jax_model):
    """eval_sisr --fused_eval --no-gpu on a folder whose degradation_metadata.csv has
    10-value blur kernels, found beside the LR images, against sisr_tpu's EvalHub."""
    from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
    case = 'max_concat_q'
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 5, lr_size=16, metadata_cols=10)
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    _write_experiments(model_loc, jax_model(case), _port(jax_model(case), case),
                       _internal(case))
    net_eval.eval_run.main(
        args=['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'torch_exp', '0',
              '--model_loc', model_loc, '--out_loc', out_loc, '--results_name', 'port',
              '-m', 'PSNR', '-m', 'SSIM', '--batch_size', '2', '--full_directory',
              '--fused_eval', '--no_image_comparison', '--no-time_models', '--no-gpu'],
        standalone_mode=False)
    JaxEvalHub(**_eval_kwargs(lr_dir, hr_dir, model_loc, out_loc)).full_image_protocol()
    ours, theirs = _read_metrics(out_loc, 'port'), _read_metrics(out_loc, 'ref')
    assert list(ours.index) == list(theirs.index) and len(ours) == 5
    for side_ours, side_theirs in (('LR', 'LR'), ('torch_exp', 'jax_exp')):
        for met, bar in BARS.items():
            np.testing.assert_allclose(ours[(side_ours, met)], theirs[(side_theirs, met)],
                                       atol=bar, rtol=0, err_msg='%s %s' % (side_ours, met))


def test_metadata_file_discovery(tmp_path, jax_model):
    """An explicit --metadata_file must exist; without one, qpi_slices.csv is the
    fallback after degradation_metadata.csv; --qpi_selection filters the images; and
    the models get the dataset's keys."""
    case = 'modulate_q'
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=8)
    with open(os.path.join(lr_dir, 'qpi_slices.csv'), 'w') as f:
        f.write('image,qpi\n' + ''.join('im_%03d.png,%d\n' % (i, 20 + 5 * i)
                                        for i in range(4)))
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    _write_experiments(model_loc, jax_model(case), _port(jax_model(case), case),
                       _internal(case))
    kwargs = _eval_kwargs(lr_dir, hr_dir, model_loc, out_loc,
                          model_and_epoch=[('torch_exp', '0')], results_name='port')
    with pytest.raises(FileNotFoundError, match='metadata_file'):
        EvalHub(**{**kwargs, 'metadata_file': str(tmp_path / 'missing.csv')})
    hub = EvalHub(**{**kwargs, 'qpi_selection': (25, 30)})
    assert hub.rgb_data.dataset.lr_filenames == ['im_001.png', 'im_002.png']
    assert hub.model_bundles[0].model.metadata_keys == ['qpi']
    hub.full_image_protocol()
    assert len(_read_metrics(out_loc, 'port')) == 2


def test_int8_raises_until_its_slice(jax_model):
    """set_int8 on Q-RCAN calibrates on the first batch with its metadata and runs the
    int8 program in the fused step (tests/test_torch_int8_qrcan.py holds it against
    sisr_tpu)."""
    case = 'max_concat_q'
    port = _port(jax_model(case), case)
    batch = _batch(case, seed=7)
    (_, f32), _ = port.run_eval_fused(batch)
    port.set_int8(True)
    assert port.int8_mode and port._int8_ctx is None
    (_, int8), _ = port.run_eval_fused(batch)
    program, qparams, scales = port._int8_ctx
    assert 'group_1.qrcab_1.conv_1' in scales and 'q_node' in qparams['group_0']['qrcab_0']
    assert torch.isfinite(int8).all() and not torch.equal(int8, f32)
