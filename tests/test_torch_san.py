"""sisr_tpu_torch's SAN and Q-SAN against sisr_tpu's on the same weights, on the CPU.
SAN's ``gamma`` and the non-local block's output conv ``W`` start at 0 (the non-local
block is then the identity and gamma drops the long skip): every case sets gamma to
0.5, draws W and draws each SOCA's MLP with a spread, in sisr_tpu's params, before they
are bridged.  Models: 2 groups x 2 blocks, 16 features, reduction 4, 4x (Q-SAN with 10
blur-kernel values).

Each case holds: covariance_pool, newton_schulz_sqrt, SOCA, NonLocalBlock2D and
NonlocalCA against sisr_tpu's at even and odd h and w (the quadrants and the 2 x 2
pools floor); the f32 forward; the attention in f32 under bf16 autocast; the static
tile grid against sisr_tpu's ``_tiled_forward`` at grid 2 and grid 4 on an odd-sized
image, with metadata; the fused eval (f32 and bf16, with and without the grid); eval_sisr
--fused_eval and the standard protocol end to end (the grid on the larger images);
--eval_buckets printed and ignored; the weights bridge through sisr_tpu's converter
with only the reference's dead keys dropped, and the full-size models' keys and shapes;
training against sisr_tpu's and train_sisr on the shipped recipes' models.  int8 is in
test_torch_int8_san.py.

Bars: the attention parts 1e-5 abs in f32; the forward and the tile grid 5e-4 abs in
f32; PSNR within 0.01 dB and SSIM within 1e-3 per image; training losses rtol 2e-4,
parameters 5e-5 after the steps."""
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
from sisr_tpu.models import san as jax_san
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch import net_eval, net_train
from sisr_tpu_torch.models import san
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.tools.convert_weights import (DEAD_REFERENCE_KEYS,
                                                  drop_dead_reference_keys,
                                                  params_from_state_dict, state_dict_from_jax)
from sisr_tpu_torch.utils import toml_io

SMALL = {'scale': 4, 'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 4}
FAMILIES = {'san': SMALL, 'qsan': {**SMALL, 'metadata': ['blur_kernel']}}
KEYS = ['blur_kernel'] * 10
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}
SIZES = {'even': (12, 16), 'odd': (13, 15)}
# max_combined_im_size giving a 41 x 43 LR image a grid of 2 x 2 and of 4 x 4 tiles
GRID_LIMITS = {2: 1500, 4: 600}


def with_live_attention(params, seed=0):
    """sisr_tpu params (numpy) with gamma 0.5, the non-local output conv drawn and every
    SOCA's MLP drawn from N(0, 1) (torch's default init leaves its gates near 0.5)."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.array, params)
    params['gamma'] = np.array([0.5], np.float32)
    w = params['non_local']['non_local']['w']
    w['kernel'] = (0.3 * rng.randn(*w['kernel'].shape)).astype(np.float32)
    w['bias'] = (0.1 * rng.randn(*w['bias'].shape)).astype(np.float32)
    for name, group in params.items():
        if name.startswith('rg_'):
            for layer in group['soca'].values():
                layer['kernel'] = rng.randn(*layer['kernel'].shape).astype(np.float32)
    return params


def _jax_handler(name, dtype=None, params=None, **kwargs):
    handler = jax_define_model(name, eval_mode=True, dtype=dtype, **FAMILIES[name], **kwargs)
    if name == 'qsan':
        handler.set_metadata_keys(KEYS)
    handler.init_state(spatial=(16, 16))
    if params is None:
        params = with_live_attention(handler.state.params)
    handler.state = handler.state.replace(params=jax.tree.map(jnp.asarray, params))
    return handler


@pytest.fixture(scope='module')
def jax_model():
    """(name, dtype) -> sisr_tpu's handler with live attention."""
    cache = {}

    def get(name, dtype=None):
        if (name, dtype) not in cache:
            params = None if (name, None) not in cache else _params(cache[name, None])
            cache[name, dtype] = _jax_handler(name, dtype, params)
        return cache[name, dtype]
    return get


def _params(jax_handler):
    return jax.tree.map(np.asarray, jax_handler.state.params)


def _port(name, jax_handler, **kwargs):
    handler = define_model(name, device='cpu', **{**FAMILIES[name], **kwargs})
    if name == 'qsan':
        handler.set_metadata_keys(KEYS)
    handler.module.load_state_dict(state_dict_from_jax(name, _params(jax_handler)))
    return handler


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


PARTS = ('covariance_pool', 'newton_schulz_sqrt', 'soca', 'nonlocal_block', 'nonlocal_ca')


@pytest.mark.parametrize('size', sorted(SIZES))
@pytest.mark.parametrize('part', PARTS)
def test_attention_parts_match_sisr_tpu(jax_model, part, size):
    """Each attention part of the port (the functions, and the modules with the bridged
    parameters) against sisr_tpu's on the same NHWC input, f32."""
    params = _params(jax_model('san'))
    port = _port('san', jax_model('san')).module
    x = (0.5 * np.random.RandomState(3).randn(2, *SIZES[size], 16)).astype(np.float32)
    xj = jnp.asarray(x)
    with torch.inference_mode():
        if part == 'covariance_pool':
            theirs, ours = jax_san.covariance_pool(xj), san.covariance_pool(torch.from_numpy(x))
        elif part == 'newton_schulz_sqrt':
            cov = np.array(jax_san.covariance_pool(xj))
            theirs = jax_san.newton_schulz_sqrt(jnp.asarray(cov))
            ours = san.newton_schulz_sqrt(torch.from_numpy(cov))
        elif part == 'soca':
            theirs = jax_san.SOCA(16, 4).apply({'params': params['rg_1']['soca']}, xj)
            ours = port.RG[1].soca(_nchw(x)).permute(0, 2, 3, 1)
            assert np.abs(np.asarray(theirs) - x).max() > 0.05  # the gates act
        elif part == 'nonlocal_block':
            theirs = jax_san.NonLocalBlock2D(16, 2).apply(
                {'params': params['non_local']['non_local']}, xj)
            ours = port.non_local.non_local(_nchw(x)).permute(0, 2, 3, 1)
        else:
            theirs = jax_san.NonlocalCA(16, 2).apply({'params': params['non_local']}, xj)
            ours = port.non_local(_nchw(x)).permute(0, 2, 3, 1)
            assert ours.shape == x.shape
    theirs = np.asarray(theirs)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=0)
    if part.startswith('nonlocal'):
        assert np.abs(theirs - x).max() > 0.05  # W drawn: not the identity


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_forward_matches_sisr_tpu_f32(jax_model, name):
    """The f32 forward on an odd-sized input (and, for Q-SAN, the same metadata prepared
    by each handler)."""
    jax_handler = jax_model(name)
    rng = np.random.RandomState(1)
    x = rng.rand(2, 13, 15, 3).astype(np.float32)
    meta = rng.rand(2, 10).astype(np.float32)
    kwargs = {}
    if name == 'qsan':
        kwargs['metadata'] = jax_handler.prepare_metadata(jnp.asarray(x), jnp.asarray(meta))
    theirs = np.asarray(jax_handler.state.apply_fn({'params': jax_handler.state.params}, x,
                                                   **kwargs))
    port = _port(name, jax_handler)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        args = (port.prepare_metadata(xt, torch.from_numpy(meta)),) if name == 'qsan' else ()
        ours = port.forward(xt, *args).numpy()
    assert ours.shape == theirs.shape == (2, 52, 60, 3)
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=0)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_bf16_autocast_keeps_the_attention_f32(jax_model, name, monkeypatch):
    """Under the bf16 forward every covariance, Newton-Schulz square root and non-local
    softmax comes out f32 with autocast off (two SOCAs and eight non-local quadrants
    here); the output is
    bf16 and finite, and SOCA's pooled vector equals the f32 computation on the same
    bf16 values."""
    seen = []

    def spy(fn, key):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.append((key, out.dtype, torch.is_autocast_enabled('cpu')))
            return out
        return call

    monkeypatch.setattr(san, 'covariance_pool', spy(san.covariance_pool, 'cov'))
    monkeypatch.setattr(san, 'newton_schulz_sqrt', spy(san.newton_schulz_sqrt, 'sqrt'))
    monkeypatch.setattr(san.torch, 'softmax', spy(torch.softmax, 'softmax'))
    port = _port(name, jax_model(name), dtype='bf16')
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.rand(2, 13, 15, 3).astype(np.float32))
    meta = (port.prepare_metadata(x, torch.from_numpy(rng.rand(2, 10).astype(np.float32))),) \
        if name == 'qsan' else ()
    with torch.inference_mode():
        out = port.forward(x, *meta)
    monkeypatch.undo()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert sorted({k for k, _, _ in seen}) == ['cov', 'softmax', 'sqrt']
    assert [k for k, _, _ in seen].count('softmax') == 8
    assert all(dtype == torch.float32 and not autocast for _, dtype, autocast in seen)
    h = torch.from_numpy(rng.randn(2, 9, 11, 16).astype(np.float32)).bfloat16()
    with torch.autocast('cpu', dtype=torch.bfloat16):
        pooled = san.second_order_pool(h)
    assert pooled.dtype == torch.float32
    torch.testing.assert_close(pooled, san.second_order_pool(h.float()), atol=0, rtol=0)


def _grid_inputs(seed=4, n=2):
    rng = np.random.RandomState(seed)
    return rng.rand(n, 41, 43, 3).astype(np.float32), rng.rand(n, 10).astype(np.float32)


@pytest.mark.parametrize('grid', sorted(GRID_LIMITS))
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_tiled_forward_matches_sisr_tpu(jax_model, name, grid, monkeypatch):
    """The tile grid on a 41 x 43 LR batch of 2 (odd: the last tiles' anchors clamp)
    against sisr_tpu's _tiled_forward: one tile batch of 2 * grid^2 tiles of the
    planned span, tile-major, with the metadata repeated grid^2 times (not
    interleaved); the stitched SR within 5e-4."""
    jax_handler = jax_model(name)
    jax_handler.max_combined_im_size = GRID_LIMITS[grid]
    x, meta = _grid_inputs()
    batch = {'lr': jnp.asarray(x)}
    if name == 'qsan':
        batch['metadata'] = jnp.asarray(meta)
    try:
        theirs = np.asarray(jax_handler._tiled_forward(batch))
    finally:
        jax_handler.max_combined_im_size = 160000
    port = _port(name, jax_model(name), max_combined_im_size=GRID_LIMITS[grid])
    steps = []
    tile_step = port._tile_step
    monkeypatch.setattr(port, '_tile_step', lambda b: steps.append(b) or tile_step(b))
    ours_batch = {'lr': torch.from_numpy(x)}
    if name == 'qsan':
        ours_batch['metadata'] = torch.from_numpy(meta)
    with torch.inference_mode():
        ours = port._tiled_forward(ours_batch).numpy()
    assert ours.shape == theirs.shape == (2, 164, 172, 3)
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=0)
    (tiles,) = steps
    span = -(-41 // grid) + 20, -(-43 // grid) + 20
    assert tuple(tiles['lr'].shape) == (2 * grid * grid,) + span + (3,)
    # tile-major: the first tile of both images, then the second tile of both, ...
    torch.testing.assert_close(tiles['lr'][:2], torch.from_numpy(x)[:, :span[0], :span[1]])
    if name == 'qsan':
        torch.testing.assert_close(tiles['metadata'], torch.from_numpy(np.tile(meta, (grid ** 2, 1))))


def test_tile_grid_levels_and_small_images(jax_model):
    """The grid's size against sisr_tpu's rule: the 510 x 339 DIV2K LR map at 20000 is
    16 tiles of 105 x 148 (rows x columns, halo included); a 128^2 map at 20000 takes no
    grid, at 10000 a 2 x 2 grid; a 22^2 map at 200 is at level 3, where an 8 x 8 grid's
    tiles (3 + 20 halo) would not fit it: the grid halves down to none."""
    port = _port('san', jax_model('san'), max_combined_im_size=20000)
    seen = []
    port._tile_step = lambda b: seen.append(tuple(b['lr'].shape)) or torch.zeros(
        b['lr'].shape[0], 4 * b['lr'].shape[1], 4 * b['lr'].shape[2], 3)
    cases = [((339, 510), 20000, (16, 105, 148)), ((128, 128), 20000, (1, 128, 128)),
             ((128, 128), 10000, (4, 84, 84)), ((22, 22), 200, (1, 22, 22))]
    for (h, w), limit, tiles in cases:
        port.max_combined_im_size = limit
        out = port._tiled_forward({'lr': torch.zeros(1, h, w, 3)})
        assert out.shape == (1, 4 * h, 4 * w, 3)
        assert seen.pop() == tiles + (3,)
    # at 100 or less no level brings a tile's area (halo included) under the limit:
    # sisr_tpu's loop never ends there, the port refuses
    port.max_combined_im_size = 100
    with pytest.raises(ValueError, match='must exceed 100'):
        port._tiled_forward({'lr': torch.zeros(1, 30, 30, 3)})


def test_epoch_samples_take_the_tile_grid(jax_model, monkeypatch):
    """The training epoch's sample images (super_resolve) of a tiled family come from
    the tile grid, as sisr_tpu's come from its standard eval step."""
    port = _port('qsan', jax_model('qsan'), max_combined_im_size=GRID_LIMITS[2])
    x, meta = _grid_inputs(seed=6, n=1)
    seen = []
    tiled = port._tiled_forward
    monkeypatch.setattr(port, '_tiled_forward', lambda b: seen.append(b) or tiled(b))
    ours = port.super_resolve({'lr': x, 'metadata': meta})
    (batch,) = seen
    with torch.inference_mode():
        direct = tiled({'lr': torch.from_numpy(x), 'metadata': torch.from_numpy(meta)})
    np.testing.assert_array_equal(ours, direct.clamp(0, 1).numpy())
    torch.testing.assert_close(batch['metadata'], torch.from_numpy(meta))


def _batch(seed, n=3, lr=16):
    rng = np.random.RandomState(seed)
    return {'lr': rng.randint(0, 256, (n, lr, lr, 3)).astype(np.uint8),
            'hr': rng.randint(0, 256, (n, 4 * lr, 4 * lr, 3)).astype(np.uint8),
            'metadata': rng.rand(n, 10).astype(np.float32)}


def _assert_metric_rows(keys, ours, theirs):
    for i, key in enumerate(keys):
        bar = BARS[key.split('>')[1]]
        np.testing.assert_allclose(ours[i], theirs[i], atol=bar, rtol=0, err_msg=key)


@pytest.mark.parametrize('limit', [None, 1000], ids=['no_grid', 'grid2'])
@pytest.mark.parametrize('dtype', [None, 'bf16'])
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_run_eval_fused_matches_sisr_tpu(jax_model, name, dtype, limit):
    """The fused step (Q-SAN with its metadata batch), f32 and bf16; with
    max_combined_im_size 1000 the 40^2 LR maps run as a 2 x 2 grid inside the step."""
    jax_handler = jax_model(name, dtype)
    batch = _batch(seed=3, lr=40 if limit else 16)
    if limit:
        jax_handler.max_combined_im_size = limit
        jax_handler._invalidate_steps()
    try:
        (keys, theirs), _ = jax_handler.run_eval_fused(batch)
    finally:
        jax_handler.max_combined_im_size = 160000
        jax_handler._invalidate_steps()
    port = _port(name, jax_handler, dtype=dtype, max_combined_im_size=limit or 160000)
    (our_keys, ours), _ = port.run_eval_fused(batch)
    assert our_keys == keys and ours.shape == (len(keys), 3)
    _assert_metric_rows(keys, ours.numpy(), np.asarray(theirs))


def _read_metrics(out_loc, results):
    return pd.read_csv(os.path.join(out_loc, results, 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


def _experiments(model_loc, name, jax_handler, port, internal):
    for exp in ('jax_exp', 'torch_exp'):
        os.makedirs(os.path.join(model_loc, exp, 'saved_models'))
        toml_io.dump({'model': {'name': name, 'internal_params': internal}},
                     os.path.join(model_loc, exp, 'config.toml'))
    jax_handler.save_model('train_model', 0, os.path.join(model_loc, 'jax_exp',
                                                          'saved_models'))
    jax_handler.wait_pending_checkpoints()
    port.save_model('train_model', 0, os.path.join(model_loc, 'torch_exp', 'saved_models'))


def _hub(hr_dir, lr_dir, model_loc, out_loc, **kwargs):
    return JaxEvalHub(hr_dir=hr_dir, lr_dir=lr_dir, model_and_epoch=[('jax_exp', '0')],
                      results_name='ref', gpu=False, metrics=['PSNR', 'SSIM'],
                      data_split=None, batch_size=1, full_directory=True,
                      lr_dir_interp=None, model_only=False, scale=4, model_loc=model_loc,
                      out_loc=out_loc, use_test_group=False, num_image_save=100,
                      qpi_selection=(None, None), data_attributes=None,
                      dataset_name=None, image_shortlist=None, metadata_file=None,
                      sp_gpu=0, recursive=False, **kwargs)


def _assert_frames(ours, theirs, n):
    assert list(ours.index) == list(theirs.index) and len(ours) == n
    for side_ours, side_theirs in (('LR', 'LR'), ('torch_exp', 'jax_exp')):
        for met, bar in BARS.items():
            np.testing.assert_allclose(ours[(side_ours, met)], theirs[(side_theirs, met)],
                                       atol=bar, rtol=0, err_msg='%s %s' % (side_ours, met))


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_cli_fused_eval_matches_sisr_tpu(tmp_path, jax_model, name):
    """eval_sisr --fused_eval --no-gpu on a folder with a blur-kernel
    degradation_metadata.csv beside the LR images, against sisr_tpu's EvalHub on the
    same weights."""
    lr_dir, hr_dir = build_workload(str(tmp_path / 'data'), 4, lr_size=16, metadata_cols=10)
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    _experiments(model_loc, name, jax_model(name), _port(name, jax_model(name)),
                 FAMILIES[name])
    net_eval.eval_run.main(
        args=['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'torch_exp', '0',
              '--model_loc', model_loc, '--out_loc', out_loc, '--results_name', 'port',
              '-m', 'PSNR', '-m', 'SSIM', '--batch_size', '2', '--full_directory',
              '--fused_eval', '--no_image_comparison', '--no-time_models', '--no-gpu'],
        standalone_mode=False)
    _hub(hr_dir, lr_dir, model_loc, out_loc, save_im=False, no_image_comparison=True,
         time_models=False, fused_eval=True).full_image_protocol()
    _assert_frames(_read_metrics(out_loc, 'port'), _read_metrics(out_loc, 'ref'), 4)


# HR (h, w) of the mixed-size set: LR 12 x 16 takes no grid at GRID_LIMITS[2], LR 41 x 43
# and 40 x 44 a 2 x 2 grid
MIXED_HR = ((48, 64), (164, 172), (160, 176))


@pytest.fixture(scope='module')
def mixed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('san_mixed'))
    rng = np.random.RandomState(5)
    lr_dir, hr_dir = os.path.join(root, 'lr'), os.path.join(root, 'hr')
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    rows = []
    for i, (h, w) in enumerate(MIXED_HR):
        name = 'im_%d.png' % i
        yy, xx = np.mgrid[0:h, 0:w] / 12.0
        hr = np.stack([np.sin(xx + c) * np.cos(yy * (c + 1)) for c in range(3)], -1)
        hr = np.clip((hr * 0.4 + 0.5) * 255 + rng.normal(0, 8, hr.shape), 0, 255)
        hr_im = Image.fromarray(hr.astype(np.uint8))
        hr_im.save(os.path.join(hr_dir, name))
        hr_im.resize((w // 4, h // 4), Image.BICUBIC).save(os.path.join(lr_dir, name))
        rows.append('%s,"%s"' % (name, json.dumps(rng.dirichlet(np.ones(10) * 5).tolist())))
    with open(os.path.join(lr_dir, 'degradation_metadata.csv'), 'w') as f:
        f.write('image,blur_kernel\n' + '\n'.join(rows) + '\n')
    return lr_dir, hr_dir


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_standard_protocol_cli_matches_sisr_tpu(tmp_path, jax_model, mixed, name, capsys):
    """eval_sisr without --fused_eval (batch 1, --save_im) over mixed sizes with
    max_combined_im_size 1500 in the experiment's config, so the two larger images run
    on a 2 x 2 grid: metrics within the bars of sisr_tpu's, SR images within 1 uint8
    LSB.  The port's run also passes --eval_buckets 8, which SAN prints and ignores:
    its metrics are those of the run without it."""
    lr_dir, hr_dir = mixed
    internal = {**FAMILIES[name], 'max_combined_im_size': GRID_LIMITS[2]}
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    jax_handler = jax_model(name)
    _experiments(model_loc, name, jax_handler, _port(name, jax_handler), internal)
    for results, extra in (('port', []), ('port_buckets', ['--eval_buckets', '8'])):
        net_eval.eval_run.main(
            args=['--hr_dir', hr_dir, '--lr_dir', lr_dir, '-me', 'torch_exp', '0',
                  '--model_loc', model_loc, '--out_loc', out_loc, '--results_name', results,
                  '-m', 'PSNR', '-m', 'SSIM', '--full_directory', '--save_im',
                  '--no_image_comparison', '--no-gpu', *extra], standalone_mode=False)
    assert 'bucketed eval is not exact for this architecture' in capsys.readouterr().out
    _hub(hr_dir, lr_dir, model_loc, out_loc, save_im=True, no_image_comparison=True,
         time_models=True).full_image_protocol()
    ours, theirs = _read_metrics(out_loc, 'port'), _read_metrics(out_loc, 'ref')
    _assert_frames(ours, theirs, len(MIXED_HR))
    pd.testing.assert_frame_equal(
        _read_metrics(out_loc, 'port_buckets').drop(columns='runtime', level=1),
        ours.drop(columns='runtime', level=1))
    for image in sorted(os.listdir(hr_dir)):
        a = np.asarray(Image.open(os.path.join(out_loc, 'port', 'torch_exp', image)))
        b = np.asarray(Image.open(os.path.join(out_loc, 'ref', 'jax_exp', image)))
        assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= 1


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_eval_buckets_is_printed_and_ignored(name, capsys):
    handler = define_model(name, device='cpu', **{**FAMILIES[name], 'n_resgroups': 1,
                                                  'n_resblocks': 1})
    handler.set_eval_buckets(8)
    assert 'bucketed eval is not exact' in capsys.readouterr().out
    assert handler.eval_buckets is None and handler.supports_fused_eval()


def _reference_state_dict(port_state, seed=7):
    """The port's state_dict as the reference's SAN would save it: with the parameters
    its forward never uses (top-level conv_last, each group's gamma, the non-local
    wrapper's SOCA), seeded."""
    rng = np.random.RandomState(seed)
    sd = {k: v.numpy().copy() for k, v in port_state.items()}
    n = sd['head.0.weight'].shape[0]
    sd['conv_last.weight'] = rng.randn(3, n, 3, 3).astype(np.float32)
    sd['conv_last.bias'] = rng.randn(3).astype(np.float32)
    for g in range(2):
        sd['RG.%d.gamma' % g] = np.zeros(1, np.float32)
    for i, shape in ((0, (n // 4, n)), (2, (n, n // 4))):
        sd['non_local.soca.conv_du.%d.weight' % i] = rng.randn(*shape, 1, 1).astype(np.float32)
        sd['non_local.soca.conv_du.%d.bias' % i] = rng.randn(shape[0]).astype(np.float32)
    return sd


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_bridge_round_trips_through_sisr_tpu_converter(jax_model, name, tmp_path):
    """sisr_tpu tree -> port state_dict -> (with the reference's dead keys added)
    sisr_tpu's convert_torch_state_dict gives the tree back, gamma and W included; the
    port's reader drops exactly those keys and gives it too; load_model takes a
    reference checkpoint that carries them."""
    params = _params(jax_model(name))
    port = _port(name, jax_model(name))
    state = port.module.state_dict()
    assert state['gamma'].item() == 0.5
    assert state['non_local.non_local.W.weight'].abs().max() > 0
    reference = _reference_state_dict(state)
    kept = drop_dead_reference_keys(name, reference)
    assert sorted(kept) == sorted(state)
    back = convert_torch_state_dict(name, reference, n_resgroups=2, n_resblocks=2, scale=4)
    ours = jax.tree.map(np.asarray, params_from_state_dict(
        name, {k: torch.from_numpy(v) for k, v in reference.items()}))
    for tree in (back, ours):
        assert jax.tree.structure(tree) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
    base = tmp_path / 'saved_models'
    base.mkdir()
    torch.save({'network': {k: torch.from_numpy(v) for k, v in reference.items()},
                'model_name': name, 'model_epoch': 3}, str(base / 'train_model_3'))
    fresh = define_model(name, device='cpu', eval_mode=True, seed=9, **FAMILIES[name])
    fresh.load_model('train_model', 3, str(base))
    for k, v in fresh.module.state_dict().items():
        torch.testing.assert_close(v, state[k], atol=0, rtol=0)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_bridge_rejects_mismatched_trees(jax_model, name):
    """A stray leaf or a missing part raises both ways.  A stray key under a live SOCA
    raises in the port's reader, where sisr_tpu's converter lets every key with
    'soca.' in its name pass (its dead-key pattern)."""
    params = _params(jax_model(name))
    with pytest.raises(RuntimeError, match='unconsumed'):
        state_dict_from_jax(name, {**params, 'stray': {'kernel': np.zeros(1)}})
    for part in ('non_local', 'gamma', 'rg_0', 'tail'):
        with pytest.raises(KeyError, match=part):
            state_dict_from_jax(name, {k: v for k, v in params.items() if k != part})
    other = 'qsan' if name == 'san' else 'san'
    with pytest.raises((KeyError, RuntimeError)):
        state_dict_from_jax(other, params)
    state = _port(name, jax_model(name)).module.state_dict()
    stray = {**state, 'RG.0.soca.conv_du.4.weight': torch.zeros(1)}
    with pytest.raises(RuntimeError, match='unread'):
        params_from_state_dict(name, stray)
    convert_torch_state_dict(name, {k: v.numpy() for k, v in stray.items()},
                             n_resgroups=2, n_resblocks=2, scale=4)  # passes silently
    assert DEAD_REFERENCE_KEYS['qsan'] == DEAD_REFERENCE_KEYS['san']


# (key, shape) of one group's and the shared layers at full size; every group has them
FULL_SIZE_KEYS = {
    'head.0.weight': (64, 3, 3, 3), 'gamma': (1,),
    'non_local.non_local.g.0.weight': (8, 64, 1, 1),
    'non_local.non_local.theta.weight': (8, 64, 1, 1),
    'non_local.non_local.phi.0.weight': (8, 64, 1, 1),
    'non_local.non_local.W.weight': (64, 8, 1, 1),
    'RG.19.rcab.9.conv_first.0.weight': (64, 64, 3, 3),
    'RG.19.rcab.9.conv_first.2.weight': (64, 64, 3, 3),
    'RG.19.soca.conv_du.0.weight': (4, 64, 1, 1), 'RG.19.soca.conv_du.2.weight': (64, 4, 1, 1),
    'RG.19.conv_last.weight': (64, 64, 3, 3), 'tail.0.0.weight': (256, 64, 3, 3),
    'tail.0.2.weight': (256, 64, 3, 3), 'tail.1.weight': (3, 64, 3, 3)}


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_full_size_models_have_the_reference_keys(name):
    """define_model with the shipped recipes' parameters (configs/div2k/san.toml and
    qsan.toml) builds 20 x 10, 64 features, reduction 16, 4x: every live key of the
    reference with its shape (the count of each kind listed), none of its dead ones,
    gamma and W at 0; sisr_tpu's converter reads every key."""
    recipe = toml_io.load(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                       'configs', 'div2k', name + '.toml'))
    internal = {k: v for k, v in recipe['model']['internal_params'].items()
                if k in ('scale', 'metadata', 'max_combined_im_size')}
    handler = define_model(name, device='cpu', **internal)
    assert handler.max_combined_im_size == 20000 and handler.tiled_eval
    state = handler.module.state_dict()
    for key, shape in FULL_SIZE_KEYS.items():
        assert tuple(state[key].shape) == shape, key
    kinds = {}
    for key in state:
        kind = '.'.join(p if not p.isdigit() else '#' for p in key.split('.'))
        kinds[kind] = kinds.get(kind, 0) + 1
    expected = {'RG.#.rcab.#.conv_first.#.weight': 400, 'RG.#.rcab.#.conv_first.#.bias': 400,
                'RG.#.soca.conv_du.#.weight': 40, 'RG.#.soca.conv_du.#.bias': 40,
                'RG.#.conv_last.weight': 20, 'RG.#.conv_last.bias': 20,
                'non_local.non_local.g.#.weight': 1, 'non_local.non_local.phi.#.weight': 1,
                'non_local.non_local.theta.weight': 1, 'non_local.non_local.W.weight': 1,
                'head.#.weight': 1, 'tail.#.#.weight': 2, 'tail.#.weight': 1, 'gamma': 1}
    if name == 'qsan':
        assert handler.num_metadata == 10
        expected['RG.#.rcab.#.q_layer.attribute_integrator.#.weight'] = 400
        assert tuple(state['RG.19.rcab.9.q_layer.attribute_integrator.0.weight'].shape) \
            == (32, 10, 1, 1)
        assert tuple(state['RG.19.rcab.9.q_layer.attribute_integrator.2.weight'].shape) \
            == (64, 32, 1, 1)
    for kind, count in expected.items():
        assert kinds.get(kind) == count, kind
    assert len(state) == sum(kinds.values()) and not drop_dead_reference_keys(name, {
        'conv_last.weight': 0, 'RG.3.gamma': 0, 'non_local.soca.conv_du.0.bias': 0})
    assert state['gamma'].item() == 0.0
    assert state['non_local.non_local.W.weight'].abs().max() == 0
    assert 0 < state['non_local.non_local.theta.weight'].abs().max() <= 1 / 8
    convert_torch_state_dict(name, {k: v.numpy() for k, v in state.items()}, scale=4)


# --- training -----------------------------------------------------------------------------
TRAIN = {'lr': 1e-3, 'scale': 2, 'scheduler': 'cosine_annealing_warm_restarts',
         'scheduler_params': {'t_mult': 1, 'restart_period': 4, 'lr_min': 1e-6},
         'grad_clip': 0.5}


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_training_trajectory_matches_sisr_tpu(name):
    """8 steps of the port's run_train (autograd through the five Newton-Schulz
    iterations and the non-local softmax) against sisr_tpu's (jax.grad under
    jax.checkpoint) from the same weights (live attention) and batches: losses within
    rtol 2e-4, parameters within 5e-5 after."""
    arch = {**FAMILIES[name], **TRAIN}
    port = define_model(name, device='cpu', seed=3, **arch)
    port.set_metadata_keys(KEYS)
    theirs = jax_define_model(name, eval_mode=False, **arch)
    theirs.set_metadata_keys(KEYS)
    theirs.init_state(spatial=(12, 12), batch=2)
    params = with_live_attention(theirs.state.params, seed=4)
    theirs.state = theirs.state.replace(params=jax.tree.map(jnp.asarray, params))
    port.module.load_state_dict(state_dict_from_jax(name, params))
    rng = np.random.RandomState(42)
    ours_losses, their_losses = [], []
    for _ in range(8):
        batch = {'lr': rng.rand(2, 12, 12, 3).astype(np.float32),
                 'hr': rng.rand(2, 24, 24, 3).astype(np.float32)}
        if name == 'qsan':
            batch['metadata'] = rng.rand(2, 10).astype(np.float32)
        ours_losses.append(float(port.run_train(**batch)[0]))
        their_losses.append(float(theirs.run_train(**batch)[0]))
    np.testing.assert_allclose(ours_losses, their_losses, rtol=2e-4, atol=2e-6)
    ours = jax.tree.map(lambda t: t.detach().numpy(),
                        params_from_state_dict(name, port.module.state_dict()))
    deltas = jax.tree.leaves(jax.tree.map(lambda a, b: float(np.abs(a - np.asarray(b)).max()),
                                          ours, theirs.state.params))
    assert max(deltas) < 5e-5
    assert abs(port.module.gamma.item() - 0.5) > 1e-4  # gamma trains


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_train_sisr_runs_the_shipped_recipe(tmp_path, name):
    """train_sisr (--no fused_val: the standard validation epoch) on configs/div2k/<name>
    .toml as shipped, its model cut to 1 group x 1 block of 16 features and its data
    pointed at a seeded folder: two epochs, finite losses and metrics, checkpoints."""
    here = os.path.dirname(os.path.dirname(__file__))
    config = toml_io.load(os.path.join(here, 'configs', 'div2k', name + '.toml'))
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
    config['model']['internal_params'].update(n_resgroups=1, n_resblocks=1, n_feats=16,
                                              reduction=4)
    config['training'].update(gpu='off', epoch_cutoff=2, save_samples=False, logging='none')
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
