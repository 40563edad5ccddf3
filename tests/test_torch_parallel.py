"""sisr_tpu_torch's data parallelism (``parallel/``, ``BaseHandler.set_mesh``) on the CPU:
two gloo ranks, each its own process started through sisr_tpu's launcher contract
(``tests/torch_parallel_ranks.py``), against one process of the port and against
sisr_tpu's ``set_mesh(MeshContext(n_devices=2))`` on the same numpy-seeded inputs, with
the port's seeded weights given to sisr_tpu through its converter.

Bars: a train step's loss and parameters within rtol 2e-4 of sisr_tpu's (the training
bar) and within 1e-6 of one process of the port; eval outputs within 1e-6 of one
process (metric rows: PSNR within 0.01 dB, SSIM within 1e-3 of sisr_tpu's)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.parallel import MeshContext as JaxMeshContext
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu_torch.data import loader as loader_mod
from sisr_tpu_torch.data.loader import DataLoader
from sisr_tpu_torch.models.handlers import available_models, define_model
from sisr_tpu_torch.parallel import MeshContext, distributed, maybe_init_distributed
from sisr_tpu_torch.tools.convert_weights import params_from_state_dict
from sisr_tpu_torch.utils.helpers import training_device
import torch_parallel_ranks as ranks_mod

HERE = os.path.dirname(os.path.abspath(__file__))
CONVERT = {'edsr': {'num_blocks': 1}, 'rcan': {'n_resgroups': 1, 'n_resblocks': 2}}
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}
LAUNCH_VARS = ('SISR_TPU_COORDINATOR', 'SISR_TPU_NUM_PROCESSES', 'SISR_TPU_PROCESS_ID',
               'SISR_TPU_MULTIHOST', 'RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
               'MASTER_PORT')


def free_port():
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def launch_ranks(argv, world, timeout, env_extra=None):
    """``argv`` as ``world`` processes through the SISR_TPU_* contract (localhost
    rendezvous, two CPU threads each); (each rank's output), every rank reaped within
    ``timeout`` seconds and any survivor killed."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env.update({'OMP_NUM_THREADS': '2', **(env_extra or {})})
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env={**env, 'SISR_TPU_COORDINATOR': 'localhost:%d' % port,
                     'SISR_TPU_NUM_PROCESSES': str(world), 'SISR_TPU_PROCESS_ID': str(rank)}))
        outs = []
        for rank, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, 'rank %d failed:\n%s' % (rank, out)
            outs.append(out)
        return outs
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """What each of two ranks computed (rank0.pt, rank1.pt)."""
    out_dir = str(tmp_path_factory.mktemp('ranks'))
    outs = launch_ranks([sys.executable, os.path.join(HERE, 'torch_parallel_ranks.py'),
                         out_dir], 2, timeout=150)
    assert 'RANK_DONE 0' in outs[0] and 'RANK_DONE 1' in outs[1]
    assert 'backend gloo (CPU ranks)' in outs[0]
    return [torch.load(os.path.join(out_dir, 'rank%d.pt' % r), weights_only=False)
            for r in range(2)]


def one_process(case, n=8, seed=0, with_grads=False):
    model = ranks_mod.handler(case)
    loss, _ = model.run_train(**ranks_mod.train_batch(case, n=n, seed=seed))
    if with_grads:
        return float(loss), ranks_mod.state(model), ranks_mod.grads(model)
    return float(loss), ranks_mod.state(model)


def assert_states(ours, theirs, atol):
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_allclose(ours[key].float().numpy(), theirs[key].float().numpy(),
                                   atol=atol, rtol=0, err_msg=key)


# --- the launcher contract ----------------------------------------------------------------
def test_ranks_joined_one_gloo_group(ranks):
    assert [r['rank'] for r in ranks] == [0, 1]
    assert [r['world'] for r in ranks] == [2, 2]
    assert [r['primary'] for r in ranks] == [True, False]
    assert {r['backend'] for r in ranks} == {'gloo'}


def test_maybe_init_distributed_contract(monkeypatch):
    """A no-op without a launcher environment; a partial one raises (sisr_tpu's rule:
    never N rank-0 jobs); without CUDA the card ranks raise before any rendezvous."""
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    assert maybe_init_distributed() is False
    assert maybe_init_distributed(device='cpu') is False  # stays a no-op
    assert not distributed.launcher_present() and distributed.world_size() == 1
    assert distributed.is_primary_host() and distributed.broadcast_object(3) == 3
    distributed.barrier()  # no group: returns
    monkeypatch.setenv('SISR_TPU_COORDINATOR', 'localhost:1')
    with pytest.raises(RuntimeError, match='SISR_TPU_NUM_PROCESSES and '
                                           'SISR_TPU_PROCESS_ID are missing'):
        maybe_init_distributed()
    monkeypatch.setenv('SISR_TPU_NUM_PROCESSES', '2')
    with pytest.raises(RuntimeError, match='SISR_TPU_PROCESS_ID is missing'):
        maybe_init_distributed()
    monkeypatch.delenv('SISR_TPU_COORDINATOR')
    monkeypatch.delenv('SISR_TPU_NUM_PROCESSES')
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(RuntimeError, match='MASTER_ADDR and MASTER_PORT missing'):
        maybe_init_distributed()
    monkeypatch.delenv('RANK')
    monkeypatch.delenv('WORLD_SIZE')
    monkeypatch.setenv('SISR_TPU_MULTIHOST', '1')
    with pytest.raises(RuntimeError, match='discovers nothing'):
        maybe_init_distributed()


def test_card_ranks_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv('SISR_TPU_COORDINATOR', 'localhost:1')
    monkeypatch.setenv('SISR_TPU_NUM_PROCESSES', '2')
    monkeypatch.setenv('SISR_TPU_PROCESS_ID', '0')
    with pytest.raises(RuntimeError, match='CUDA'):
        maybe_init_distributed()
    for call in (lambda: training_device('multi'), lambda: MeshContext(),
                 lambda: distributed.spawn_local_ranks(print)):
        with pytest.raises(RuntimeError, match='CUDA'):
            call()
    assert MeshContext(device='cpu').device == torch.device('cpu')
    with pytest.raises(ValueError, match='one process per card'):
        MeshContext(n_devices=2, device='cpu')


# --- the train step -----------------------------------------------------------------------
@pytest.mark.parametrize('case', ['edsr', 'rcan'])
def test_ddp_train_step_matches_sisr_tpu_mesh_and_one_process(ranks, case):
    """Each rank steps on its half of a batch of 8; DistributedDataParallel averages the
    gradients before the clip: the loss is the global mean and the parameters those of
    sisr_tpu's step over a 2-device mesh and of one process's step on the whole batch."""
    loss_1, state_1 = one_process(case)
    for r in ranks:
        ours = r['train_' + case]
        assert abs(ours['loss'] - loss_1) <= 1e-6
        assert_states(ours['state'], state_1, atol=1e-6)
    assert_states(ranks[0]['train_' + case]['state'], ranks[1]['train_' + case]['state'],
                  atol=0)

    name, arch, _ = ranks_mod.CASES[case]
    start = ranks_mod.handler(case)
    sd = {k: v.detach().numpy().copy() for k, v in start.module.state_dict().items()}
    theirs = jax_define_model(name, eval_mode=False, **{**ranks_mod.TRAIN, **arch})
    theirs.set_metadata_keys([])
    theirs.init_state(spatial=(8, 8), batch=2)
    theirs.state = theirs.state.replace(params=convert_torch_state_dict(
        name, sd, scale=2, **CONVERT[case]))
    theirs.set_mesh(JaxMeshContext(n_devices=2))
    loss, _ = theirs.run_train(**ranks_mod.train_batch(case))
    np.testing.assert_allclose(ranks[0]['train_' + case]['loss'], float(loss), rtol=2e-4)
    ours = params_from_state_dict(name, ranks[0]['train_' + case]['state'])
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs.state.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6)


def test_ragged_batch_runs_whole_on_every_rank(ranks):
    """A batch of 5 does not divide 2 ranks: both step on all of it, as one process."""
    loss_1, state_1 = one_process('edsr', n=5, seed=1)
    for r in ranks:
        assert abs(r['train_edsr_ragged']['loss'] - loss_1) <= 1e-6
        assert_states(r['train_edsr_ragged']['state'], state_1, atol=1e-6)


def test_sparnet_batchnorm_takes_the_global_batch_statistics(ranks):
    """SPARNet's BatchNorms normalise by the statistics of both ranks' halves (and move
    the running ones by them), as one process does on the whole batch; per-rank
    statistics (the halves differ) would not.  The gradients agree within rtol 1e-5
    (sums of 2048 terms in another order) and 1e-6 of the largest; the parameters within
    1e-6 wherever Adam's first step is well conditioned
    (|g| > 1e-5: where |g| nears its eps of 1e-8, lr * g / (|g| + eps) turns float-level
    changes of g into changes up to lr, in one process too)."""
    loss_1, state_1, grads_1 = one_process('sparnet', with_grads=True)
    top = max(float(g.abs().max()) for g in grads_1.values())
    for r in ranks:
        ours = r['train_sparnet']
        assert abs(ours['loss'] - loss_1) <= 1e-6
        for key, g in grads_1.items():
            np.testing.assert_allclose(ours['grads'][key].numpy(), g.numpy(),
                                       atol=1e-6 * top, rtol=1e-5, err_msg=key)
            steady = g.abs() > 1e-5
            np.testing.assert_allclose(ours['state'][key][steady].numpy(),
                                       state_1[key][steady].numpy(), atol=1e-6, rtol=0,
                                       err_msg=key)
        buffers = {k: v for k, v in state_1.items() if k not in grads_1}
        assert any(k.endswith('running_var') for k in buffers)
        assert_states({k: ours['state'][k] for k in buffers}, buffers, atol=1e-6)
    local = ranks[0]['train_sparnet_per_rank_stats']['state']
    running = [k for k in state_1 if k.endswith('running_mean')]
    assert max(float((local[k] - state_1[k]).abs().max()) for k in running) > 1e-3


FAMILY_CASES = {
    'rcan': ('rcan', {'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 4}),
    'han': ('han', {'n_resgroups': 2, 'n_resblocks': 1, 'n_feats': 16, 'reduction': 4}),
    'edsr': ('edsr', {'num_features': 8, 'num_blocks': 1}),
    'qedsr': ('qedsr', {'num_features': 8, 'num_blocks': 1, 'q_layer_nonlinearity': True}),
    'qhan': ('qhan', {'n_resgroups': 2, 'n_resblocks': 1, 'n_feats': 16}),
    'san': ('san', {'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 4}),
    'qsan': ('qsan', {'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 4}),
    'srmd': ('srmd', {'nc': 16, 'nb': 4}),
    'sftmd': ('sftmd', {'num_features': 16, 'num_blocks': 2, 'q_injection': True}),
    'sftmd_concat': ('sftmd', {'num_features': 16, 'num_blocks': 2,
                               'concat_strategy': True}),
    'srcnn': ('srcnn', {'kernel_pattern': [9, 1, 5], 'channel_pattern': [1, 16, 8, 1]}),
    'vdsr': ('vdsr', {'kernel_pattern': [3] * 4, 'channel_pattern': [1, 16, 16, 16, 1]}),
    'sparnet': ('sparnet', ranks_mod.CASES['sparnet'][1]),
    'qsparnet': ('qsparnet', {**ranks_mod.CASES['sparnet'][1],
                              'metadata_encoder_only': True}),
    **{'qrcan_%s_%s' % (style, q): ('qrcan', {'n_resgroups': 1, 'n_resblocks': 2,
                                              'n_feats': 16, 'style': style,
                                              'include_q_layer': q})
       for style in ('modulate', 'standard', 'max_concat', 'softmax', 'mini_concat')
       for q in (False, True)},
    'qrcan_pixel_attention': ('qrcan', {'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16,
                                        'style': 'standard',
                                        'include_pixel_attention': True}),
}


@pytest.mark.parametrize('case', sorted(FAMILY_CASES))
def test_every_parameter_gets_a_gradient(case):
    """Why ``set_mesh`` leaves DistributedDataParallel's find_unused_parameters off:
    every registered family's train forward reaches each of its parameters."""
    name, arch = FAMILY_CASES[case]
    meta = {'metadata': ['blur_kernel']} if available_models[name].uses_metadata else {}
    model = define_model(name, device='cpu', scale=2, **{**arch, **meta})
    model.set_metadata_keys(['blur_kernel'] * 10)
    rng = np.random.RandomState(0)
    side = 16 if model.im_input == 'interp' else 8
    batch = {'lr': rng.rand(2, side, side, model.in_channels).astype(np.float32),
             'hr': rng.rand(2, 16, 16, 1 if model.colorspace == 'ycbcr' else 3)
             .astype(np.float32),
             'metadata': rng.rand(2, 10).astype(np.float32)}
    model.backward(model.forward_loss(batch))
    assert [n for n, p in model.module.named_parameters() if p.grad is None] == []


# --- eval -----------------------------------------------------------------------------------
def test_tile_grid_sharded_over_ranks(ranks):
    """The tile batch shared out over 2 ranks and gathered (mirrors
    tests/test_parallel.py's tiled eval over the mesh): every rank stitches the same
    image as the unsharded grid, and its centres match the whole image's forward."""
    from sisr_tpu_torch.models.handlers import define_model as port_define
    cfg = {k: v for k, v in ranks_mod.TILE_EDSR.items() if k != 'max_combined_im_size'}
    full = port_define('edsr', device='cpu', eval_mode=True, seed=8, **cfg)
    full.set_metadata_keys([])
    out_full, _, _ = full.run_eval(ranks_mod.tile_image())
    s = 4
    for r in ranks:
        sharded = r['tiles']['sharded'].numpy()
        np.testing.assert_allclose(sharded, r['tiles']['whole'].numpy(), atol=1e-6, rtol=0)
        assert sharded.shape == out_full.shape
        for (cy, cx) in [(10, 12), (30, 36)]:
            region = np.s_[:, cy * s - 8:cy * s + 8, cx * s - 8:cx * s + 8, :]
            np.testing.assert_allclose(sharded[region], out_full[region], atol=1e-4)


def _eval_rcan():
    model = define_model('rcan', device='cpu', eval_mode=True, seed=2, **ranks_mod.EVAL_RCAN)
    model.set_metadata_keys([])
    return model


def test_fused_eval_over_ranks_gives_sisr_tpus_metric_rows_in_order(ranks):
    """Each rank runs its 2 of 4 images and the (K, 4) rows are gathered in global
    order: one process's rows, and sisr_tpu's over a 2-device mesh."""
    one = _eval_rcan()
    (keys, rows_1), _ = one.run_eval_fused(ranks_mod.eval_batch())
    sd = {k: v.detach().numpy().copy() for k, v in one.module.state_dict().items()}
    theirs = jax_define_model('rcan', eval_mode=True, **ranks_mod.EVAL_RCAN)
    theirs.set_metadata_keys([])
    theirs.init_state(spatial=(16, 16))
    theirs.state = theirs.state.replace(params=convert_torch_state_dict(
        'rcan', sd, scale=4, n_resgroups=2, n_resblocks=2))
    theirs.set_mesh(JaxMeshContext(n_devices=2))
    (jax_keys, jax_rows), _ = theirs.run_eval_fused(ranks_mod.eval_batch())
    assert tuple(jax_keys) == keys
    for r in ranks:
        assert r['eval']['keys'] == keys and r['eval']['rows'].shape == (len(keys), 4)
        np.testing.assert_allclose(r['eval']['rows'].numpy(), rows_1.numpy(), atol=1e-5)
        for i, key in enumerate(keys):
            np.testing.assert_allclose(r['eval']['rows'][i].numpy(),
                                       np.asarray(jax_rows)[i], atol=BARS[key.split('>')[1]],
                                       rtol=0, err_msg=key)


def test_standard_eval_over_ranks_gathers_the_sr(ranks):
    sr_1, _, _ = _eval_rcan().run_eval(ranks_mod.eval_batch()['lr'].astype(np.float32) / 255.0)
    for r in ranks:
        np.testing.assert_allclose(r['eval']['sr'], sr_1, atol=1e-6, rtol=0)


def test_int8_calibrates_on_the_whole_first_batch(ranks):
    """Each rank holds half of the first batch; calibration gathers it whole, so both
    ranks quantise with one process's scales and give its rows."""
    one = _eval_rcan()
    one.set_int8(True)
    (_, rows_1), _ = one.run_eval_fused(ranks_mod.eval_batch(seed=1))
    scales_1 = {k: float(v) for k, v in one._int8_ctx[2].items()}
    assert ranks[0]['eval']['int8_scales'] == ranks[1]['eval']['int8_scales']
    assert ranks[0]['eval']['int8_scales'].keys() == scales_1.keys()
    for key, value in scales_1.items():
        assert ranks[0]['eval']['int8_scales'][key] == pytest.approx(value, rel=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r['eval']['int8_rows'].numpy(), rows_1.numpy(), atol=1e-5)


# --- shard_batch and pad_batch_to_devices against sisr_tpu's rules -------------------------------
def test_shard_batch_follows_sisr_tpus_divisibility_rule(ranks):
    """A divisible batch axis gives rank r sisr_tpu's device-r shard, in order; a
    ragged one stays whole; strings pass whole; ``stacked_steps`` cuts axis 1."""
    jax_mesh = JaxMeshContext(n_devices=2)
    batch = {'lr': np.arange(8 * 2).reshape(8, 2).astype(np.float32),
             'tag': list('abcdefgh'), 'ragged': np.arange(5)}
    theirs = jax_mesh.shard_batch(batch)
    shards = sorted(theirs['lr'].addressable_shards, key=lambda sh: sh.index[0].start)
    for r, ours in enumerate(ranks):
        div = ours['shard']['divisible']
        np.testing.assert_array_equal(div['lr'], np.asarray(shards[r].data))
        assert div['tag'] == batch['tag'] and div['_shard_factor'] == 2
        np.testing.assert_array_equal(div['ragged'], np.asarray(theirs['ragged']))
        ragged = ours['shard']['ragged']
        assert '_shard_factor' not in ragged
        np.testing.assert_array_equal(ragged['lr'], np.arange(10).reshape(5, 2))
        stacked = ours['shard']['stacked']['lr']
        np.testing.assert_array_equal(stacked, np.arange(24).reshape(2, 4, 3)[:, 2 * r:2 * r + 2])
        assert ours['shard']['tensor']['lr'].tolist() == [3 * r, 3 * r + 1, 3 * r + 2]
    jax_stacked = jax_mesh.shard_batch({'lr': np.arange(24).reshape(2, 4, 3)},
                                       stacked_steps=True)['lr']
    assert jax_stacked.sharding.spec == jax.sharding.PartitionSpec(None, 'data')


def test_pad_batch_to_devices_repeats_the_last_element(ranks):
    theirs = JaxMeshContext(n_devices=2).pad_batch_to_devices(
        {'lr': np.arange(10).reshape(5, 2)}, keys=('lr',))
    for r in ranks:
        np.testing.assert_array_equal(r['shard']['padded']['lr'], theirs['lr'])
    one = MeshContext(device='cpu')  # one rank: nothing to pad, nothing to cut
    batch = {'lr': torch.arange(5)}
    assert one.pad_batch_to_devices(batch)['lr'] is batch['lr']
    assert one.shard_batch(batch) is batch and one.gather(batch['lr']) is batch['lr']


# --- the loader's process shards ------------------------------------------------------------
class _Items:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {'lr': np.full((2, 2, 3), i, np.uint8), 'tag': 'im_%d' % i}


@pytest.mark.parametrize('workers', [1, 3])
def test_loader_process_shard_loads_each_ranks_slice(workers):
    """Both ranks build one global order (the shuffle RNG seeded alike); each loads its
    contiguous half of every batch of 4, and the ragged tail of 3 whole; ITEMS_LOADED
    counts what this process loaded."""
    import random
    orders = []
    for rank in range(2):
        random.seed(5)
        loader = DataLoader(_Items(), batch_size=4, shuffle=True, num_workers=workers,
                            process_shard=(rank, 2))
        before = loader_mod.ITEMS_LOADED
        batches = list(loader)
        assert loader_mod.ITEMS_LOADED - before == 2 + 2 + 3
        assert [b.get('_shard_factor', 1) for b in batches] == [2, 2, 1]
        orders.append([b['tag'] for b in batches])
    random.seed(5)
    whole = [b['tag'] for b in DataLoader(_Items(), batch_size=4, shuffle=True)]
    for i in range(2):
        assert orders[0][i] + orders[1][i] == whole[i]
    assert orders[0][2] == orders[1][2] == whole[2]
