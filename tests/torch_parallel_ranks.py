"""The rank program of tests/test_torch_parallel.py: one of two gloo ranks on the CPU,
started as its own process through sisr_tpu's launcher contract (SISR_TPU_*), that
runs each case of the test on its slice and saves what it computed for the test to
compare against one process and against sisr_tpu.  It imports no JAX.

    python tests/torch_parallel_ranks.py OUT_DIR   (with SISR_TPU_* set)
"""
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

TIMEOUT_S = 60  # the process group's: a rank that dies ends the other's waits
TRAIN = {'scale': 2, 'lr': 1e-3, 'grad_clip': 0.5}
CASES = {  # the train step's cases: (model name, structure, weight seed)
    'edsr': ('edsr', {'num_features': 8, 'num_blocks': 1}, 8),
    'rcan': ('rcan', {'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 4}, 4),
    'sparnet': ('sparnet', {'min_ch': 8, 'max_ch': 16, 'in_size': 16, 'out_size': 16,
                            'min_feat_size': 8, 'res_depth': 1, 'bottleneck_size': 16}, 5),
}
EVAL_RCAN = {'scale': 4, 'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 32, 'reduction': 16}
TILE_EDSR = {'scale': 4, 'num_features': 8, 'num_blocks': 2, 'max_combined_im_size': 900}


def handler(case, **kwargs):
    from sisr_tpu_torch.models.handlers import define_model
    name, arch, seed = CASES[case]
    model = define_model(name, device='cpu', seed=seed, **{**TRAIN, **arch, **kwargs})
    model.set_metadata_keys([])
    return model


def train_batch(case, n=8, seed=0):
    """A numpy-seeded batch of n: SPARNet's LR at HR size (a pre-upscaled family), its
    two halves of other statistics, so per-rank BatchNorm statistics differ from the
    global ones."""
    rng = np.random.RandomState(seed)
    side = 16 if case == 'sparnet' else 8
    lr = rng.rand(n, side, side, 3).astype(np.float32)
    lr[n // 2:] = lr[n // 2:] * 0.3 + 0.6
    hr = rng.rand(n, 16, 16, 3).astype(np.float32)
    return {'lr': lr, 'hr': hr}


def eval_batch(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return {'lr': rng.randint(0, 256, (n, 16, 16, 3)).astype(np.uint8),
            'hr': rng.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8)}


def tile_image(seed=3):
    return np.random.RandomState(seed).rand(1, 40, 48, 3).astype(np.float32)


def state(model):
    return {k: v.detach().clone() for k, v in model.module.state_dict().items()}


def grads(model):
    """The gradients the step's update took (averaged over the ranks, clipped)."""
    return {k: p.grad.detach().clone() for k, p in model.module.named_parameters()}


def main(out_dir):
    from sisr_tpu_torch.models.handlers import define_model
    from sisr_tpu_torch.parallel import MeshContext, distributed, maybe_init_distributed
    assert maybe_init_distributed(device='cpu', timeout=TIMEOUT_S) is True
    assert maybe_init_distributed(device='cpu') is True  # idempotent
    mesh = MeshContext(n_devices=2, device='cpu')
    out = {'rank': distributed.rank(), 'world': distributed.world_size(),
           'primary': distributed.is_primary_host(), 'backend': torch.distributed.get_backend()}

    for case in CASES:  # one DDP step on this rank's half of the batch of 8
        model = handler(case)
        model.set_mesh(mesh)
        loss, _ = model.run_train(**mesh.shard_batch(train_batch(case)))
        out['train_' + case] = {'loss': float(loss), 'state': state(model),
                                'grads': grads(model)}
    ragged = handler('edsr')  # a batch of 5 runs whole on both ranks
    ragged.set_mesh(mesh)
    loss, _ = ragged.run_train(**mesh.shard_batch(train_batch('edsr', n=5, seed=1)))
    out['train_edsr_ragged'] = {'loss': float(loss), 'state': state(ragged)}
    local = handler('sparnet')  # per-rank BatchNorm statistics, for contrast
    local.set_mesh(mesh)
    for m in local.module.modules():
        if hasattr(m, 'sync_stats'):
            m.sync_stats = False
    loss, _ = local.run_train(**mesh.shard_batch(train_batch('sparnet')))
    out['train_sparnet_per_rank_stats'] = {'loss': float(loss), 'state': state(local)}

    tiles = {}
    for label in ('whole', 'sharded'):  # the grid on this rank alone, and shared out
        tiled = define_model('edsr', device='cpu', eval_mode=True, seed=8, **TILE_EDSR)
        tiled.set_metadata_keys([])
        tiled.tiled_eval = True
        if label == 'sharded':
            tiled.set_mesh(mesh)
        with torch.inference_mode():
            tiles[label] = tiled._tiled_forward({'lr': torch.from_numpy(tile_image())})
    out['tiles'] = tiles

    rcan = define_model('rcan', device='cpu', eval_mode=True, seed=2, **EVAL_RCAN)
    rcan.set_metadata_keys([])
    rcan.set_mesh(mesh)
    (keys, rows), _ = rcan.run_eval_fused(eval_batch())
    sr, _, _ = rcan.run_eval(eval_batch()['lr'].astype(np.float32) / 255.0)
    rcan.set_int8(True)
    (_, int8_rows), _ = rcan.run_eval_fused(eval_batch(seed=1))
    out['eval'] = {'keys': keys, 'rows': rows, 'sr': sr, 'int8_rows': int8_rows,
                   'int8_scales': {k: float(v) for k, v in rcan._int8_ctx[2].items()}}

    batch = {'lr': np.arange(8 * 2).reshape(8, 2).astype(np.float32), 'tag': list('abcdefgh'),
             'ragged': np.arange(5)}
    stacked = {'lr': np.arange(2 * 4 * 3).reshape(2, 4, 3)}
    out['shard'] = {'divisible': mesh.shard_batch(batch),
                    'ragged': mesh.shard_batch({'lr': np.arange(5 * 2).reshape(5, 2)}),
                    'stacked': mesh.shard_batch(stacked, stacked_steps=True),
                    'padded': mesh.pad_batch_to_devices({'lr': np.arange(5 * 2)
                                                         .reshape(5, 2)}, keys=('lr',)),
                    'tensor': mesh.shard_batch({'lr': torch.arange(6)})}
    torch.save(out, os.path.join(out_dir, 'rank%d.pt' % distributed.rank()))
    distributed.barrier()
    print('RANK_DONE %d' % distributed.rank())


if __name__ == '__main__':
    main(sys.argv[1])
