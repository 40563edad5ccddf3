"""train_sisr of sisr_tpu_torch as two CPU ranks (gloo), launched as separate processes
through sisr_tpu's launcher contract (SISR_TPU_COORDINATOR / _NUM_PROCESSES /
_PROCESS_ID), against the same command in one process: the counterpart of
tests/test_multiprocess.py, on numpy-seeded synthetic pairs (no Set5 needed).

Asserts: (a) both ranks joined one 2-rank group, (b) rank 0 alone wrote the experiment
(one config.toml, one checkpoint and one summary.csv row per epoch), (c) each rank's
loader decoded only its half of every training batch (8 of 16, and the 2 validation
images: 10 items) where one process decoded 18, (d) the losses and validation metrics
equal one process's within rtol 1e-5."""
import os
import re
import sys

import numpy as np
import pandas as pd
from PIL import Image

from test_torch_parallel import launch_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WRAPPER = r"""
import os, sys
sys.path.insert(0, %(repo)r)
from sisr_tpu_torch.parallel import distributed
# the process group's timeout bounds every wait; the CLI's own call is then a no-op
joined = distributed.maybe_init_distributed(device='cpu', timeout=60)
from sisr_tpu_torch.net_train import experiment_setup
experiment_setup.main(args=['--parameters', sys.argv[1]], standalone_mode=False)
from sisr_tpu_torch.data import loader
print('WORLD joined=%%s rank=%%d world=%%d' %% (joined, distributed.rank(),
                                               distributed.world_size()))
print('ITEMS_LOADED %%d rank=%%d' %% (loader.ITEMS_LOADED, distributed.rank()))
print('RANK_DONE %%d' %% distributed.rank())
"""

TRAIN_TOML = """
experiment = "mp_edsr"
experiment_save_loc = "{save_loc}"
[data]
batch_size = 8
dataloader_threads = 1
[data.training_sets.data_1]
lr = "{lr_dir}"
hr = "{hr_dir}"
crop = 16
[data.eval_sets.data_1]
lr = "{lr_dir}"
hr = "{hr_dir}"
cutoff = 2
[model]
name = "edsr"
[model.internal_params]
scale = 4
num_features = 8
num_blocks = 1
[training]
gpu = "off"
num_epochs = 1
metrics = [ "PSNR" ]
fused_val = true
"""


def _build_data(root, n=16):
    """n pairs of a 16^2 LR (the crop: no freedom, so each rank's own crop draws cannot
    move the trajectory) and its 64^2 HR, from numpy seed 0."""
    rng = np.random.RandomState(0)
    lr_dir, hr_dir = os.path.join(root, 'lr'), os.path.join(root, 'hr')
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    for i in range(n):
        hr = Image.fromarray(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8))
        hr.save(os.path.join(hr_dir, 'im%02d.png' % i))
        hr.resize((16, 16), Image.BICUBIC).save(os.path.join(lr_dir, 'im%02d.png' % i))
    return lr_dir, hr_dir


def _config(root, tag, lr_dir, hr_dir):
    save_loc = os.path.join(root, 'results_%s' % tag)
    os.makedirs(save_loc)
    cfg = os.path.join(root, 'train_%s.toml' % tag)
    with open(cfg, 'w') as f:
        f.write(TRAIN_TOML.format(save_loc=save_loc, lr_dir=lr_dir, hr_dir=hr_dir))
    return cfg, os.path.join(save_loc, 'mp_edsr')


def test_two_rank_training_matches_one_process(tmp_path):
    root = str(tmp_path)
    lr_dir, hr_dir = _build_data(root)
    wrapper = os.path.join(root, 'wrap.py')
    with open(wrapper, 'w') as f:
        f.write(WRAPPER % {'repo': REPO})
    cfg_one, exp_one = _config(root, 'one', lr_dir, hr_dir)
    cfg_two, exp_two = _config(root, 'two', lr_dir, hr_dir)
    (out_one,) = launch_ranks([sys.executable, wrapper, cfg_one], 1, timeout=120)
    outs = launch_ranks([sys.executable, wrapper, cfg_two], 2, timeout=120)

    # (a) one group of two gloo ranks (the 1-rank launch is a group of one)
    assert 'WORLD joined=True rank=0 world=1' in out_one, out_one
    assert 'WORLD joined=True rank=0 world=2' in outs[0], outs[0]
    assert 'WORLD joined=True rank=1 world=2' in outs[1], outs[1]
    assert 'backend gloo (CPU ranks)' in outs[0]

    # (b) rank 0 alone wrote the experiment, once
    for exp in (exp_one, exp_two):
        assert sorted(os.listdir(os.path.join(exp, 'saved_models'))) == ['train_model_0']
        assert [f for f in os.listdir(exp) if f.startswith('config')] == ['config.toml']
        assert len(pd.read_csv(os.path.join(exp, 'result_outputs', 'summary.csv'))) == 1

    # (c) input sharded by process: 8 of the 16 training items and the 2 validation
    # images per rank, 16 + 2 in one process
    counts = {int(m.group(2)): int(m.group(1)) for out in outs
              for m in [re.search(r'ITEMS_LOADED (\d+) rank=(\d+)', out)] if m}
    assert counts == {0: 10, 1: 10}, counts
    assert 'ITEMS_LOADED 18 rank=0' in out_one, out_one

    # (d) the trajectory of one process
    one = pd.read_csv(os.path.join(exp_one, 'result_outputs', 'summary.csv'))
    two = pd.read_csv(os.path.join(exp_two, 'result_outputs', 'summary.csv'))
    assert list(one.columns) == list(two.columns)
    assert {'train-loss', 'val-loss', 'val-PSNR'} <= set(one.columns)
    for col in one.columns:
        np.testing.assert_allclose(two[col].values, one[col].values, rtol=1e-5,
                                   err_msg='column %s diverged' % col)
