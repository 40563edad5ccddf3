"""sisr_tpu_torch's CelebA attributes, legacy blur-kernel files and CelebaSplitSampler
against sisr_tpu's on the CPU, on a synthetic CelebA-format attribute file (the 40
columns of list_attr_celeba.txt, -1 / 1) for images named as CelebA's: the attribute
merge with and without amplification and with the ``age`` / ``gender`` renames, the
merge order with a degradation-metadata CSV and a legacy ``.npy`` of kernel codes, the
training data's metadata through ``sisr_data_setup``, the sampler's order under one
seed (and the loader that follows it), and eval_sisr --fused_eval with
--data_attributes on a Q-RCAN that takes two attributes and the blur kernel.

Bars: dictionaries, keys, metadata vectors and orders equal (the same pandas and numpy
code); fused metrics within 0.01 dB PSNR and 1e-3 SSIM per image."""
import os
import random

import numpy as np
import pandas as pd
import pytest

from sisr_tpu.data import datasets as jax_datasets
from sisr_tpu.data import loader as jax_loader
from sisr_tpu.data.setup import sisr_data_setup as jax_data_setup
from sisr_tpu.evaluation.standard_eval import EvalHub as JaxEvalHub
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu.utils.toml_io import convert_default_none_dict as jax_default_none
from sisr_tpu_torch.configuration.constants import celeba_attributes
from sisr_tpu_torch.data import datasets as torch_datasets
from sisr_tpu_torch.data import loader as torch_loader
from sisr_tpu_torch.data.setup import sisr_data_setup
from sisr_tpu_torch.evaluation.standard_eval import EvalHub
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.utils import toml_io

N_IMAGES = 6
BARS = {'PSNR': 0.01, 'SSIM': 1e-3}


def write_attributes(path, stems, seed=0):
    """A list_attr_celeba.txt for ``stems`` (rows ``<stem>.jpg``), random -1 / 1."""
    rng = np.random.RandomState(seed)
    with open(path, 'w') as f:
        f.write('%d\n%s\n' % (len(stems), ' '.join(celeba_attributes)))
        for stem in stems:
            f.write('%s.jpg %s\n' % (stem, ' '.join(
                '%2d' % v for v in rng.choice([-1, 1], len(celeba_attributes)))))


@pytest.fixture(scope='module')
def faces(tmp_path_factory):
    """LR/HR pairs named as CelebA's (000001.png ...), their degradation_metadata.csv,
    an attribute file and a legacy .npy of 10-value kernel codes."""
    root = str(tmp_path_factory.mktemp('celeba'))
    lr_dir, hr_dir = build_workload(root, N_IMAGES, lr_size=8, metadata_cols=10)
    meta = pd.read_csv(os.path.join(lr_dir, 'degradation_metadata.csv'), index_col=0)
    names = {old: '%06d.png' % (i + 1) for i, old in enumerate(meta.index)}
    for folder in (lr_dir, hr_dir):
        for old, new in names.items():
            os.rename(os.path.join(folder, old), os.path.join(folder, new))
    meta.index = [names[i] for i in meta.index]
    meta.index.name = 'image'
    meta.to_csv(os.path.join(lr_dir, 'degradation_metadata.csv'))
    attributes = os.path.join(root, 'list_attr_celeba.txt')
    write_attributes(attributes, [n[:-4] for n in sorted(names.values())])
    legacy = os.path.join(root, 'legacy_kernels.npy')
    np.save(legacy, np.random.RandomState(4).rand(N_IMAGES, 10).astype(np.float32))
    return {'lr': lr_dir, 'hr': hr_dir, 'attributes': attributes, 'legacy': legacy,
            'names': sorted(names.values())}


def _assert_same(ours, theirs):
    assert ours[1] == theirs[1]
    assert sorted(ours[0]) == sorted(theirs[0])
    for key in theirs[0]:
        np.testing.assert_array_equal(ours[0][key], theirs[0][key], err_msg=key)


@pytest.mark.parametrize('selected,amplification', [
    ('all', None), ('all', True), (['gender', 'age'], None), (['gender', 'age'], True),
    (['Smiling', 'Male'], None)])
def test_read_celeba_attributes_matches(faces, selected, amplification):
    base = {name: np.array([0.5]) for name in faces['names']}
    ours = torch_datasets.read_celeba_attributes(faces['attributes'], base, selected,
                                                 amplification)
    theirs = jax_datasets.read_celeba_attributes(faces['attributes'], base, selected,
                                                 amplification)
    _assert_same(ours, theirs)
    assert len(ours[1]) == (40 if selected == 'all' else len(selected))
    values = np.concatenate([v[:-1] for v in ours[0].values()])
    assert set(values.tolist()) <= ({-2, 2} if amplification else {0, 1})


@pytest.mark.parametrize('amplification', [None, True])
def test_metadata_merge_order_matches(faces, amplification):
    """Legacy kernel codes first, then the attributes, then the CSV's columns."""
    args = (os.path.join(faces['lr'], 'degradation_metadata.csv'),)
    kwargs = dict(filenames=faces['names'], legacy_blur_kernels=faces['legacy'],
                  data_attributes=['gender', 'age'], attributes_loc=faces['attributes'],
                  attribute_amplification=amplification)
    ours = torch_datasets.read_augmentation_list(*args, **kwargs)
    theirs = jax_datasets.read_augmentation_list(*args, **kwargs)
    _assert_same(ours, theirs)
    assert ours[1] == ['blur_kernel'] * 10 + ['age', 'gender'] + ['blur_kernel'] * 10
    np.testing.assert_array_equal(ours[0][faces['names'][2]][:10],
                                  np.load(faces['legacy'])[2])


def _tables(faces, **extra):
    table = {'name': 'faces', 'lr': faces['lr'], 'hr': faces['hr'], 'crop': 4,
             'cutoff': [0, N_IMAGES], 'degradation_metadata': 'on_site',
             'metadata': ['gender', 'age'], 'attribute_amplification': True, **extra}
    return {'faces': table}, {'faces': dict(table, crop=None)}


def _setup(setup, faces, seed, **kwargs):
    np.random.seed(seed)
    random.seed(seed)
    tables = _tables(faces)
    if setup is jax_data_setup:  # sisr_tpu reads missing keys as None
        tables = [jax_default_none(t) for t in tables]
    train, _, = setup(*tables, batch_size=2, dataloader_threads=1, scale=4,
                      attributes={'faces': faces['attributes']}, **kwargs)
    return train


def test_setup_serves_attributes_and_the_sampler_orders_alike(faces):
    sampler = {'name': 'CelebaSplitSampler', 'selected_attribute': 'gender'}
    ours = _setup(sisr_data_setup, faces, 3, sampler_attributes=sampler)
    theirs = _setup(jax_data_setup, faces, 3, sampler_attributes=sampler)
    assert ours.dataset.metadata_keys == theirs.dataset.metadata_keys
    assert ours.dataset.metadata_keys == ['age', 'gender'] + ['blur_kernel'] * 10
    for a, b in zip(ours.dataset.metadata, theirs.dataset.metadata):
        np.testing.assert_array_equal(a, b)
    assert isinstance(ours.sampler, torch_loader.CelebaSplitSampler)
    genders = [m[1] for m in ours.dataset.metadata]
    for _ in range(2):  # two epochs: the sampler's own stream moves on alike
        order = list(iter(ours.sampler))
        assert order == list(iter(theirs.sampler))
        split = sum(g > 0 for g in genders)
        assert all(genders[i] > 0 for i in order[:split])
        assert all(genders[i] <= 0 for i in order[split:])
    # the loaders' third epoch follows their samplers: the same order of images
    tags = [[t for batch in loader for t in batch['tag']] for loader in (ours, theirs)]
    assert tags[0] == tags[1] and sorted(tags[0]) == sorted(ours.dataset.lr_filenames)


def test_sampler_needs_the_attribute(faces):
    train = _setup(sisr_data_setup, faces, 1)
    with pytest.raises(RuntimeError, match="'Smiling'"):
        torch_loader.CelebaSplitSampler(train.dataset, selected_attribute='Smiling')
    np.random.seed(2)
    ours = torch_loader.CelebaSplitSampler(train.dataset, selected_attribute='age')
    np.random.seed(2)
    theirs = jax_loader.CelebaSplitSampler(train.dataset, selected_attribute='age')
    assert list(iter(ours)) == list(iter(theirs)) and len(ours) == N_IMAGES


def test_eval_with_data_attributes_matches_sisr_tpu(tmp_path, faces):
    """eval_sisr --fused_eval --data_attributes: every attribute goes in front of the
    blur kernel ('all', CelebA's names), and a Q-RCAN that takes Male, Young and the
    kernel (12 values) scores as sisr_tpu's on the same weights."""
    internal = {'scale': 4, 'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16,
                'style': 'max_concat', 'include_q_layer': True,
                'metadata': ['blur_kernel', 'Male', 'Young']}
    port = define_model('qrcan', device='cpu', **internal)
    sd = {k: v.detach().numpy().copy() for k, v in port.module.state_dict().items()}
    theirs = jax_define_model('qrcan', eval_mode=True, **internal)
    theirs.set_metadata_keys(list(reversed(celeba_attributes)) + ['blur_kernel'] * 10)
    theirs.init_state(spatial=(8, 8))
    theirs.state = theirs.state.replace(params=convert_torch_state_dict(
        'qrcan', sd, scale=4, n_resgroups=1, n_resblocks=2, style='max_concat',
        include_q_layer=True))
    model_loc, out_loc = str(tmp_path / 'Results'), str(tmp_path / 'out')
    for name, handler in (('jax_exp', theirs), ('torch_exp', port)):
        os.makedirs(os.path.join(model_loc, name, 'saved_models'))
        toml_io.dump({'model': {'name': 'qrcan', 'internal_params': internal}},
                     os.path.join(model_loc, name, 'config.toml'))
        handler.save_model('train_model', 0, os.path.join(model_loc, name, 'saved_models'))
    theirs.wait_pending_checkpoints()
    kwargs = dict(hr_dir=faces['hr'], lr_dir=faces['lr'], results_name='r', gpu=False,
                  metrics=['PSNR', 'SSIM'], data_split=None, save_im=False, batch_size=2,
                  full_directory=True, lr_dir_interp=None, model_only=False, scale=4,
                  model_loc=model_loc, out_loc=out_loc, use_test_group=False,
                  no_image_comparison=True, num_image_save=0, qpi_selection=(None, None),
                  data_attributes=faces['attributes'], dataset_name=None,
                  image_shortlist=None, metadata_file=None, sp_gpu=0, time_models=False,
                  recursive=False, fused_eval=True)
    hub = EvalHub(**{**kwargs, 'model_and_epoch': [('torch_exp', '0')],
                     'results_name': 'port'})
    handler = hub.model_bundles[0].model
    assert len(handler.metadata_keys) == 50 and len(handler.meta_indices) == 12
    hub.full_image_protocol()
    JaxEvalHub(**{**kwargs, 'model_and_epoch': [('jax_exp', '0')],
                  'results_name': 'ref'}).full_image_protocol()
    frames = [pd.read_csv(os.path.join(out_loc, name, 'standard_metrics',
                                       'individual_metrics.csv'), header=[0, 1], index_col=0)
              for name in ('port', 'ref')]
    assert len(frames[0]) == N_IMAGES
    for met, bar in BARS.items():
        np.testing.assert_allclose(frames[0][('torch_exp', met)],
                                   frames[1][('jax_exp', met)], atol=bar, rtol=0)
