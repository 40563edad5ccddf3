"""The fused protocol's device-batch cache of sisr_tpu_torch's EvalHub (sisr_tpu's
``_device_batch_cache``), its loader's decode counter (``ITEMS_LOADED``) and the
device collate, on the CPU (the "device" is the CPU here; the card runs the same code
through ``chip_smoke.py``'s warm passes).

Each case holds: the cache filled only after a complete pass and then reused, not
rebuilt; later passes decode nothing (``ITEMS_LOADED`` unchanged) and write the first
pass's CSVs; ``cache_device=False`` never fills it; a set over the cap is not cached; a
pass that raises commits nothing; the grouped download gives each batch its own
metrics; the standard protocol bypasses the cache; uniform uint8 images stay lists in
the collate and are stacked by ``device_prefetch``, ragged ones pass as they are."""
import os

import numpy as np
import pandas as pd
import pytest
import torch

from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch.data import loader
from sisr_tpu_torch.evaluation.standard_eval import EvalHub
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.utils import toml_io

MODELS = {'exp': ('edsr', {'scale': 4, 'num_features': 8, 'num_blocks': 1}),
          'qexp': ('qedsr', {'scale': 4, 'num_features': 8, 'num_blocks': 1,
                             'metadata': ['blur_kernel']})}


@pytest.fixture(scope='module')
def workload(tmp_path_factory):
    """5 LR/HR pairs (batches of 2, 2 and 1) with a blur-kernel CSV, and an EDSR and a
    Q-EDSR experiment."""
    root = tmp_path_factory.mktemp('cache')
    lr_dir, hr_dir = build_workload(str(root / 'data'), 5, lr_size=12, metadata_cols=10)
    model_loc = str(root / 'Results')
    for seed, (exp, (name, internal)) in enumerate(MODELS.items()):
        base = os.path.join(model_loc, exp, 'saved_models')
        os.makedirs(base)
        toml_io.dump({'model': {'name': name, 'internal_params': internal}},
                     os.path.join(model_loc, exp, 'config.toml'))
        define_model(name, device='cpu', seed=seed, **internal).save_model(
            'train_model', 0, base)
    return lr_dir, hr_dir, model_loc


def hub(workload, out_loc, experiments=('exp', 'qexp'), **kwargs):
    lr_dir, hr_dir, model_loc = workload
    return EvalHub(hr_dir=hr_dir, lr_dir=lr_dir,
                   model_and_epoch=[(exp, '0') for exp in experiments], results_name='r',
                   gpu=False, metrics=['PSNR', 'SSIM'], data_split=None, save_im=False,
                   batch_size=2, full_directory=True, lr_dir_interp=None, model_only=False,
                   scale=4, model_loc=model_loc, out_loc=str(out_loc), use_test_group=False,
                   no_image_comparison=True, num_image_save=0, qpi_selection=(None, None),
                   data_attributes=None, dataset_name=None, image_shortlist=None,
                   metadata_file=None, sp_gpu=0, time_models=False, recursive=False,
                   fused_eval=True, **kwargs)


def csv(out_loc):
    return pd.read_csv(os.path.join(str(out_loc), 'r', 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


def decoded_during(fn):
    before = loader.ITEMS_LOADED
    fn()
    return loader.ITEMS_LOADED - before


def test_cache_is_filled_by_a_complete_pass_and_reused(workload, tmp_path, monkeypatch):
    """The first pass decodes the 5 images and leaves its 3 device batches (tag,
    metadata and both images) in the cache; the next passes decode nothing, iterate
    that same cache with no device_prefetch, and write the same CSV; timed, a cached
    pass takes the fetcher thread and gives the same metrics too."""
    h = hub(workload, tmp_path, cache_decoded=False)
    assert h.cache_device is False and h._device_batch_cache is None
    h = hub(workload, tmp_path)
    assert h.cache_device is True and h._device_batch_cache is None
    assert decoded_during(h.full_image_protocol) == 5
    first = csv(tmp_path)
    cache = h._device_batch_cache
    assert [len(b['tag']) for b in cache] == [2, 2, 1]
    assert all(isinstance(b[k], torch.Tensor) for b in cache for k in ('lr', 'hr', 'metadata'))
    assert cache[0]['lr'].dtype == torch.uint8 and cache[0]['lr'].shape == (2, 12, 12, 3)
    from sisr_tpu_torch.evaluation import standard_eval
    monkeypatch.setattr(standard_eval, 'device_prefetch', None)  # not called again
    for timed in (False, True):
        h.time_models = timed
        assert decoded_during(h.full_image_protocol) == 0
        again = csv(tmp_path)
        assert h._device_batch_cache is cache
        cols = [c for c in first.columns if c[1] != 'runtime']
        pd.testing.assert_frame_equal(again[cols], first[cols])
        assert ('exp', 'runtime') in again.columns if timed else True


def test_standard_protocol_bypasses_the_cache(workload, tmp_path):
    h = hub(workload, tmp_path, experiments=('exp',))
    h.full_image_protocol()
    fused = csv(tmp_path)
    cache = h._device_batch_cache
    h.fused_eval = False
    assert decoded_during(h.full_image_protocol) == 5
    std = csv(tmp_path)
    assert h._device_batch_cache is cache and not h.rgb_data.device_collate
    np.testing.assert_allclose(std[('exp', 'PSNR')], fused[('exp', 'PSNR')], atol=2e-2)


def test_cache_device_off_never_fills_it(workload, tmp_path):
    h = hub(workload, tmp_path, cache_device=False)
    assert not h.cache_device and h.rgb_data.dataset._decode_cache is not None
    h.full_image_protocol()
    first = csv(tmp_path)
    assert h._device_batch_cache is None
    h.full_image_protocol()
    assert h._device_batch_cache is None
    pd.testing.assert_frame_equal(csv(tmp_path), first)


def test_a_set_over_the_cap_is_not_cached(workload, tmp_path):
    """3 batches hold 5 * (12^2 + 48^2) * 3 bytes of images and 5 * 10 * 4 of
    metadata: under that cap nothing is cached and every pass decodes again."""
    h = hub(workload, tmp_path)
    size = 5 * (12 * 12 + 48 * 48) * 3 + 5 * 10 * 4
    h._device_batch_cache_cap = size - 1
    h.full_image_protocol()
    assert h._device_batch_cache is None
    assert decoded_during(h.full_image_protocol) == 5
    h._device_batch_cache_cap = size
    h.full_image_protocol()
    assert len(h._device_batch_cache) == 3


def test_a_pass_that_raises_commits_nothing(workload, tmp_path):
    h = hub(workload, tmp_path, experiments=('exp',))
    handler = h.model_bundles[0].model
    fused = handler.run_eval_fused
    calls = []

    def fail_on_second(batch, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError('second batch')
        return fused(batch, **kwargs)
    handler.run_eval_fused = fail_on_second
    with pytest.raises(RuntimeError, match='second batch'):
        h.full_image_protocol()
    assert h._device_batch_cache is None
    handler.run_eval_fused = fused
    h.full_image_protocol()
    assert len(h._device_batch_cache) == 3


def test_grouped_download_slices_each_batch():
    """One concatenation and one host copy per (model, keys) group; each entry gets
    its own columns back, in order."""
    rng = np.random.RandomState(0)
    keys_a, keys_b = ('LR>PSNR', 'model>PSNR'), ('model>PSNR',)
    mats = [torch.from_numpy(rng.rand(len(k), n).astype(np.float32))
            for k, n in ((keys_a, 2), (keys_b, 2), (keys_a, 3), (keys_b, 3), (keys_a, 1))]
    names = ['a', 'b', 'a', 'b', 'a']
    pending = [(name, name == 'a', keys_a if name == 'a' else keys_b, m, None, m.shape[1])
               for name, m in zip(names, mats)]
    EvalHub._realize_pending_grouped(pending)
    for entry, mat in zip(pending, mats):
        assert isinstance(entry[3], np.ndarray)
        np.testing.assert_array_equal(entry[3], mat.numpy())
        assert entry[5] == mat.shape[1]


def test_device_collate_stacks_uniform_images_and_passes_ragged_ones():
    rng = np.random.RandomState(1)
    items = [{'lr': rng.randint(0, 256, (4, 5, 3)).astype(np.uint8), 'tag': 'a%d' % i,
              'metadata': rng.rand(10).astype(np.float32)} for i in range(3)]
    batch = loader._collate(items, device_images=True)
    assert isinstance(batch['lr'], list) and batch['metadata'].shape == (3, 10)
    plain = loader._collate(items)
    assert isinstance(plain['lr'], np.ndarray)
    ragged = dict(batch, hr=[np.zeros((4, 5, 3), np.uint8), np.zeros((5, 4, 3), np.uint8)])
    (out,) = list(loader.device_prefetch(iter([ragged]), 'cpu'))
    assert isinstance(out['lr'], torch.Tensor) and out['lr'].shape == (3, 4, 5, 3)
    np.testing.assert_array_equal(out['lr'].numpy(), plain['lr'])
    assert isinstance(out['hr'], list) and isinstance(out['hr'][0], np.ndarray)
    assert torch.equal(out['metadata'], torch.from_numpy(plain['metadata']))


def test_items_loaded_counts_threaded_loads():
    """ITEMS_LOADED counts every item of every batch, with 1 worker and with 8."""
    class Items:
        def __len__(self):
            return 37

        def __getitem__(self, i):
            return {'x': np.full(2, i, np.float32)}

    for workers in (1, 8):
        data = loader.DataLoader(Items(), batch_size=4, num_workers=workers)
        assert decoded_during(lambda: list(data)) == 37
