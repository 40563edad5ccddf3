"""sisr_tpu_torch's online degradation against sisr_tpu's on the CPU: kernel draws from
one numpy seed, the PCA, the host blur and the batched device blur, the noise, the
degrader, ``degrade_batch_on_device`` against sisr_tpu's and against the host chain,
the dataset's items in host mode (with noise) and device mode, its two refusals, the
segmentation masks, and the train step that makes its LR on the device.

Bars: kernels, noise, codes and the host blur equal (the same numpy code); the PCA's
components equal up to sign to 1e-6; the batched blur <= 1e-6 of sisr_tpu's (f32
sums of 441 products); ``degrade_batch_on_device`` <= 1e-5 of sisr_tpu's (two f32
matrix products after the blur; a blurred value on a uint8 boundary may truncate
one step apart, so the bar holds on all but such pixels, counted) and within one
uint8 step of the host chain (PIL's fixed-point rounding); dataset items equal
(LR, HR, kernels), metadata <= 1e-7; the device-degraded train step's loss
rtol 1e-5 of sisr_tpu's."""
import os
import random

import numpy as np
import PIL.Image
import pytest
import torch

import jax.numpy as jnp

from sisr_tpu.data import datasets as jax_datasets
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.ops import degradations as jd
from sisr_tpu.ops import transforms as jt
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch.data import datasets as torch_datasets
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import degradations as td
from sisr_tpu_torch.ops import transforms as tt
from sisr_tpu_torch.training.handler import TrainingHandler

RCAN = {'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 4}


def _seeded(fn, seed=7):
    np.random.seed(seed)
    return fn()


@pytest.mark.parametrize('draw', [
    lambda m: m.random_batch_kernel(6),
    lambda m: m.random_batch_kernel(6, l=15, rate_iso=0.4, scaling=2),
    lambda m: m.stable_batch_kernel(2, l=9, sig=1.7),
    lambda m: m.random_batch_noise(8, 0.08, rate_cln=0.3),
    lambda m: m.gaussian_noising(np.full((5, 4, 3), 0.5, np.float32), np.array([0.05])),
])
def test_draws_match_from_one_seed(draw):
    np.testing.assert_array_equal(_seeded(lambda: draw(td)), _seeded(lambda: draw(jd)))


def test_pca_matrix_and_codes_match():
    kernels = _seeded(lambda: jd.random_batch_kernel(600, rate_iso=0.5))
    theirs = jd.pca_matrix(kernels.reshape(600, -1), k=10)
    ours = td.pca_matrix(kernels.reshape(600, -1), k=10)
    assert ours.dtype == np.float32 and ours.shape == (441, 10)
    signs = np.sign(np.sum(ours * theirs, axis=0))
    assert set(signs.tolist()) <= {-1.0, 1.0}
    np.testing.assert_allclose(ours * signs, theirs, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(td.PCAEncoder(theirs)(kernels[:4]),
                                  jd.PCAEncoder(theirs)(kernels[:4]))


@pytest.mark.parametrize('l,size', [(21, (20, 24)), (6, (20, 24)), (21, (8, 5))])
def test_blur_host_and_batched_match(l, size):
    """The host blur and the batched grouped conv (an even kernel's asymmetric pad,
    and a kernel wider than the image, reflected again) against sisr_tpu's."""
    images = np.random.RandomState(0).rand(3, *size, 3).astype(np.float32)
    kernels = _seeded(lambda: jd.random_batch_kernel(3, l=l, rate_iso=0.5))
    np.testing.assert_array_equal(td.blur_image(images[0], kernels[0]),
                                  jd.blur_image(images[0], kernels[0]))
    ours = td.batch_blur_nhwc(torch.from_numpy(images), torch.from_numpy(kernels))
    theirs = jd.batch_blur_nhwc(jnp.asarray(images), jnp.asarray(kernels, jnp.float32))
    assert ours.dtype == torch.float32 and ours.shape == images.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6, rtol=0)
    # the batched blur of image 0 is the host blur of it
    np.testing.assert_allclose(ours[0].numpy(), jd.blur_image(images[0], kernels[0]),
                               atol=1e-6, rtol=0)


def test_degrade_batch_on_device_matches_sisr_tpu_and_the_host_chain():
    rng = np.random.RandomState(3)
    hr_u8 = rng.randint(0, 256, (4, 32, 40, 3)).astype(np.uint8)
    hr = hr_u8.astype(np.float32) / 255.0
    kernels = _seeded(lambda: jd.random_batch_kernel(4)).astype(np.float32)
    pca = jd.pca_matrix(_seeded(lambda: jd.random_batch_kernel(500)).reshape(500, -1), 10)
    lr, codes, blurred = td.degrade_batch_on_device(torch.from_numpy(hr),
                                                    torch.from_numpy(kernels), pca, 2)
    j_lr, j_codes, j_blurred = jd.degrade_batch_on_device(jnp.asarray(hr),
                                                          jnp.asarray(kernels), pca, 2)
    assert lr.shape == (4, 16, 20, 3) and lr.dtype == torch.float32
    np.testing.assert_allclose(blurred.numpy(), np.asarray(j_blurred), atol=1e-6, rtol=0)
    np.testing.assert_allclose(codes.numpy(), np.asarray(j_codes), atol=1e-6, rtol=0)
    delta = np.abs(lr.numpy() - np.asarray(j_lr))
    # a blurred value within 1e-6 of a uint8 boundary truncates one step apart in the
    # two packages; such pixels move the LR by at most a 1/255 step's share
    on_edge = np.abs(np.asarray(j_blurred) * 255 - np.round(np.asarray(j_blurred) * 255))
    assert np.mean(delta > 1e-5) <= np.mean(on_edge < 1e-4) + 1e-3
    assert delta.max() <= 1.0 / 255
    for i in range(4):  # the host chain: blur, ToPILImage, PIL bicubic down
        host = jd.blur_image(hr[i], kernels[i])
        _, lr_pil = jt.downsample(jt.float_to_pil(host), 2)
        ours = np.rint(lr[i].numpy() * 255).astype(np.int32)
        assert np.abs(ours - np.asarray(lr_pil, np.int32)).max() <= 1


def test_host_transforms_match():
    img = PIL.Image.fromarray(np.random.RandomState(1).randint(0, 256, (37, 29, 3))
                              .astype(np.uint8))
    for a, b in zip(tt.downsample(img, 4), jt.downsample(img, 4)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    arr = tt.pil_to_float(img)
    np.testing.assert_array_equal(arr, jt.pil_to_float(img))
    np.testing.assert_array_equal(np.asarray(tt.float_to_pil(arr * 0.7)),
                                  np.asarray(jt.float_to_pil(arr * 0.7)))


def test_online_degrader_matches():
    pca = jd.pca_matrix(_seeded(lambda: jd.random_batch_kernel(300)).reshape(300, -1), 10)
    hr = np.random.RandomState(2).rand(24, 20, 3).astype(np.float32)
    kwargs = dict(random=True, noise=True, rate_cln=0.0, noise_high=0.08)
    ours = _seeded(lambda: td.OnlineDegrader(pca, **kwargs)(hr))
    theirs = _seeded(lambda: jd.OnlineDegrader(pca, **kwargs)(hr))
    assert ours[1].shape == (11,)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


# --- the dataset ----------------------------------------------------------------------------
@pytest.fixture(scope='module')
def workload(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('online'))
    lr_dir, hr_dir = build_workload(root, 4, lr_size=10, scale=2, metadata_cols=10)
    masks = os.path.join(hr_dir, 'segmentation_patterns')
    os.makedirs(masks)
    rng = np.random.RandomState(5)
    for name in sorted(os.listdir(hr_dir)):
        if name.endswith('.png'):
            PIL.Image.fromarray(rng.randint(0, 3, (22, 21, 3)).astype(np.uint8)).save(
                os.path.join(masks, name))
    return lr_dir, hr_dir, masks


@pytest.fixture
def shared_pca(monkeypatch):
    """One SVD for both packages' dataset constructions: each dataset draws its own
    30000 kernels from the global stream; when the two draws are equal (seeded alike)
    the second construction reuses the first's components.  The PCA itself is held
    against sisr_tpu's in test_pca_matrix_and_codes_match."""
    memo, compute = {}, jd.pca_matrix

    def pca(data, k=2):
        key = (hash(np.asarray(data).tobytes()), k)
        if key not in memo:
            memo[key] = compute(data, k)
        return memo[key]

    monkeypatch.setattr(td, 'pca_matrix', pca)
    monkeypatch.setattr(jd, 'pca_matrix', pca)
    return memo


def _pair(lr_dir, hr_dir, **kwargs):
    np.random.seed(11)
    ours = torch_datasets.SuperResImages(lr_dir, hr_dir, scale=2, split='all', **kwargs)
    np.random.seed(11)
    theirs = jax_datasets.SuperResImages(lr_dir, hr_dir, scale=2, split='all',
                                         colorspace='rgb', input='unmodified', **kwargs)
    return ours, theirs


def _items(ours, theirs, index, seed):
    """Item ``index`` of both datasets, each drawn after seeding numpy (kernels,
    noise) and ``random`` (crops, flips) alike."""
    items = []
    for dataset in (ours, theirs):
        np.random.seed(seed)
        random.seed(seed)
        items.append(dataset[index])
    return items


def test_dataset_host_mode_with_noise(workload, shared_pca):
    lr_dir, hr_dir, masks = workload
    params = {'noise': True, 'rate_cln': 0.0, 'noise_high': 0.08, 'rate_iso': 0.5}
    ours, theirs = _pair(None, hr_dir, online_degradations=True, mask_data=masks,
                         online_degradation_params=params,
                         degradation_metadata_file=os.path.join(lr_dir,
                                                                'degradation_metadata.csv'),
                         metadata='all')
    assert len(shared_pca) == 1  # the same 30000 kernels in both
    assert ours.metadata_keys == theirs.metadata_keys == ['blur_kernel'] * 20 + ['noise']
    ours.keep_uint8 = theirs.keep_uint8 = True  # host mode serves floats whatever it says
    for index in range(2):
        a, b = _items(ours, theirs, index, seed=20 + index)
        assert a['lr'].dtype == a['hr'].dtype == np.float32
        assert a['lr'].shape == (10, 10, 3) and a['hr'].shape == (20, 20, 3)
        for key in ('lr', 'hr', 'blur_kernels', 'mask'):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a['metadata'].shape == (21,) and a['metadata'][-1] > 0  # noise x 10
        np.testing.assert_allclose(a['metadata'], b['metadata'], atol=1e-7, rtol=0)
        assert a['tag'] == b['tag'] and a['hr_tag'] == b['hr_tag']


def test_dataset_device_mode(workload, shared_pca):
    _, hr_dir, _ = workload
    ours, theirs = _pair(None, hr_dir, online_degradations=True, random_crop=4,
                         random_augments=True,
                         online_degradation_params={'device': True})
    assert ours.device_degradations and theirs.device_degradations
    assert ours.metadata_keys == theirs.metadata_keys == ['blur_kernel'] * 10
    ours.keep_uint8 = theirs.keep_uint8 = True
    a, b = _items(ours, theirs, 3, seed=5)
    assert a['hr'].dtype == np.uint8 and a['hr'].shape == (8, 8, 3)
    assert a['lr'].dtype == np.float32 and not a['lr'].any()  # the placeholder
    assert a['blur_kernels'].shape == (21, 21)
    for key in ('lr', 'hr', 'blur_kernels', 'metadata'):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_dataset_refusals(workload):
    """sisr_tpu's two: device mode on an eval set (before the PCA), device mode with
    noise; and no HR folder."""
    _, hr_dir, _ = workload
    with pytest.raises(RuntimeError, match='placeholder LR'):
        torch_datasets.SuperResImages(None, hr_dir, split='all', usage='eval',
                                      online_degradations=True,
                                      online_degradation_params={'device': True})
    with pytest.raises(RuntimeError, match='without HR'):
        torch_datasets.SuperResImages(None, None, split='all', online_degradations=True)
    torch_datasets.PCA_KERNELS, saved = 50, torch_datasets.PCA_KERNELS
    try:
        with pytest.raises(ValueError, match='noise'):
            torch_datasets.SuperResImages(None, hr_dir, split='all',
                                          online_degradations=True,
                                          online_degradation_params={'device': True,
                                                                     'noise': True})
    finally:
        torch_datasets.PCA_KERNELS = saved


# --- the train step -------------------------------------------------------------------------
def _hr_batch(seed=9):
    rng = np.random.RandomState(seed)
    hr = rng.randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    kernels = _seeded(lambda: jd.random_batch_kernel(2), seed).astype(np.float32)
    return {'lr': np.zeros((2, 8, 8, 3), np.float32), 'hr': hr, 'blur_kernels': kernels}


def test_device_degrade_step_feeds_the_module_the_degraded_hr():
    """The module's input is the degraded HR, not the zero placeholder, and the step's
    loss is sisr_tpu's on the same weights and batch."""
    port = define_model('rcan', device='cpu', scale=2, lr=1e-3, seed=3, **RCAN)
    port.set_device_degrade(True)
    assert port._train_batch_keys() == ('hr', 'blur_kernels')
    seen = []
    hook = port.module.register_forward_pre_hook(
        lambda module, args: seen.append(args[0].detach().permute(0, 2, 3, 1).clone()))
    batch = _hr_batch()
    loss = float(port.run_train(**batch)[0])
    hook.remove()
    expected = td.degrade_batch_on_device(torch.from_numpy(batch['hr']).float() / 255.0,
                                          torch.from_numpy(batch['blur_kernels']),
                                          None, 2)[0]
    assert seen[0].abs().max() > 0.1
    torch.testing.assert_close(seen[0], expected, atol=0, rtol=0)

    sd = {k: v.detach().numpy().copy() for k, v in define_model(
        'rcan', device='cpu', scale=2, seed=3, **RCAN).module.state_dict().items()}
    theirs = jax_define_model('rcan', eval_mode=False, scale=2, lr=1e-3, **RCAN)
    theirs.init_state(spatial=(8, 8), batch=2)
    theirs.state = theirs.state.replace(params=convert_torch_state_dict(
        'rcan', sd, scale=2, n_resgroups=1, n_resblocks=2))
    theirs.set_device_degrade(True)
    j_loss = float(theirs.run_train(**batch)[0])
    assert loss == pytest.approx(j_loss, rel=1e-5)


def test_training_handler_turns_device_mode_on(tmp_path, workload):
    """A device-mode training set makes TrainingHandler switch the handler's device
    degradation on, and the epoch's steps see degraded HR crops."""
    lr_dir, hr_dir, _ = workload
    torch_datasets.PCA_KERNELS, saved = 200, torch_datasets.PCA_KERNELS
    try:
        handler = TrainingHandler(
            experiment_name='dev', save_loc=str(tmp_path), gpu='off', num_epochs=1,
            model_params={'name': 'rcan', 'internal_params': {'scale': 2, **RCAN}},
            data_params={'batch_size': 2, 'dataloader_threads': 1,
                         'training_sets': {'d': {'hr': hr_dir, 'crop': 4,
                                                 'online_degradations': True,
                                                 'online_degradation_params': {
                                                     'device': True, 'noise': False}}},
                         'eval_sets': {'d': {'lr': lr_dir, 'hr': hr_dir}}},
            save_samples=False, logging='none')
    finally:
        torch_datasets.PCA_KERNELS = saved
    assert handler.handler.device_degrade
    seen = []
    handler.handler.module.register_forward_pre_hook(
        lambda module, args: seen.append(float(args[0].abs().max())))
    losses = handler.train()['train-loss']
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert len(seen) == 2 and min(seen) > 0.05
