"""sisr_tpu_torch's run_serving against sisr_tpu's on the CPU: the same weights exported
by both packages (sisr_tpu's StableHLO artifact, the port's ``.pt2``) and served over
the same LR folder (one image of another size, centre-cropped and edge-padded to the
static shape) with ``--gt_dir``: the programs' outputs within 5e-4, the SR PNGs within
one uint8 LSB, the metrics within 0.01 dB / 1e-3, for RCAN, Q-RCAN with its metadata
and EDSR on uint8 input; a metadata
CSV whose columns differ from the manifest's is refused, as in sisr_tpu."""
import os

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.tools import export_serving as jax_export, run_serving as jax_run
from sisr_tpu.tools.convert_weights import convert_torch_state_dict
from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.tools import export_serving, run_serving
from sisr_tpu_torch.utils import toml_io

# case -> (model, structure, sisr_tpu converter kwargs, uint8 input)
CASES = {
    'rcan': ('rcan', {'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 4},
             {'n_resgroups': 1, 'n_resblocks': 2}, False),
    'qrcan': ('qrcan', {'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16, 'reduction': 4,
                        'style': 'max_concat', 'include_q_layer': True,
                        'metadata': ['blur_kernel']},
              {'n_resgroups': 1, 'n_resblocks': 2, 'style': 'max_concat',
               'include_q_layer': True}, False),
    'edsr': ('edsr', {'num_features': 16, 'num_blocks': 2}, {'num_blocks': 2}, True),
}


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """3 LR images of 12^2 (one 10 x 14) and their HR with the blur-kernel metadata, and
    for each case the same weights as an experiment of each package,
    each exported at batch 2 x 12^2."""
    root = str(tmp_path_factory.mktemp('serving'))
    lr_dir, hr_dir = build_workload(os.path.join(root, 'data'), 3, lr_size=12, scale=2,
                                    metadata_cols=10)
    odd = sorted(f for f in os.listdir(lr_dir) if f.endswith('.png'))[-1]
    rng = np.random.RandomState(1)
    Image.fromarray(rng.randint(0, 256, (10, 14, 3)).astype(np.uint8)).save(
        os.path.join(lr_dir, odd))
    Image.fromarray(rng.randint(0, 256, (20, 28, 3)).astype(np.uint8)).save(
        os.path.join(hr_dir, odd))
    artifacts = {}
    for case, (model, internal, convert, uint8) in CASES.items():
        internal = {'scale': 2, **internal}
        port = define_model(model, device='cpu', seed=4, **internal)
        theirs = jax_define_model(model, eval_mode=True, **internal)
        if port.uses_metadata:
            theirs.set_metadata_keys(['blur_kernel'] * 10)
        theirs.init_state(spatial=(12, 12))
        sd = {k: v.numpy() for k, v in port.module.state_dict().items()}
        theirs.state = theirs.state.replace(params=convert_torch_state_dict(
            model, sd, scale=2, **convert))
        for package, handler in (('torch', port), ('jax', theirs)):
            base = os.path.join(root, 'Results', '%s_%s' % (package, case))
            os.makedirs(os.path.join(base, 'saved_models'))
            toml_io.dump({'model': {'name': model, 'internal_params': internal}},
                         os.path.join(base, 'config.toml'))
            handler.save_model('train_model', 0, os.path.join(base, 'saved_models'))
        theirs.wait_pending_checkpoints()
        models = os.path.join(root, 'Results')
        meta = ['blur_kernel'] if port.uses_metadata else None
        artifacts[case] = (
            export_serving.export_experiment(
                models, 'torch_' + case, 0, 2, 12, 12, uint8_input=uint8, device='cpu',
                metadata_keys=meta, out_path=os.path.join(root, case + '.pt2')),
            jax_export.export_experiment(
                models, 'jax_' + case, 0, 2, 12, 12, uint8_input=uint8, metadata_keys=meta,
                out_path=os.path.join(root, case + '.sisr-hlo')))
    return root, lr_dir, hr_dir, artifacts


@pytest.mark.parametrize('case', sorted(CASES))
def test_run_serving_matches_sisr_tpu(served, case):
    root, lr_dir, hr_dir, artifacts = served
    ours_path, theirs_path = artifacts[case]
    rng = np.random.RandomState(2)
    x = rng.rand(2, 12, 12, 3).astype(np.float32)
    if CASES[case][3]:
        x = np.rint(x * 255).astype(np.uint8)
    args = [x] + ([rng.rand(2, 10).astype(np.float32)] if case == 'qrcan' else [])
    with torch.inference_mode():
        ours = export_serving.load_serving(ours_path)(*map(torch.from_numpy, args)).numpy()
    theirs = np.asarray(jax_export.load_serving(theirs_path)(*map(jnp.asarray, args)))
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=0)
    outs = {}
    for package, module, path in (('port', run_serving, ours_path),
                                  ('ref', jax_run, theirs_path)):
        kwargs = {'device': 'cpu'} if package == 'port' else {}
        outs[package] = module.serve_directory(
            path, lr_dir, out_dir=os.path.join(root, '%s_%s_sr' % (package, case)),
            gt_dir=hr_dir, metrics=['PSNR', 'SSIM'], **kwargs)
    assert sorted(outs['port']) == sorted(outs['ref'])
    for name, row in outs['port'].items():
        for met, bar in (('PSNR', 0.01), ('SSIM', 1e-3)):
            assert abs(row[met] - outs['ref'][name][met]) <= bar, (name, met)
        if name != '[mean]':
            a = np.asarray(Image.open(row['file']), np.int16)
            b = np.asarray(Image.open(outs['ref'][name]['file']), np.int16)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1
    csvs = [pd.read_csv(os.path.join(root, '%s_%s_sr' % (p, case), 'serving_metrics.csv'),
                        index_col=0) for p in ('port', 'ref')]
    assert list(csvs[0].index) == list(csvs[1].index)
    assert list(csvs[0].columns) == list(csvs[1].columns) == ['PSNR', 'SSIM']


def test_metadata_columns_must_match_the_manifest(served, tmp_path):
    """A CSV without the blur kernel's columns is refused by both runners; a program
    exported for the CPU does not run on the card, nor the reverse."""
    root, lr_dir, _, artifacts = served
    bad = tmp_path / 'bad.csv'
    table = pd.read_csv(os.path.join(lr_dir, 'degradation_metadata.csv'), index_col=0)
    table.assign(qpi=[20, 30, 40])[['qpi']].to_csv(bad)
    with pytest.raises(RuntimeError, match='do not match the artifact'):
        run_serving.serve_directory(artifacts['qrcan'][0], lr_dir, metadata_csv=str(bad),
                                    save_images=False, device='cpu')
    with pytest.raises(RuntimeError):
        jax_run.serve_directory(artifacts['qrcan'][1], lr_dir, metadata_csv=str(bad),
                                save_images=False)
    manifest = run_serving.load_manifest(artifacts['rcan'][0])
    assert manifest['platforms'] == ['cpu']
    if torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='exported for cpu'):
            run_serving.serve_directory(artifacts['rcan'][0], lr_dir, save_images=False,
                                        device='cuda')
