"""sisr_tpu_torch's model-management tools against sisr_tpu's on the same folder layout
(two copies of one set of experiments): ``model_report``, ``model_compare``,
``extract_best_model(s)`` and ``clean_models`` (with ``keep_epochs``, ``keep_every``,
``clean_samples``, a resumed run's stale summary rows and a directory checkpoint)
keep, copy and report the same; ``images_to_video`` (where OpenCV is installed);
``compare_training_curves`` drawn with PIL; and every console script of the port
resolves to a callable."""
import ast
import importlib
import os

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from sisr_tpu.tools import helper_cli as jax_cli
from sisr_tpu_torch.tools import helper_cli, visualization

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _experiment(base, psnr, resumed_from=None, dir_epoch=None):
    """An experiment folder: summary.csv over len(psnr) epochs (with a resume from
    ``resumed_from``: the stale rows of the epochs trained again stay in the file),
    a checkpoint file per epoch (a directory for ``dir_epoch``), config, plots and
    epoch samples."""
    os.makedirs(os.path.join(base, 'saved_models'))
    os.makedirs(os.path.join(base, 'result_outputs', 'epoch_0_samples'))
    epochs = list(range(len(psnr)))
    rows = {'epoch': epochs, 'train-loss': [0.1] * len(psnr), 'val-PSNR': psnr}
    frame = pd.DataFrame(rows)
    if resumed_from is not None:
        stale = frame[frame['epoch'] >= resumed_from].assign(**{'val-PSNR': 99.0})
        frame = pd.concat([frame[frame['epoch'] < resumed_from], stale,
                           frame[frame['epoch'] >= resumed_from]])
    frame.to_csv(os.path.join(base, 'result_outputs', 'summary.csv'), index=False)
    for name in ('config.toml', 'extra_metadata.csv', 'result_outputs/loss_plots.pdf'):
        with open(os.path.join(base, name), 'w') as f:
            f.write(name)
    for epoch in epochs:
        path = os.path.join(base, 'saved_models', 'train_model_%d' % epoch)
        if epoch == dir_epoch:
            os.makedirs(path)
            with open(os.path.join(path, 'network.pt'), 'w') as f:
                f.write('n')
        else:
            with open(path, 'w') as f:
                f.write(str(epoch))
    with open(os.path.join(base, 'saved_models', 'train_model_tmp'), 'w') as f:
        f.write('stray')


@pytest.fixture
def layouts(tmp_path):
    """Two copies of the same experiments (and a tracker folder beside them)."""
    out = {}
    for package in ('port', 'ref'):
        home = str(tmp_path / package)
        _experiment(os.path.join(home, 'a'), [20.0, 21.0, 25.0, 22.0, 23.0, 22.5, 24.0,
                                              21.5, 20.5, 20.0, 19.0, 18.0])
        _experiment(os.path.join(home, 'b'), [10.0, 12.0, 11.0, 13.0, 12.5],
                    resumed_from=2, dir_epoch=3)
        os.makedirs(os.path.join(home, 'tracking', 'a'))
        out[package] = home
    return out


def _tree(home):
    return sorted(os.path.relpath(os.path.join(d, f), home)
                  for d, dirs, files in os.walk(home) for f in files + dirs)


@pytest.mark.parametrize('kwargs', [{}, {'keep_epochs': [7]}, {'keep_every': 4},
                                    {'keep_epochs': [0], 'clean_samples': True}])
def test_clean_models_keeps_what_sisr_tpu_keeps(layouts, kwargs, capsys):
    for exp in ('a', 'b'):
        helper_cli.clean_models(os.path.join(layouts['port'], exp), **kwargs)
        ours = capsys.readouterr().out
        jax_cli.clean_models(os.path.join(layouts['ref'], exp), **kwargs)
        assert ours == capsys.readouterr().out
    assert _tree(layouts['port']) == _tree(layouts['ref'])
    assert 'a/saved_models/train_model_2' in _tree(layouts['port'])  # the best epoch


def test_model_report_compare_and_extract_match_sisr_tpu(layouts, tmp_path, capsys):
    for exp in ('a', 'b'):
        assert helper_cli.model_report(os.path.join(layouts['port'], exp))[1:] == \
            jax_cli.model_report(os.path.join(layouts['ref'], exp))[1:]
    assert helper_cli.model_report(os.path.join(layouts['port'], 'b'))[1:] == (3, 4)
    for home in layouts.values():
        os.remove(os.path.join(home, 'b', 'saved_models', 'train_model_4'))
    helper_cli.model_compare.main(args=['--main_dir', layouts['port'], '--compare_dir',
                                        layouts['ref']], standalone_mode=False)
    ours = capsys.readouterr().out
    jax_cli.model_compare.main(args=['--main_dir', layouts['ref'], '--compare_dir',
                                     layouts['port']], standalone_mode=False)
    assert ours == capsys.readouterr().out and 'checkpoint available: No' in ours
    outs = {p: str(tmp_path / ('extracted_' + p)) for p in ('port', 'ref')}
    helper_cli.extract_best_models.main(args=['--home_dir', layouts['port'], '--out_dir',
                                              outs['port'], '--all_models', '--clean'],
                                        standalone_mode=False)
    jax_cli.extract_best_models.main(args=['--home_dir', layouts['ref'], '--out_dir',
                                           outs['ref'], '--all_models', '--clean'],
                                     standalone_mode=False)
    assert _tree(outs['port']) == _tree(outs['ref'])
    assert 'b/saved_models/train_model_3/network.pt' in _tree(outs['port'])
    assert _tree(layouts['port']) == _tree(layouts['ref'])


def test_click_clean_keep_every(layouts):
    helper_cli.click_clean.main(args=['--base_dir', layouts['port'], '-m', 'a',
                                      '--keep_every', '5'], standalone_mode=False)
    jax_cli.click_clean.main(args=['--base_dir', layouts['ref'], '-m', 'a',
                                   '--keep_every', '5'], standalone_mode=False)
    assert _tree(layouts['port']) == _tree(layouts['ref'])
    assert 'a/saved_models/train_model_10' in _tree(layouts['port'])


def test_images_to_video(tmp_path):
    cv2 = pytest.importorskip('cv2')
    folder = tmp_path / 'frames'
    folder.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (32, 48, 3)).astype(np.uint8)).save(
            folder / ('f_%d.png' % i))
    helper_cli.click_image_sequence_to_movie.main(args=[
        '--image_folder', str(folder), '--video_name', 'clip.mp4', '--fps', '4'],
        standalone_mode=False)
    capture = cv2.VideoCapture(str(folder / 'clip.mp4'))
    assert int(capture.get(cv2.CAP_PROP_FRAME_COUNT)) == 3


@pytest.mark.parametrize('smooth', [False, True])
def test_compare_training_curves_draws_with_pil(layouts, tmp_path, smooth):
    out = str(tmp_path / 'curves.png')
    visualization.compare_training_curves(
        layouts['port'], out, ['a', os.path.join(layouts['port'], 'b')], smooth=smooth,
        epoch_range=(0, 11), psnr_range=(10, 30))
    page = np.asarray(Image.open(out).convert('RGB'))
    assert page.shape == (420, 1000, 3) and len(np.unique(page.reshape(-1, 3), axis=0)) > 2


def test_console_scripts_resolve():
    """Every ``*_torch`` console script of setup.py names a callable of the port."""
    tree = ast.parse(open(os.path.join(ROOT, 'setup.py')).read())
    entries = [node.value for node in ast.walk(tree) if isinstance(node, ast.Constant)
               and isinstance(node.value, str) and '_torch=' in node.value]
    names = {entry.split('=')[0] for entry in entries}
    assert names == {'train_sisr_torch', 'eval_sisr_torch', 'image_manipulate_torch',
                     'images_to_video_torch', 'extract_best_model_torch',
                     'clean_models_torch', 'model_report_torch',
                     'import_reference_model_torch', 'export_serving_torch',
                     'run_serving_torch'}
    for entry in entries:
        module, attr = entry.split('=')[1].split(':')
        assert module.startswith('sisr_tpu_torch.')
        assert callable(getattr(importlib.import_module(module), attr)), entry
