"""Model-management and media helper CLIs (PyTorch port of sisr_tpu's
``tools/helper_cli.py``, ref: Code/sr_tools/helper_functions.py:180-370 and setup.py
console scripts ``images_to_video``, ``extract_best_model``, ``clean_models``,
``model_report``).  Host-only: they read summary.csv files and copy or delete
checkpoint files and directories; ``images_to_video`` imports OpenCV when called.
"""
import glob
import os
import shutil
import sys

import click
import pandas as pd
from tqdm import tqdm

from ..utils.helpers import create_dir_if_empty, extract_image_names_from_folder, \
    natural_keys


def _best_last_epochs(summary):
    """Resolve best/last through the 'epoch' COLUMN: resumed runs append stale
    duplicate-epoch rows where row position != epoch number (same rule as
    ModelInterface; resolving by row position made clean_models delete the true
    best checkpoint after a resume)."""
    if 'epoch' in summary.columns:
        fresh = summary.drop_duplicates(subset='epoch', keep='last')
        best = int(fresh.loc[fresh['val-PSNR'].idxmax(), 'epoch'])
        last = int(fresh['epoch'].max())
        return best, last
    return int(summary['val-PSNR'].idxmax()), len(summary) - 1


def model_report(model_dir):
    """(ref: helper_functions.py:180-190)"""
    summary = pd.read_csv(os.path.join(model_dir, 'result_outputs/summary.csv'))
    best_model_idx, final_model_idx = _best_last_epochs(summary)
    save_dir = os.path.join(model_dir, 'saved_models')
    model_files = os.listdir(save_dir) if os.path.exists(save_dir) else []
    return model_files, best_model_idx, final_model_idx


def check_models(models, best_idx, last_idx):
    """(ref: helper_functions.py:193-204)"""
    best = 'Yes' if 'train_model_%d' % best_idx in models else 'No'
    last = 'Yes' if 'train_model_%d' % last_idx in models else 'No'
    return best, last


@click.command()
@click.option('--main_dir', help='Main model compare directory', show_default=True)
@click.option('--compare_dir', default=None,
              help='Secondary directory to compare models with.', show_default=True)
def model_compare(main_dir, compare_dir):
    """Summarises all models in provided directory (ref: helper_functions.py:214-254)."""
    for model in os.listdir(main_dir):
        model_path = os.path.join(main_dir, model)
        if not os.path.isdir(model_path) or not os.path.isfile(
                os.path.join(model_path, 'result_outputs', 'summary.csv')):
            continue  # tracker home / non-experiment dirs live alongside models
        model_files, best_idx, final_idx = model_report(model_path)
        best_available, last_available = check_models(model_files, best_idx, final_idx)
        print('Model Name: %s, best epoch: %s (checkpoint available: %s), '
              'last epoch: %s (checkpoint available: %s)'
              % (model, best_idx, best_available, final_idx, last_available))
        if compare_dir is not None:
            compare_path = os.path.join(compare_dir, model)
            if os.path.exists(compare_path):
                _, best_c, final_c = model_report(compare_path)
                if best_c != best_idx:
                    print('Corresponding model best epoch (%s) does not match main '
                          'model!' % best_c)
                if final_c != final_idx:
                    print('Corresponding model final epoch (%s) does not match main '
                          'model!' % final_c)
            else:
                print('Corresponding model not found in compare directory.')


def extract_best_model(model_dir, out_dir):
    """(ref: helper_functions.py:257-273)"""
    model_name = os.path.basename(model_dir)
    new_model_dir = os.path.join(out_dir, model_name)
    create_dir_if_empty(new_model_dir,
                        os.path.join(new_model_dir, 'result_outputs'),
                        os.path.join(new_model_dir, 'saved_models'))
    data = ['result_outputs/loss_plots.pdf', 'result_outputs/summary.csv',
            'extra_metadata.csv', 'config.toml']
    summary = pd.read_csv(os.path.join(model_dir, data[1]))
    best_model_idx, _ = _best_last_epochs(summary)
    data.append('saved_models/train_model_%d' % best_model_idx)
    for file in data:
        src = os.path.join(model_dir, file)
        try:
            if os.path.isdir(src):  # orbax directory checkpoint
                shutil.copytree(src, os.path.join(new_model_dir, file),
                                dirs_exist_ok=True)
            else:
                shutil.copy2(src, os.path.join(new_model_dir, file))
        except Exception:
            print('%s not found.' % file)


def clean_models(model_dir, keep_epochs=None, clean_samples=False, keep_every=None):
    """Delete unneeded checkpoints (ref: helper_functions.py:276-317).

    ``keep_every=N`` additionally retains every Nth epoch checkpoint (a keep-period
    retention schedule for long runs — periodic restore points survive cleanup)."""
    summary = pd.read_csv(os.path.join(model_dir, 'result_outputs/summary.csv'))
    save_dir = os.path.join(model_dir, 'saved_models')

    def _epoch_of(f):
        try:
            return int(f.split('train_model_')[1])
        except ValueError:
            return None  # stray file (editor droppings, stale tmp): not a checkpoint

    model_files = [f for f in glob.glob(os.path.join(save_dir, 'train_model_*'))
                   if _epoch_of(f) is not None]
    model_files.sort(key=natural_keys)
    if not model_files:
        return
    best_model_idx, last_epoch = _best_last_epochs(summary)
    accepted_indices = [best_model_idx - 1, best_model_idx, best_model_idx + 1,
                        last_epoch,
                        int(model_files[-1].split('train_model_')[1])]
    if keep_epochs is not None:
        accepted_indices.extend(keep_epochs)
    if keep_every:
        accepted_indices.extend(
            i for f in model_files
            for i in [int(f.split('train_model_')[1])] if i % keep_every == 0)

    for file in model_files:
        index = int(file.split('train_model_')[1])
        if index not in accepted_indices:
            if os.path.isdir(file):  # orbax directory checkpoint
                shutil.rmtree(file)
            else:
                os.remove(file)
    print('These models have been retained:', sorted(set(accepted_indices)))

    if clean_samples:
        results_dir = os.path.join(model_dir, 'result_outputs/')
        for folder in next(os.walk(results_dir))[1]:
            if 'epoch_' in folder:
                shutil.rmtree(os.path.join(results_dir, folder))
        print('All epoch samples deleted.')


@click.command()
@click.option('--home_dir', help='Model search directory.')
@click.option('--out_dir', help='New directory for models.')
@click.option('-m', '--models', multiple=True, help='Models to extract.')
@click.option('--clean', is_flag=True,
              help='Clean model directory after extracting the best model.')
@click.option('-k', '--keep_epoch', multiple=True, type=int,
              help='Model numbers to retain apart from best epochs.')
@click.option('--clean_samples', is_flag=True,
              help='Also remove all image samples generated during training.')
@click.option('--all_models', is_flag=True,
              help='Extract best model from all experiments in directory.')
def extract_best_models(home_dir, out_dir, models, clean, keep_epoch, clean_samples,
                        all_models):
    if all_models:
        # only experiment dirs qualify — the tracker's JSONL home and other
        # non-experiment folders live alongside them
        models = [item for item in os.listdir(home_dir)
                  if os.path.isfile(os.path.join(home_dir, item, 'result_outputs',
                                                 'summary.csv'))]
    for model in tqdm(models):
        try:
            extract_best_model(os.path.join(home_dir, model), out_dir)
            if clean:
                clean_models(os.path.join(home_dir, model), keep_epochs=keep_epoch,
                             clean_samples=clean_samples)
        except Exception as exc:  # one broken experiment must not abort the batch
            print('skipping %s: %s' % (model, exc))


@click.command()
@click.option('--base_dir', default='.', help='Model root location')
@click.option('-m', '--models', multiple=True, help='Models to clean.')
@click.option('-k', '--keep_epoch', multiple=True, type=int,
              help='Model numbers to retain apart from best epochs.')
@click.option('--clean_samples', is_flag=True,
              help='Also remove all image samples generated during training.')
@click.option('--keep_every', default=None, type=int,
              help='Keep-period retention: additionally retain every Nth epoch '
                   'checkpoint (periodic restore points for long runs).')
def click_clean(base_dir, models, keep_epoch, clean_samples, keep_every):
    for model in tqdm(models):
        clean_models(os.path.join(base_dir, model), keep_epochs=keep_epoch,
                     clean_samples=clean_samples, keep_every=keep_every)


def convert_image_sequence_to_movie(image_folder, video_name, output_loc=None, fps=24):
    """Encode an image folder to an mp4v video with OpenCV, imported here only (the
    reference used moviepy/ffmpeg; ref: helper_functions.py:362-369)."""
    import cv2
    if output_loc is None:
        output_loc = image_folder
    image_files = extract_image_names_from_folder(image_folder)
    if not image_files:
        raise RuntimeError('No images found in %s' % image_folder)
    first = cv2.imread(image_files[0])
    h, w = first.shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*'mp4v')
    writer = cv2.VideoWriter(os.path.join(output_loc, video_name), fourcc, fps, (w, h))
    for f in image_files:
        writer.write(cv2.imread(f))
    writer.release()


@click.command()
@click.option('--image_folder', help='Input image folder to convert to video.')
@click.option('--video_name', help='Encoded video target name.')
@click.option('--output_loc', default=None,
              help='(Optional) Output directory for placing combined video.')
@click.option('--fps', default=24, help='Frames per second for encoded movie')
def click_image_sequence_to_movie(**kwargs):
    convert_image_sequence_to_movie(**kwargs)


if __name__ == '__main__':
    extract_best_models(sys.argv[1:])
