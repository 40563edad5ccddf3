"""Training statistics: summary.csv and loss plots (PyTorch port of the training subset
of sisr_tpu's ``tools/stats.py``, ref: Code/sr_tools/stats.py).  The plots are drawn
with PIL, so the port needs no plotting library."""
import ast
import os

import pandas as pd


_PANEL = (1000, 240)  # width, height of one panel in pixels
# the page's palette: white, black, then the series' colours (a palette image is saved
# to pdf without a JPEG encoder, which some PIL builds lack)
_PALETTE = ((255, 255, 255), (0, 0, 0), (31, 119, 180), (255, 127, 14), (44, 160, 44),
            (214, 39, 40))
_WHITE, _BLACK, _COLOURS = 0, 1, (2, 3, 4, 5)


def plot_stats(stats_dict, keynames, experiment_log_dir, filename):
    """Loss/PSNR/SSIM curves per epoch (ref: stats.py:11-31), one panel for each group
    of ``keynames`` whose metrics are all in ``stats_dict``: dashed lines with a marker
    per epoch and a legend, drawn with PIL and saved in the format ``filename`` names
    (a one-page pdf for loss_plots.pdf)."""
    from PIL import Image, ImageDraw
    valid_keys = [key for key in keynames if all(metric in stats_dict for metric in key)]
    if not valid_keys or 'epoch' not in stats_dict:
        return
    width, height = _PANEL
    page = Image.new('P', (width, height * len(valid_keys)), _WHITE)
    page.putpalette([v for rgb in _PALETTE for v in rgb])
    draw = ImageDraw.Draw(page)
    epochs = [float(e) for e in stats_dict['epoch']]
    for ind, key in enumerate(valid_keys):
        top, left, right, bottom = ind * height + 20, 70, width - 20, (ind + 1) * height - 30
        series = [[float(v) for v in stats_dict[metric]] for metric in key]
        finite = [v for vals in series for v in vals if v == v]
        lo, hi = (min(finite), max(finite)) if finite else (0.0, 1.0)
        lo, hi = (lo - 0.5, hi + 0.5) if hi == lo else (lo, hi)
        e_lo, e_hi = min(epochs), max(epochs) if max(epochs) > min(epochs) else min(epochs) + 1

        def xy(e, v):
            return (left + (e - e_lo) / (e_hi - e_lo) * (right - left),
                    bottom - (v - lo) / (hi - lo) * (bottom - top))

        draw.rectangle((left, top, right, bottom), outline=_BLACK)
        draw.text((5, top), '%.4g' % hi, fill=_BLACK)
        draw.text((5, bottom - 10), '%.4g' % lo, fill=_BLACK)
        draw.text(((left + right) // 2, bottom + 8), 'Epoch', fill=_BLACK)
        for colour, metric, vals in zip(_COLOURS * 2, key, series):
            points = [xy(e, v) for e, v in zip(epochs, vals) if v == v]
            for a, b in zip(points, points[1:]):  # dashed: every other tenth of a segment
                for t in range(0, 10, 2):
                    draw.line([(a[0] + (b[0] - a[0]) * t / 10, a[1] + (b[1] - a[1]) * t / 10),
                               (a[0] + (b[0] - a[0]) * (t + 1) / 10,
                                a[1] + (b[1] - a[1]) * (t + 1) / 10)], fill=colour, width=2)
            for x, y in points:
                draw.ellipse((x - 3, y - 3, x + 3, y + 3), fill=colour)
        for i, (colour, metric) in enumerate(zip(_COLOURS * 2, key)):
            draw.text((right - 150, top + 8 + 14 * i), metric, fill=colour)
    page.save(os.path.join(experiment_log_dir, filename))


def save_statistics(experiment_log_dir, filename, stats_dict, selected_data=None,
                    append=True):
    """Append the ``selected_data`` epoch rows of ``stats_dict`` to summary.csv, or
    write it whole (ref: stats.py:63-77)."""
    true_filename = os.path.join(experiment_log_dir, filename)
    pd_data = pd.DataFrame.from_dict(stats_dict)
    if selected_data is not None and os.path.isfile(true_filename):
        existing_cols = pd.read_csv(true_filename, nrows=0).columns.tolist()
        if existing_cols != list(pd_data.columns):
            # the column set changed (a resume with another metric list): rows would
            # not match the header, so rewrite the whole (NaN-padded) history
            append = False
        else:
            if type(selected_data) == int:
                selected_data = [selected_data]
            # the freshest row per selected epoch (a resume from an earlier epoch
            # leaves a stale row with the same epoch number in the dict)
            pd_data = pd_data.loc[pd_data['epoch'].isin(selected_data)]
            pd_data = pd_data.drop_duplicates(subset='epoch', keep='last')
    if not os.path.isfile(true_filename):
        append = False
    pd_data.to_csv(true_filename, mode='a' if append else 'w', header=not append,
                   index=False)


def legacy_load_statistics(experiment_log_dir, filename):
    """summary.csv -> dict of lists (ref: stats.py:112-132); empty cells (pandas'
    NaN) read as NaN."""
    with open(os.path.join(experiment_log_dir, filename), 'r') as f:
        lines = f.readlines()
    keys = lines[0].rstrip('\n').split(',')
    stats = {key: [] for key in keys}
    for line in lines[1:]:
        for idx, value in enumerate(line.rstrip('\n').split(',')):
            if value == '':
                stats[keys[idx]].append(float('nan'))
                continue
            try:
                stats[keys[idx]].append(ast.literal_eval(value))
            except (ValueError, SyntaxError):
                stats[keys[idx]].append(value)
    return stats
