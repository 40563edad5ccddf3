"""Image saving and comparison collages (PyTorch port of sisr_tpu's
``tools/visualization.py``, ref: Code/sr_tools/visualization.py).

Images move through this module as N,H,W,C float arrays in [0, max_val].  The collages
are drawn with PIL, so the port needs no plotting library, and saved as one-page PDFs,
the pages sisr_tpu writes: the RGB page is one FlateDecode (zlib) image, lossless
(:func:`write_pdf_page`; PIL writes an RGB page to PDF only through its JPEG encoder,
which is lossy, and a palette page would quantise the images being compared).
"""
import math
import os
import zlib

import numpy as np
from PIL import Image, ImageDraw

from ..ops.colorspace import ycbcr_convert

_PANEL = 512  # the longest side of an image in a collage, in pixels
_LINE = 14  # pixels per line of PIL's default font
_MARGIN = 8


def _to_hwc(im):
    if im.ndim == 3 and im.shape[0] in (1, 3) and im.shape[-1] not in (1, 3):
        return im.transpose(1, 2, 0)
    return im


def _to_uint8(im, config, im_type, max_val):
    """An H,W,C float image as uint8 RGB (or one channel): from YCbCr first when
    ``config`` is 'ycbcr'; scaled by 255 / max_val, clipped, truncated."""
    im = _to_hwc(np.asarray(im))
    if config == 'ycbcr':
        im = ycbcr_convert(im.transpose(2, 0, 1), input='ycbcr',
                           im_type=im_type).transpose(1, 2, 0)
    return np.clip(im * 255 / max_val, 0, 255).astype(np.uint8)


def safe_image_save(images, out_loc, names, config='rgb', max_val=1, im_type='jpg'):
    """Save an N,H,W,C float batch in [0, max_val] as image files named ``names`` (ref:
    visualization.py:31-54); a 'ycbcr' batch is converted to RGB with the
    ``im_type`` matrices first."""
    for index in range(images.shape[0]):
        im = _to_uint8(images[index], config, im_type, max_val)
        if im.shape[-1] == 1:
            im = im[..., 0]
        Image.fromarray(im).save(os.path.join(out_loc, names[index]))


def write_pdf_page(image, path):
    """Write a PIL RGB ``image`` as a one-page PDF at ``path``: the page is the image
    at one point per pixel, an 8-bit DeviceRGB image XObject whose rows are
    zlib-compressed (FlateDecode), so the pixels read back exactly."""
    width, height = image.size
    pixels = zlib.compress(image.convert('RGB').tobytes())
    content = b'q %d 0 0 %d 0 0 cm /Im0 Do Q' % (width, height)
    objects = [
        b'<< /Type /Catalog /Pages 2 0 R >>',
        b'<< /Type /Pages /Kids [3 0 R] /Count 1 >>',
        b'<< /Type /Page /Parent 2 0 R /MediaBox [0 0 %d %d] /Resources << /XObject '
        b'<< /Im0 4 0 R >> >> /Contents 5 0 R >>' % (width, height),
        b'<< /Type /XObject /Subtype /Image /Width %d /Height %d /ColorSpace /DeviceRGB '
        b'/BitsPerComponent 8 /Filter /FlateDecode /Length %d >>\nstream\n%s\nendstream'
        % (width, height, len(pixels), pixels),
        b'<< /Length %d >>\nstream\n%s\nendstream' % (len(content), content)]
    out = bytearray(b'%PDF-1.4\n%\xe2\xe3\xcf\xd3\n')
    offsets = []
    for number, body in enumerate(objects, 1):
        offsets.append(len(out))
        out += b'%d 0 obj\n%s\nendobj\n' % (number, body)
    xref = len(out)
    out += b'xref\n0 %d\n0000000000 65535 f \n' % (len(objects) + 1)
    out += b''.join(b'%010d 00000 n \n' % offset for offset in offsets)
    out += b'trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n' % (
        len(objects) + 1, xref)
    with open(path, 'wb') as f:
        f.write(out)


def _panel_titles(image_package, extra_info):
    """{key: (grid position, title)}: HR ('Ground Truth') first, then LR ('Low Res'),
    then each model, its name split in two when longer than 14 characters, followed
    by its ``extra_info`` lines."""
    ordering = {}
    for key, title in (('HR', 'Ground Truth'), ('LR', 'Low Res')):
        if key in image_package:
            ordering[key] = (len(ordering), title)
    for key in image_package:
        if key in ordering:
            continue
        title = key
        if len(title) > 14:
            title = title[:len(title) // 2] + '\n' + title[len(title) // 2:]
        for line in (extra_info or {}).get(key, ()):
            title += '\n%s %s' % (line[0], line[1])
        ordering[key] = (len(ordering), title)
    return ordering


def interpret_sisr_images(image_package, metrics, metric_names, out_loc, names,
                          config='ycbcr', im_type='jpg', max_val=1, extra_info=None,
                          images_per_row=4):
    """One comparison collage per image (ref: visualization.py:72-185): the panels of
    ``image_package`` ({'HR': batch, 'LR': batch, model: batch}) on a grid of
    ``images_per_row`` columns, each with its title above and, for the models, the
    values of ``metric_names`` from ``metrics`` ({'model>metric': per-image values})
    below; model outputs are converted from YCbCr when ``config`` is 'ycbcr'.  Image
    ``i``'s page is written to ``out_loc/names[i]`` as a one-page PDF
    (:func:`write_pdf_page`)."""
    metrics = metrics if metrics is not None else {}
    metric_names = metric_names if metric_names is not None else []
    ordering = _panel_titles(image_package, extra_info)
    columns = max(1, images_per_row)
    rows = math.ceil(len(image_package) / columns)
    title_lines = max(title.count('\n') + 1 for _, title in ordering.values())
    label_lines = len(metric_names)
    for im_index, name in enumerate(names):
        panels = {}
        for key, val in image_package.items():
            im = _to_uint8(val[im_index], 'rgb' if key in ('HR', 'LR') else config,
                           im_type, max_val)
            if im.shape[-1] == 1:
                im = np.repeat(im, 3, axis=-1)
            panel = Image.fromarray(im)
            shrink = _PANEL / max(panel.size)
            if shrink < 1:
                panel = panel.resize((max(1, round(panel.width * shrink)),
                                      max(1, round(panel.height * shrink))), Image.LANCZOS)
            label = ''
            if key not in ('HR', 'LR'):
                for m_name in metric_names:
                    mkey = key + '>' + m_name
                    if mkey in metrics:
                        label += '{}: {:.3f}\n'.format(m_name, metrics[mkey][im_index])
            panels[key] = (panel, label)
        measure = ImageDraw.Draw(Image.new('RGB', (1, 1)))
        texts = [ordering[key][1] for key in panels] + [label for _, label in panels.values()]
        text_w = max(measure.multiline_textbbox((0, 0), t or ' ')[2] for t in texts)
        cell_w = max(text_w, max(p.width for p, _ in panels.values())) + 2 * _MARGIN
        cell_h = (max(p.height for p, _ in panels.values())
                  + (title_lines + label_lines) * _LINE + 2 * _MARGIN)
        page = Image.new('RGB', (cell_w * min(columns, len(panels)), cell_h * rows),
                         (255, 255, 255))
        draw = ImageDraw.Draw(page)
        for key, (panel, label) in panels.items():
            position, title = ordering[key]
            left = (position % columns) * cell_w + _MARGIN
            top = (position // columns) * cell_h + _MARGIN
            draw.multiline_text((left, top), title, fill=(0, 0, 0))
            page.paste(panel, (left, top + title_lines * _LINE))
            draw.multiline_text((left, top + title_lines * _LINE + panel.height + 2),
                                label.rstrip('\n'), fill=(0, 0, 0))
        write_pdf_page(page, os.path.join(out_loc, name))


def compare_training_curves(model_loc, out_name, models, metric='val-PSNR',
                            epoch_range=None, psnr_range=None, smooth=False):
    """Validation-curve comparison of experiments (ref: visualization.py:188-233): one
    curve of ``metric`` over the epochs of each model's summary.csv (a model with a
    '/' is a path, else a folder of ``model_loc``), optionally Savitzky-Golay smoothed
    (window up to 11, order up to 3, as sisr_tpu), drawn with PIL and saved in the
    format ``out_name`` names (a one-page pdf or a png)."""
    import pandas as pd
    from .stats import draw_panel, new_page
    curves = []
    for model in models:
        path = model if '/' in model else os.path.join(model_loc, model)
        data = pd.read_csv(os.path.join(path, 'result_outputs/summary.csv'))
        values = np.asarray(data[metric], np.float64)
        win = min(11, len(values) - (1 - len(values) % 2))
        if smooth and win >= 5:
            from scipy.signal import savgol_filter
            values = savgol_filter(values, win, min(3, win - 1))
        curves.append((model.split('/')[-1], list(data['epoch']), list(values)))
    page, draw = new_page(1000, 420)
    draw_panel(draw, (70, 20, 980, 370), curves, 'Epoch number', x_range=epoch_range,
               y_range=psnr_range, ylabel='Validation %s' % metric)
    page.save(out_name)
