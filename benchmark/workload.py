"""The benchmark's one generator of inputs: LR/HR PNG pairs, their degradation
metadata and the model weights, all drawn from ``--seed``.

The pairs follow ``sisr_tpu_torch/tools/e2e_bench.build_workload`` (HR PNGs, LR PNGs
made from them with Pillow's bicubic downscale, ``degradation_metadata.csv`` rows of
Dirichlet(alpha) blur-kernel vectors beside the LR folder), with two of its faults
mended: every draw comes from the seed, and the images are not bare noise but
structured content (a smooth random field, flat rectangles with hard edges, sensor
noise), so PNG sizes and the model's inputs look like photographs' more than noise
does.  The image content is drawn on the device, a few images a call.

The weights are drawn on the device from the seed in one call, U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for every kernel and bias (PyTorch's default conv init), in float32,
the type both eval and training keep them in, with the keys and shapes the plain
reference lists.
"""
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.nn import functional as F


def _generator(device, seed, stream):
    return torch.Generator(device=device).manual_seed((int(seed) * 4 + stream) % (1 << 63))


def lr_shape(traffic):
    """(height, width) of the mix's LR images: ``lr_size`` is a side or a [height,
    width] pair."""
    size = traffic['lr_size']
    return (int(size), int(size)) if isinstance(size, (int, float)) else tuple(map(int, size))


def hr_images(n, shape, content, seed, device, chunk=8):
    """(n, height, width, 3) uint8 images on the host, drawn ``chunk`` at a time so that
    the draw holds little of the card's memory."""
    gen = _generator(device, seed, 1)
    height, width = shape
    grid = int(content['grid'])
    k = int(content['rectangles'])
    ys = torch.arange(height, device=device, dtype=torch.float32)
    xs = torch.arange(width, device=device, dtype=torch.float32)
    extent = torch.tensor([height, height, width, width], device=device, dtype=torch.float32)
    out = []
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        field = torch.rand((m, 3, grid, grid), generator=gen, device=device)
        img = F.interpolate(field, size=(height, width), mode='bicubic', align_corners=False)
        img = 40.0 + 175.0 * img.clamp(0.0, 1.0)
        corners = torch.rand((m, k, 4), generator=gen, device=device) * extent
        colors = torch.rand((m, k, 3), generator=gen, device=device) * 255.0
        for r in range(k):
            y0 = torch.minimum(corners[:, r, 0], corners[:, r, 1])[:, None]
            y1 = torch.maximum(corners[:, r, 0], corners[:, r, 1])[:, None]
            x0 = torch.minimum(corners[:, r, 2], corners[:, r, 3])[:, None]
            x1 = torch.maximum(corners[:, r, 2], corners[:, r, 3])[:, None]
            rows = (ys[None] >= y0) & (ys[None] < y1)
            cols = (xs[None] >= x0) & (xs[None] < x1)
            mask = (rows[:, :, None] & cols[:, None, :])[:, None]
            img = torch.where(mask, colors[:, r, :, None, None], img)
        img = img + float(content['noise']) * torch.randn(img.shape, generator=gen,
                                                          device=device)
        img = img.round().clamp(0, 255).to(torch.uint8)
        out.append(img.permute(0, 2, 3, 1).contiguous().cpu().numpy())
    return np.concatenate(out)


def write_pairs(root, traffic, metadata_cols, seed, device):
    """Write ``traffic['images']`` pairs under ``root`` (``lr/``, ``hr/``) and, with
    ``metadata_cols``, ``lr/degradation_metadata.csv``.  Returns the arrays as written:
    ``lr`` and ``hr`` uint8 (N, H, W, 3), ``metadata`` float32 (N, M) or None, the
    file ``names``, ``lr_dir`` and ``hr_dir``."""
    from PIL import Image
    n, (lr_h, lr_w) = int(traffic['images']), lr_shape(traffic)
    scale = int(traffic['scale'])
    hr = hr_images(n, (lr_h * scale, lr_w * scale), traffic['content'], seed, device)
    lr_dir, hr_dir = os.path.join(root, 'lr'), os.path.join(root, 'hr')
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    names = ['im_%04d.png' % i for i in range(n)]
    level = int(traffic['png_compress_level'])

    def one(i):
        hr_im = Image.fromarray(hr[i])
        lr_im = hr_im.resize((lr_w, lr_h), Image.BICUBIC)
        hr_im.save(os.path.join(hr_dir, names[i]), compress_level=level)
        lr_im.save(os.path.join(lr_dir, names[i]), compress_level=level)
        return np.asarray(lr_im)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        lr = np.stack(list(pool.map(one, range(n))))
    metadata = None
    if metadata_cols:
        rng = np.random.default_rng(int(seed))
        metadata = rng.dirichlet(np.full(metadata_cols, float(traffic['metadata_alpha'])),
                                 size=n).astype(np.float32)
        with open(os.path.join(lr_dir, 'degradation_metadata.csv'), 'w') as f:
            f.write('image,blur_kernel\n')
            for name, row in zip(names, metadata):
                f.write('%s,"%s"\n' % (name, json.dumps([float(v) for v in row])))
    return {'lr': lr, 'hr': hr, 'metadata': metadata, 'names': names,
            'lr_dir': lr_dir, 'hr_dir': hr_dir}


def weights(shapes, seed, device):
    """{key: float32 tensor on ``device``} for the reference's ``param_shapes`` list."""
    gen = _generator(device, seed, 2)
    sizes = [int(np.prod(shape)) for _, shape, _ in shapes]
    bounds = torch.tensor([1.0 / np.sqrt(fan_in) for _, _, fan_in in shapes],
                          device=device, dtype=torch.float32)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    flat = (2.0 * flat - 1.0) * torch.repeat_interleave(
        bounds, torch.tensor(sizes, device=device))
    out, offset = {}, 0
    for (key, shape, _), size in zip(shapes, sizes):
        out[key] = flat[offset:offset + size].view(shape)
        offset += size
    return out
