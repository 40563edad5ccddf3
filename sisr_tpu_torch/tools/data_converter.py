"""image_manipulate: offline dataset degradation pipelines (PyTorch port of
sisr_tpu's ``tools/data_converter.py``, ref: Code/sr_tools/data_converter.py).

Host-only: every step runs on the CPU (numpy, scipy, PIL and the port's Pillow-exact
resampler), and no model or card is involved.  Pipelines chain blur ->
downscale/upscale -> jpeg/JM-H.264 compression, writing lossless PNGs plus
``degradation_metadata.csv`` (JSON-list columns) and ``pca_matrix.pth`` for blur, the
dataset contract the training and eval data layer reads.

The JM H.264 reference encoder is the user's external binary, run as a subprocess
(``<repo_parent>/JM/bin/lencod.exe``, ref: data_converter.py:100-107); the YUV420p
conversion the reference delegated to scikit-video/ffmpeg is numpy here (BT.601
studio range, 2x2 chroma averaging).  ``create_h5`` imports h5py when called.
"""
from collections import defaultdict
from io import BytesIO
import os
import random
import subprocess
import sys

import click
import numpy as np
import pandas as pd
import PIL.Image
from tqdm import tqdm

import torch

from ..configuration import constants as sconst
from ..ops import degradations as g_utils
from ..ops.transforms import downsample, float_to_pil, pil_to_float
from ..ops.resize import resize_uint8
from ..utils.helpers import create_dir_if_empty, extract_image_names_from_folder, \
    generate_range


# --- YUV420p <-> RGB (replaces skvideo/ffmpeg) --------------------------------------------
def rgb_to_yuv420p(rgb):
    """H,W,3 uint8 RGB -> planar YUV420p bytes (BT.601 studio range).

    4:2:0 chroma requires even dimensions: odd-sized inputs are cropped by one
    row/column (the same rounding downsample(jm=True) applies up front)."""
    rgb = rgb[:rgb.shape[0] // 2 * 2, :rgb.shape[1] // 2 * 2]
    rgb = rgb.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.
    u = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.
    v = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.
    y = np.clip(np.round(y), 0, 255).astype(np.uint8)
    # 2x2 chroma averaging
    u = u.reshape(u.shape[0] // 2, 2, u.shape[1] // 2, 2).mean(axis=(1, 3))
    v = v.reshape(v.shape[0] // 2, 2, v.shape[1] // 2, 2).mean(axis=(1, 3))
    u = np.clip(np.round(u), 0, 255).astype(np.uint8)
    v = np.clip(np.round(v), 0, 255).astype(np.uint8)
    return y.tobytes() + u.tobytes() + v.tobytes()


def yuv420p_to_rgb(data, height, width):
    """Planar YUV420p bytes -> H,W,3 uint8 RGB (BT.601 studio range)."""
    frame = np.frombuffer(data, dtype=np.uint8, count=height * width * 3 // 2)
    y = frame[:height * width].reshape(height, width).astype(np.float64)
    u = frame[height * width:height * width * 5 // 4].reshape(height // 2,
                                                              width // 2)
    v = frame[height * width * 5 // 4:].reshape(height // 2, width // 2)
    u = np.repeat(np.repeat(u, 2, axis=0), 2, axis=1).astype(np.float64) - 128
    v = np.repeat(np.repeat(v, 2, axis=0), 2, axis=1).astype(np.float64) - 128
    c = (y - 16) * 255. / 219.
    r = c + v * 255. / 224. * 1.402
    g = c - 255. / 224. * (u * 1.772 * 0.114 / 0.587 + v * 1.402 * 0.299 / 0.587)
    b = c + u * 255. / 224. * 1.772
    return np.clip(np.round(np.stack([r, g, b], axis=-1)), 0, 255).astype(np.uint8)


class ConversionHub:
    """(ref: data_converter.py:24-271)"""

    def __init__(self, ref_dir, out_dir, recursive=False):
        self.image_names = []
        self.ref_dir = ref_dir
        self.out_dir = out_dir
        self.lossless_extension = '.png'
        create_dir_if_empty(out_dir)

        if os.path.isdir(ref_dir):
            self.image_names = extract_image_names_from_folder(ref_dir,
                                                               recursive=recursive)
        elif os.path.isfile(ref_dir):
            self.image_names = [ref_dir]
        else:
            raise RuntimeError('Please provide a valid filename/folder.')

        self.base_names = [os.path.splitext(os.path.basename(loc))[0]
                           for loc in self.image_names]
        if len(set(self.base_names)) != len(self.base_names):
            dupes = sorted({n for n in self.base_names
                            if self.base_names.count(n) > 1})[:4]
            raise RuntimeError(
                'Duplicate image basenames across subfolders (e.g. %s): outputs '
                'are written flat into out_dir, so later files would silently '
                'overwrite earlier ones and corrupt the metadata index.' % dupes)
        self.function_library = {
            'jm_compress': (self.jm_compress, 'QPI'),
            'jpeg_compress': (self.jpeg_compress, 'jpeg_quality'),
            'downscale': (self.downscale, None),
            'upscale': (self.upscale, None),
            'blur': (self.blur, 'blur_kernel'),
        }
        self.save_info_buffer = defaultdict(list)

    def _blur_setup(self, blur_sig):
        """30k random kernels -> PCA(10) matrix -> online degrader
        (ref: data_converter.py:72-80)."""
        batch_ker = g_utils.random_batch_kernel(batch=30000)
        pca_matrix = g_utils.pca_matrix(batch_ker.reshape(30000, -1), k=10)
        torch.save(torch.from_numpy(pca_matrix), os.path.join(self.out_dir, 'pca_matrix.pth'))
        return g_utils.OnlineDegrader(pca_matrix, random=blur_sig is None, noise=False,
                                      noise_high=0.0, sig=blur_sig)

    def _jm_command(self):
        """JM lencod command template (ref: data_converter.py:82-107)."""
        jm_bin = os.path.join(os.path.dirname(sconst.base_directory), 'JM/bin')
        lencod = os.path.join(jm_bin, 'lencod.exe')
        if not os.path.isfile(lencod):
            raise RuntimeError('JM encoder not found at %s — build the JM reference '
                               'software (see README) to use jm_compress.' % lencod)
        temp_yuv = os.path.join(self.out_dir, 'vid_temp.yuv')
        temp_comp = os.path.join(self.out_dir, 'vid_comp.yuv')
        temp_h264 = os.path.join(self.out_dir, 'vid_comp.h264')
        temp_stats = os.path.join(self.out_dir, 'comp_stats.dat')
        temp_leaky = os.path.join(self.out_dir, 'leakybucketparam.cfg')
        jm_params = {'InputFile': temp_yuv, 'OutputFile': temp_h264,
                     'ReconFile': temp_comp, 'StatsFile': temp_stats,
                     'LeakyBucketParamFile': temp_leaky,
                     'NumberBFrames': 0, 'IDRPeriod': 1, 'IntraPeriod': 1}
        cmd = [lencod, '-d', os.path.join(jm_bin, 'encoder_baseline.cfg')]
        for key, val in jm_params.items():
            cmd += ['-p', '%s=%s' % (key, val)]
        # lencod also drops data.txt / log.dat into the working directory
        return cmd, temp_yuv, temp_comp, [temp_yuv, temp_comp, temp_h264, temp_stats,
                                          temp_leaky,
                                          os.path.join(os.getcwd(), 'data.txt'),
                                          os.path.join(os.getcwd(), 'log.dat')]

    def run_conversion(self, pipeline, blur_sig=None, skip_images=False, **kwargs):
        """(ref: data_converter.py:113-176)"""
        temp_locations = []
        preexisting = set()
        if 'jm_compress' in pipeline:
            jm_cmd, yuv_loc, comp_loc, temp_locations = self._jm_command()
            # lencod drops data.txt/log.dat into the CWD; never delete files the
            # user already had there
            preexisting = {loc for loc in temp_locations if os.path.isfile(loc)}
            kwargs = {**kwargs, 'jm_command': jm_cmd, 'yuv_loc': yuv_loc,
                      'comp_loc': comp_loc, 'jm': True}
        if 'blur' in pipeline:
            kwargs = {**kwargs, 'blur_system': self._blur_setup(blur_sig)}

        diag = 'Running conversion with the following pipeline: input '
        metadata = ['image']
        for command in pipeline:
            diag += '-> %s ' % command
            c_data = self.function_library[command][1]
            if c_data is not None:
                metadata.append(c_data)
        print(diag)

        saveable_metadata = defaultdict(list)
        for index, image_name in enumerate(tqdm(self.image_names)):
            flux_images = [PIL.Image.open(image_name)]
            self.save_info_buffer = defaultdict(list)
            for func in pipeline:
                flux_images = self.function_library[func][0](*flux_images, **kwargs)

            if len(flux_images) == 1:
                base_name = self.base_names[index] + self.lossless_extension
                saveable_metadata['image'].append(base_name)
                for key, val in self.save_info_buffer.items():
                    saveable_metadata[key].append(val[0])
                if not skip_images:
                    flux_images[0].save(os.path.join(self.out_dir, base_name))
            else:
                for flux_index, final_image in enumerate(flux_images):
                    base_name = self.base_names[index] + '_q%d' % flux_index \
                        + self.lossless_extension
                    saveable_metadata['image'].append(base_name)
                    for key, val in self.save_info_buffer.items():
                        saveable_metadata[key].append(
                            val[0] if len(val) == 1 else val[flux_index])
                    if not skip_images:
                        final_image.save(os.path.join(self.out_dir, base_name))

        if len(metadata) > 1:
            df = pd.DataFrame.from_dict(saveable_metadata).set_index(['image'])
            df.to_csv(os.path.join(self.out_dir, 'degradation_metadata.csv'))

        for location in temp_locations:
            if os.path.isfile(location) and location not in preexisting:
                os.remove(location)

    # --- ops (ref: data_converter.py:178-271) --------------------------------------------
    def jpeg_compress(self, *images, jpeg_quality=60, **kwargs):
        compressed = []
        for image in images:
            buffer = BytesIO()
            image.save(buffer, "JPEG", subsampling=0, quality=jpeg_quality)
            buffer.seek(0)
            compressed.append(PIL.Image.open(buffer))
            self.save_info_buffer['jpeg_quality'].append(jpeg_quality)
        return compressed

    def jm_compress(self, *images, jm_command, yuv_loc, comp_loc, verbose=False,
                    jm_qpi=28, compression_range=(10, 50), random_compression=False,
                    qpi_divisions=None, **kwargs):
        compressed = []
        if random_compression:
            if qpi_divisions is not None:
                qpi_list = []
                splits = generate_range(compression_range, qpi_divisions)
                for _ in images:
                    qpi_list.append([random.randint(splits[i], splits[i + 1] - 1)
                                     for i in range(len(splits) - 1)])
            else:
                qpi_list = [[random.randint(*compression_range)] for _ in images]
        else:
            qpi_list = [[jm_qpi] for _ in images]

        for index, image in enumerate(images):
            arr = np.array(image.convert('RGB'))
            l_h, l_w = arr.shape[0] // 2 * 2, arr.shape[1] // 2 * 2  # 4:2:0 even dims
            with open(yuv_loc, 'wb') as f:
                f.write(rgb_to_yuv420p(arr))
            for qpi in qpi_list[index]:
                cmd = jm_command + ['-p', 'QPISlice=%d' % qpi,
                                    '-p', 'SourceHeight=%d' % l_h,
                                    '-p', 'SourceWidth=%d' % l_w,
                                    '-p', 'FramesToBeEncoded=1']
                if os.path.isfile(comp_loc):
                    os.remove(comp_loc)  # a failed encode must not silently
                    # re-read the PREVIOUS image's reconstruction
                process = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE)
                stdout, stderr = process.communicate()
                if verbose:
                    print('JM output:', stdout.decode(errors='replace'))
                if process.returncode != 0:
                    raise RuntimeError(
                        'lencod failed (exit %d) on %s at QPI %d:\n%s'
                        % (process.returncode, self.base_names[index], qpi,
                           stderr.decode(errors='replace')[-2000:]))
                with open(comp_loc, 'rb') as f:
                    data = f.read()
                compressed.append(PIL.Image.fromarray(yuv420p_to_rgb(data, l_h, l_w)))
                self.save_info_buffer['QPI'].append(qpi)
        return compressed

    def blur(self, *images, blur_system, save_original_kernel=False, **kwargs):
        blurred = []
        for image in images:
            arr = pil_to_float(image.convert('RGB'))
            tensor_image, kernel_map, unreduced = blur_system(arr)
            blurred.append(float_to_pil(tensor_image))
            self.save_info_buffer['blur_kernel'].append(kernel_map.tolist())
            if save_original_kernel:
                self.save_info_buffer['unmodified_blur_kernel'].append(
                    unreduced.flatten().tolist())
        return blurred

    def downscale(self, *images, scale=4, jm=False, **kwargs):
        out = []
        for image in images:
            _, lr_im = downsample(image, scale=scale, jm=jm)
            out.append(lr_im)
        return out

    def upscale(self, *images, scale=4, **kwargs):
        out = []
        for image in images:
            arr = np.asarray(image.convert('RGB'))
            up = resize_uint8(arr, (image.width * scale, image.height * scale))
            out.append(PIL.Image.fromarray(up))
        return out


@click.command()
@click.option("--source_dir", default=sconst.data_directory,
              help='Input directory to source images.')
@click.option("--output_dir", default=os.path.join(sconst.data_directory, 'new_images'),
              help='Output directory to save new images.')
@click.option("--pipeline", default='downscale-jm_compress', show_default=True,
              help='Pipeline of operations to perform, separated by "-". Available: '
                   'jm_compress, jpeg_compress, downscale, upscale, blur')
@click.option("--seed", default=8, help='Random seed.')
@click.option("--scale", default=4, help='Scale to use when downsampling. Default 4.')
@click.option("--jm_qpi", default=28,
              help='Quality value for JM compression. Higher is worse (up to 51).')
@click.option("--verbose", default=False, help='Turn on/off JM output verbosity.')
@click.option("--random_compression", is_flag=True,
              help='Compress images with random QPI values.')
@click.option("--compression_range", default=(20, 40), type=(int, int),
              help='QPI compression range.')
@click.option("--qpi_divisions", type=int,
              help='Number of compressed images to create per input image.')
@click.option("--jpeg_quality", default=60,
              help='Quality value for jpeg compression (up to 100).')
@click.option('--blur_sig', default=None, type=float,
              help='Blur kernel width, if random kernel selection not required.')
@click.option('--save_original_kernel', default=False, is_flag=True,
              help='Also save the original (unreduced) blur kernel.')
@click.option('--recursive', is_flag=True,
              help='Seek out images in all sub-directories of the directory specified.')
@click.option('--skip_images', default=False, is_flag=True,
              help='Skip image saving; only save generated metadata.')
def manipulation_hub(source_dir, output_dir, pipeline, seed, recursive, **kwargs):
    """Main function for degrading and preparing images for SR
    (ref: data_converter.py:273-325)."""
    random.seed(seed)
    if 'blur' in pipeline:
        np.random.seed(seed)  # the kernels' draws (sisr_tpu's set_random_seed)
    if kwargs['jm_qpi'] > 51 or kwargs['compression_range'][1] > 51:
        raise RuntimeError('QPI cannot be larger than 51.')
    pipeline = pipeline.split('-')
    converter = ConversionHub(source_dir, output_dir, recursive=recursive)
    converter.run_conversion(pipeline, **kwargs)


def create_h5(image_dir, out_path, recursive=False):
    """Bundle a folder of same-sized images into an h5 dataset, 'images' (N, H, W, 3)
    uint8 (sisr_tpu's working version of the reference's data_converter.py:52-70)."""
    import h5py
    names = extract_image_names_from_folder(image_dir, recursive=recursive)
    if not names:
        raise RuntimeError('No images found in %s' % image_dir)
    first = np.asarray(PIL.Image.open(names[0]).convert('RGB'))
    with h5py.File(out_path, 'w') as h5_file:
        dataset = h5_file.create_dataset('images', (len(names),) + first.shape, 'uint8')
        for idx, name in enumerate(names):
            dataset[idx] = np.asarray(PIL.Image.open(name).convert('RGB'))
    return out_path


if __name__ == '__main__':
    manipulation_hub(sys.argv[1:])
