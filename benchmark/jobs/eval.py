"""The evaluation job: ``eval_sisr --fused_eval`` as researchers run it, driven through
the program's own entry, ``EvalHub.full_image_protocol`` (the fused step
``BaseHandler.run_eval_fused``: forward, device bicubic, YCbCr, PSNR/SSIM), closed loop,
passes back to back over one folder of pairs, from the hub's device-batch cache.

Traffic keys: ``images``, ``lr_size`` (a side, or [height, width]), ``scale``,
``content``, ``png_compress_level``, ``metadata_alpha`` (the generator's); ``batch``, ``precision`` (``bf16``: autocast;
``int8``: the program's int8 path, calibrated on the first batch), ``warm_passes``,
``trace_passes``, ``check_images`` (how many images of the window's last pass the
reference judges) and ``check_block`` (the reference's images at a time).
"""
import gc
import math
import os

import numpy as np
import torch

from benchmark import workload
from benchmark.jobs.common import Job, reference_module, write_experiment
from benchmark.reference.common import no_tf32, quality_rows

ROW_KEYS = ('LR>PSNR', 'model>PSNR', 'LR>SSIM', 'model>SSIM')


class Capture:
    """The window's outputs, kept by reference as the program makes them: each
    image's SR (from the module's forward hook, or from a wrapper of the int8 program)
    and each batch's metric rows (from a wrapper of ``run_eval_fused``).  A pass
    replaces the last one's; :meth:`freeze` stops recording."""

    def __init__(self, handler, int8):
        self.handler = handler
        self.frozen = False
        self.tags = None
        self.sr, self.rows = {}, {}
        inner = handler.run_eval_fused

        def run_eval_fused(batch, *args, **kwargs):
            self.tags = list(batch['tag'])
            (keys, vals), runtime = inner(batch, *args, **kwargs)
            if not self.frozen:
                for i, tag in enumerate(self.tags):
                    self.rows[tag] = (keys, vals, i)
            return (keys, vals), runtime

        handler.run_eval_fused = run_eval_fused
        if int8:
            program = handler._int8_ctx[0]

            def int8_program(x, meta=None):
                out = program(x, meta)
                self._keep(out.permute(0, 3, 1, 2))  # the program gives NHWC
                return out

            handler._int8_ctx = (int8_program,) + tuple(handler._int8_ctx[1:])
        else:
            handler.module.register_forward_hook(lambda m, a, out: self._keep(out))

    def _keep(self, out):
        if not self.frozen:
            for i, tag in enumerate(self.tags):
                self.sr[tag] = out[i]

    def begin_pass(self):
        if not self.frozen:
            self.sr, self.rows = {}, {}

    def freeze(self):
        self.frozen = True


def relative_gap(sr, ref):
    """Each image's RMS gap to the reference over the reference's RMS."""
    return ((sr - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)).cpu().numpy()


class EvalJob(Job):
    kind = 'eval'

    def setup(self):
        from sisr_tpu_torch.evaluation.standard_eval import EvalHub
        t = self.traffic
        self.int8 = t['precision'] == 'int8'
        self.data = workload.write_pairs(os.path.join(self.work, 'pairs'), t,
                                         self.config.get('metadata_cols', 0), self.seed,
                                         self.device)
        self.mark('pairs')
        self.ref = reference_module(self.config)
        self.weights = workload.weights(self.ref.param_shapes(self.config['sizes']),
                                        self.seed, self.device)
        internal = dict(self.config['model']['internal_params'], dtype=t['dtype'])
        model_loc = write_experiment(self.work, self.config['model']['name'], internal,
                                     self.weights)
        self.mark('weights')
        self.hub = EvalHub(
            hr_dir=self.data['hr_dir'], lr_dir=self.data['lr_dir'],
            model_and_epoch=[('bench', '0')], results_name='bench_eval', gpu=self.cuda,
            metrics=['PSNR', 'SSIM'], data_split='all', save_im=False,
            batch_size=int(t['batch']), full_directory=True, lr_dir_interp=None,
            model_only=False, scale=int(t['scale']), model_loc=model_loc,
            out_loc=os.path.join(self.work, 'out'), use_test_group=False,
            no_image_comparison=True, num_image_save=0, qpi_selection=(None, None),
            data_attributes=None, dataset_name=None, image_shortlist=None,
            metadata_file=None, sp_gpu=0, time_models=False, recursive=False,
            device_metrics=True, fused_eval=True, int8=self.int8, cache_decoded=True,
            cache_device=True)
        self.handler = self.hub.model_bundles[0].model
        self.mark('hub')
        for i in range(int(t['warm_passes'])):
            self.hub.full_image_protocol()
            self.synchronize()
            self.mark('warm pass %d' % i)
        self.capture = Capture(self.handler, self.int8)

    def window(self, seconds):
        out = super().window(seconds)
        self.capture.freeze()
        return out

    @property
    def work_per_unit(self):
        return int(self.traffic['images'])

    def unit(self):
        self.capture.begin_pass()
        self.hub.full_image_protocol()

    def stretch_units(self):
        return int(self.traffic['trace_passes'])

    def counters(self):
        from sisr_tpu_torch.ops import channel_attention as ca
        f, r = ca.fused_channel_attention, ca.fused_channel_attention_residual
        return {'ca_onchip_launches': f.onchip_launches, 'ca_rounds_launches':
                f.rounds_launches, 'ca_stream_launches': f.stream_launches,
                'ca_res_rounds_launches': r.onchip_launches,
                'ca_res_stream_launches': r.stream_launches}

    def facts(self):
        """``lr_side``: the side of a square of the LR image's pixels (the FLOP and
        conv formulas of ``flops.py`` count pixels, side times side)."""
        height, width = workload.lr_shape(self.traffic)
        return {'lr_side': math.sqrt(height * width), 'images': int(self.traffic['images'])}

    def judged(self, sample):
        """The program's SR (NCHW float32) and metric rows (4, n) of the sampled
        images, from the window's last pass."""
        names = [self.data['names'][i] for i in sample]
        sr = torch.stack([self.capture.sr[n] for n in names]).float()
        rows = np.zeros((len(ROW_KEYS), len(names)))
        host = {}
        for j, name in enumerate(names):
            keys, vals, i = self.capture.rows[name]
            if id(vals) not in host:
                host[id(vals)] = vals.float().cpu().numpy()
            for k, key in enumerate(ROW_KEYS):
                rows[k, j] = host[id(vals)][keys.index(key), i]
        return sr, rows

    def release(self):
        """Drop the program's state: the hub, its model and its device-batch cache."""
        self.capture = self.hub = self.handler = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def sample(self):
        rng = np.random.default_rng(int(self.seed) + 7)
        n = int(self.traffic['images'])
        return np.sort(rng.choice(n, size=min(n, int(self.traffic['check_images'])),
                                  replace=False))

    def reference_outputs(self, sample, **arithmetic):
        """The reference's SR of the sampled images (float32, TF32 off), in blocks;
        ``arithmetic`` (``conv``, ``carry``) puts a lower precision in its place."""
        block = int(self.traffic['check_block'])
        outs = []
        with no_tf32(), torch.no_grad():
            for s in range(0, len(sample), block):
                idx = sample[s:s + block]
                x, meta = self.inputs(idx)
                outs.append(self.ref.forward(self.weights, x, meta, self.config['sizes'],
                                             **arithmetic))
        return torch.cat(outs)

    def inputs(self, idx):
        x = torch.as_tensor(self.data['lr'][idx], device=self.device)
        x = x.permute(0, 3, 1, 2).float() / 255.0
        meta = None
        if self.data['metadata'] is not None:
            meta = torch.as_tensor(self.data['metadata'][idx], device=self.device)
        return x, meta

    def reference_rows(self, sample, sr):
        rows = []
        with no_tf32(), torch.no_grad():
            block = int(self.traffic['check_block'])
            for s in range(0, len(sample), block):
                idx = sample[s:s + block]
                lr, _ = self.inputs(idx)
                hr = torch.as_tensor(self.data['hr'][idx], device=self.device)
                hr = hr.permute(0, 3, 1, 2).float() / 255.0
                p, q = quality_rows(sr[s:s + block], lr, hr)
                rows.append(torch.cat([p, q]).cpu().numpy())
        return np.concatenate(rows, axis=1)

    def compare(self, limits, judged=None):
        """The numbers compared with the reference, each beside its limit.  ``judged``
        replaces the program's outputs (the controls of a lower precision)."""
        sample = self.sample()
        sr, rows = self.judged(sample) if judged is None else judged(self, sample)
        self.release()
        ref_sr = self.reference_outputs(sample)
        ref_rows = self.reference_rows(sample, ref_sr)
        psnr_gap = np.abs(rows[:2] - ref_rows[:2]).max(axis=0)
        ssim_gap = np.abs(rows[2:] - ref_rows[2:]).max(axis=0)
        per_image = {'sr_err': relative_gap(sr, ref_sr), 'psnr_gap_db': psnr_gap,
                     'ssim_gap': ssim_gap}
        numbers = {k: float(np.max(v)) for k, v in per_image.items()}
        failed = int(np.sum(np.any([per_image[k] > limits[k] for k in limits], axis=0)))
        return numbers, failed, len(sample)


Job = EvalJob
