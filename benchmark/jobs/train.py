"""The training job: ``train_sisr``'s epochs as researchers run them, driven through
the program's own entry, ``TrainingHandler.train`` (the loader's threaded crops and
flips, batches copied ahead to the card, ``BaseHandler.run_train``: forward, L1,
backward, the recipe's clip if it has one, Adam with the recipe's schedule).  No
validation epoch and no checkpoint: those are outside the window.

Set-up builds one ``TrainingHandler``, puts the benchmark's weights into its model,
and drives it through ``warm_epochs`` epochs; the same object then runs the window.
Two stages of ``check_steps`` steps each are compared with the reference, on the
crops the loader made: the first steps of set-up, which the reference follows from the
benchmark's weights, and the first steps of the window, which it follows from the
program's own state where the window began (the parameters, Adam's moments, and the
number of updates so far, counted here).  Over the sixteen steps between, float32 and
TF32 drift apart further than a step's rounding, so the window's stage starts again
from where the program stands.  Each stage compares every step's loss, the first
gradient as Adam got it, the parameters' change over the stage, and the model's
output at the stage's first step, where both sides start from the same state.

Traffic keys: the generator's (``images``, ``lr_size``, ``scale``, ``content``,
``png_compress_level``, ``metadata_alpha``), and ``crop`` (LR side), ``batch``,
``random_augment``, ``cache_decoded``, ``loader_threads``, ``dtype`` (``f32``, or
``bf16`` for autocast), ``warm_epochs``, ``trace_epochs``, ``check_steps``.
"""
import gc
import os

import numpy as np
import torch

from benchmark import workload
from benchmark.jobs.common import Job, reference_module
from benchmark.jobs.eval import relative_gap
from benchmark.reference import common as ref_common
from benchmark.reference.crops import locate


def _host(named):
    return {n: t.detach().to('cpu', copy=True) for n, t in named.items()}


class StepCapture:
    """Wraps the interface's ``train_batch`` for the steps of each stage (``span``
    steps from each of ``stages``): their crops (as the loader made them) and losses,
    the model's output at each stage's first step (a forward hook, kept on the device
    until the comparison), and the state the comparison reads, copied to the host: at a
    later stage's start the parameters and Adam's moments, one step into each stage the
    first moments, at its end the parameters.  After the last stage it takes itself
    off."""

    def __init__(self, trainer, stages, span):
        self.iface, handler = trainer.model, trainer.handler
        self.last = max(stages) + span
        self.calls = 0
        self.steps = {}  # step: (crops, loss)
        self.state = {}  # boundary (after that many steps): {kind: {name: tensor}}
        self.outputs = {}  # a stage's first step: [the module's outputs in that step]
        module = handler.module
        named = dict(module.named_parameters())
        recorded = {k for s in stages for k in range(s, s + span)}
        marks = {}
        for s in stages:
            if s:  # the first stage starts from the benchmark's weights and a fresh Adam
                marks.setdefault(s, set()).update(('params', 'exp_avg', 'exp_avg_sq'))
            marks.setdefault(s + 1, set()).add('exp_avg')
            marks.setdefault(s + span, set()).add('params')

        def snapshot(b):
            optim = handler.optimizer.state
            out = {}
            for kind in marks.get(b, ()):
                out[kind] = _host(named) if kind == 'params' else _host(
                    {n: optim[p][kind] for n, p in named.items() if p in optim})
            self.state[b] = out

        inner = self.iface.train_batch

        def train_batch(**batch):
            k = self.calls
            hook = None
            if k in stages:
                kept = self.outputs.setdefault(k, [])
                hook = module.register_forward_hook(
                    lambda m, a, y: kept.append(y.detach().float().clone()))
            try:
                out = inner(**batch)
            finally:
                if hook is not None:
                    hook.remove()
            if k in recorded:
                crops = {'lr': torch.as_tensor(batch['lr']).to('cpu', copy=True),
                         'hr': torch.as_tensor(batch['hr']).to('cpu', copy=True),
                         'tag': list(batch['tag'])}
                self.steps[k] = (crops, float(out[0]))
            self.calls += 1
            if self.calls in marks:
                snapshot(self.calls)
            if self.calls == self.last:
                self.remove()
            return out

        self.iface.train_batch = train_batch
        self._inner = inner

    def remove(self):
        self.iface.train_batch = self._inner


class TrainJob(Job):
    kind = 'train'

    def setup(self):
        from sisr_tpu_torch.training.handler import TrainingHandler
        from sisr_tpu_torch.utils.toml_io import convert_default_none_dict
        t = self.traffic
        self.data = workload.write_pairs(os.path.join(self.work, 'pairs'), t,
                                         self.config.get('metadata_cols', 0), self.seed,
                                         self.device)
        self.mark('pairs')
        self.ref = reference_module(self.config)
        self.weights = workload.weights(self.ref.param_shapes(self.config['sizes']),
                                        self.seed, self.device)
        internal = dict(self.config['model']['internal_params'])
        if t['dtype'] != 'f32':
            internal['dtype'] = t['dtype']
        table = {'lr': self.data['lr_dir'], 'hr': self.data['hr_dir'], 'crop': int(t['crop']),
                 'random_augment': bool(t['random_augment']),
                 'cache_decoded': bool(t['cache_decoded'])}
        if self.config.get('metadata_cols'):
            table.update(degradation_metadata='on_site', metadata=['blur_kernel'])
        data_params = convert_default_none_dict({
            'training_sets': {'data_1': table},
            'eval_sets': {'data_1': {'lr': self.data['lr_dir'], 'hr': self.data['hr_dir'],
                                     'cutoff': 1}},
            'batch_size': int(t['batch']), 'dataloader_threads': int(t['loader_threads'])})
        self.trainer = TrainingHandler(
            experiment_name='bench', save_loc=os.path.join(self.work, 'Results'),
            model_params={'name': self.config['model']['name'], 'internal_params': internal},
            gpu='single' if self.cuda else 'off', sp_gpu=0, data_params=data_params,
            num_epochs=1, metrics=[], seed=self.seed % (1 << 31), logging=None,
            save_samples=False)
        self.handler = self.trainer.handler
        self.handler.module.load_state_dict(self.weights)
        self.mark('trainer')
        span = int(t['check_steps'])
        warm = int(t['warm_epochs']) * len(self.trainer.train_data)
        if span > min(warm, len(self.trainer.train_data)):
            raise ValueError('check_steps takes more steps than set-up or an epoch has')
        self.stages = (0, warm)  # the first steps of set-up, and of the window
        self.capture = StepCapture(self.trainer, self.stages, span)
        for i in range(int(t['warm_epochs'])):
            self.trainer.train()
            self.synchronize()
            self.mark('warm epoch %d' % i)

    @property
    def work_per_unit(self):
        return len(self.trainer.train_data.dataset)

    def unit(self):
        self.trainer.train()

    def stretch_units(self):
        return int(self.traffic['trace_epochs'])

    def counters(self):
        from sisr_tpu_torch.data import loader
        return {'items_loaded': loader.ITEMS_LOADED}

    def facts(self):
        return {'lr_side': int(self.traffic['crop'])}

    def release(self):
        """Drop the program's state: the handler, its model, optimizer and loader."""
        self.trainer = self.handler = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def reference_crops(self, batches):
        """The reference's own copies of each step's crops, found in the benchmark's
        images, and the number of crops it could not find."""
        index = {name: i for i, name in enumerate(self.data['names'])}
        scale = int(self.traffic['scale'])
        steps, misses = [], 0
        for batch in batches:
            lrs, hrs = [], []
            for lr_crop, hr_crop, tag in zip(batch['lr'], batch['hr'], batch['tag']):
                i = index.get(os.path.basename(tag))
                found = None if i is None else locate(
                    self.data['lr'][i], self.data['hr'][i], lr_crop, hr_crop, scale)
                if found is None:
                    misses += 1
                    found = (lr_crop, hr_crop)
                lrs.append(found[0])
                hrs.append(found[1])
            steps.append((np.stack(lrs), np.stack(hrs)))
        return steps, misses

    def reference_stage(self, first, steps, start, moments):
        """The reference's losses, first gradients' norms, parameters' change and
        first step's output (NCHW) over ``steps`` (crops) from update ``first`` on,
        starting from the parameters ``start`` and Adam's ``moments`` (None: zeros), in
        float32 with TF32 off."""
        internal = self.config['model']['internal_params']
        sched = internal.get('scheduler_params') or {}
        opt = internal.get('optimizer_params') or {}
        if internal.get('grad_clip'):
            raise ValueError('the reference writes no gradient clip')
        if internal['scheduler'] != 'cosine_annealing_warm_restarts':
            raise ValueError('the reference writes the SGDR schedule only')
        start = {k: v.to(self.device, torch.float32) for k, v in start.items()}
        params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        adam = ref_common.Adam(params, (opt.get('beta_1', 0.9), opt.get('beta_2', 0.999)),
                               opt.get('eps', 1e-8))
        if moments is not None:  # a leaf the program's Adam holds no state for starts at 0
            adam.t = first
            for kind, table in (('exp_avg', adam.m), ('exp_avg_sq', adam.v)):
                for k, v in moments[kind].items():
                    table[k] = v.to(self.device, copy=True)
        losses, grad_norms = [], None
        with ref_common.no_tf32():
            for i, (lr, hr) in enumerate(steps):
                x = torch.as_tensor(lr, device=self.device).permute(0, 3, 1, 2).float() / 255
                y = torch.as_tensor(hr, device=self.device).permute(0, 3, 1, 2).float() / 255
                for p in params.values():
                    p.grad = None
                sr = self.ref.forward(params, x, None, self.config['sizes'])
                loss = ref_common.l1(sr, y)
                loss.backward()
                losses.append(float(loss.detach()))
                if i == 0:
                    grad_norms = {k: float(p.grad.norm()) for k, p in params.items()}
                    first_sr = sr.detach()
                adam.step(ref_common.cosine_warm_restarts(
                    first + i, internal['lr'], sched['restart_period'],
                    sched.get('lr_min', 0.0), sched.get('t_mult', 1)))
        moved = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
        return losses, grad_norms, moved, first_sr

    def compare(self, limits, judged=None):
        cap = self.capture
        beta_1 = (self.config['model']['internal_params'].get('optimizer_params')
                  or {}).get('beta_1', 0.9)
        span = int(self.traffic['check_steps'])
        if cap.calls < cap.last:
            raise RuntimeError('the window ran %d of the %d steps the comparison follows'
                               % (cap.calls - self.stages[-1], span))
        outputs = {s: torch.cat(cap.outputs[s]).cpu() for s in self.stages}
        self.release()
        loss_gap, grad_gap, step_gap, sr_gap, misses = [], [], [], [], 0
        for s in self.stages:
            batches = [{k: (v.numpy() if torch.is_tensor(v) else v) for k, v in
                        cap.steps[k][0].items()} for k in range(s, s + span)]
            steps, missed = self.reference_crops(batches)
            misses += missed
            if s == 0:  # from the benchmark's own weights and a fresh Adam
                ref = self.reference_stage(0, steps, self.weights, None)
                before, start = {}, {k: v.cpu() for k, v in self.weights.items()}
            else:  # from the program's state where the window began
                first = cap.state[s]
                ref = self.reference_stage(s, steps, first['params'], first)
                before, start = first['exp_avg'], first['params']
            ref_losses, ref_g, ref_moved, ref_sr = ref
            # the model's output at the stage's first step, where both start alike
            sr_gap += list(relative_gap(outputs[s].to(ref_sr.device), ref_sr))
            loss_gap += [abs(cap.steps[s + i][1] - b) / b for i, b in enumerate(ref_losses)]
            # the gradient as Adam got it: m1 = beta_1 m0 + (1 - beta_1) g
            after = cap.state[s + 1]['exp_avg']
            grads = {k: float((after[k] - beta_1 * before.get(k, 0.0)).norm()) / (1 - beta_1)
                     for k in after}
            med_g = float(np.median(list(ref_g.values())))
            grad_gap += [abs(grads.get(k, 0.0) - ref_g[k]) / max(ref_g[k], med_g)
                         for k in ref_g]
            # leaves whose reference gradient is nought to rounding move under Adam by
            # round-off alone: they sit out the comparison of the change
            kept = [k for k in ref_g if ref_g[k] >= 1e-3 * med_g]
            end = cap.state[s + span]['params']
            moved = {k: float((end[k] - start[k]).norm()) for k in kept}
            med_d = float(np.median([ref_moved[k] for k in kept]))
            step_gap += [abs(moved[k] - ref_moved[k]) / max(ref_moved[k], med_d) for k in kept]
        self.capture = None
        numbers = {'loss_gap': max(loss_gap), 'grad_gap': max(grad_gap),
                   'step_gap': max(step_gap), 'sr_gap': float(max(sr_gap)),
                   'crop_misses': float(misses)}
        failed = sum(int(g > limits['loss_gap']) for g in loss_gap)
        return numbers, failed, len(loss_gap)


Job = TrainJob
