"""Optimizer and update of the train step (PyTorch port of sisr_tpu's
``training/state.py``).

sisr_tpu chains optax transformations: global-norm clipping, then the weight decay
added to the gradient, then Adam with a per-step schedule.  Here the same update is
:func:`clip_by_global_norm` on the gradients followed by ``torch.optim.Adam`` (whose
``weight_decay`` is added to the gradient before the moments, as optax's
``add_decayed_weights`` placed before ``adam`` does), with the optimizer's lr set from
the schedule before each step (:func:`apply_update`).
"""
import torch

from .schedulers import build_schedule

_OPTIMIZER_KEYS = ('beta_1', 'beta_2', 'eps', 'weight_decay')


def build_optimizer(parameters, lr=1e-4, scheduler=None, scheduler_params=None,
                    optimizer_params=None, fused=False):
    """(torch.optim.Adam over ``parameters``, schedule).  ``optimizer_params`` takes
    the reference's ``beta_1``, ``beta_2``, ``eps`` and ``weight_decay``; any other key
    raises.  ``fused`` selects torch's single-kernel Adam (CUDA parameters)."""
    schedule = build_schedule(lr, scheduler, scheduler_params)
    params = dict(optimizer_params or {})
    unknown = set(params) - set(_OPTIMIZER_KEYS)
    if unknown:
        # silently dropping config keys would train with defaults while the
        # experiment log claims the configured values
        raise ValueError('Unsupported optimizer_params %s (supported: beta_1, '
                         'beta_2, eps, weight_decay)' % sorted(unknown))
    optimizer = torch.optim.Adam(
        parameters, lr=schedule(0),
        betas=(params.get('beta_1', 0.9), params.get('beta_2', 0.999)),
        eps=params.get('eps', 1e-8), weight_decay=params.get('weight_decay', 0.0) or 0.0,
        fused=fused or None)
    return optimizer, schedule


def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` in place by ``max_norm / norm`` where their global L2 norm
    exceeds ``max_norm`` (optax's ``clip_by_global_norm``; torch's ``clip_grad_norm_``
    divides by ``norm + 1e-6`` instead).  Stays on the device: no host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, (max_norm / norm).clamp(max=1.0))


def apply_update(optimizer, schedule, step, grad_clip=None):
    """One optimizer update from the gradients in place: clip (when ``grad_clip``),
    set the lr to ``schedule(step)`` (the update count before this one), Adam."""
    if grad_clip:
        grads = [p.grad for group in optimizer.param_groups for p in group['params']
                 if p.grad is not None]
        clip_by_global_norm(grads, grad_clip)
    lr = schedule(step)
    for group in optimizer.param_groups:
        group['lr'] = lr
    optimizer.step()
