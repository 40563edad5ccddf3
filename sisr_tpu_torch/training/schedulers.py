"""Learning-rate schedules as plain ``step -> lr`` functions (PyTorch port of
sisr_tpu's ``training/schedulers.py``).

The reference steps its torch schedulers once per BATCH, not per epoch (ref:
Code/SISR/models/__init__.py:488-489), so every counter here is in optimizer steps and
config values like ``restart_period`` / ``milestones`` are in batches.  The train step
sets the optimizer's lr to ``schedule(step)`` before its update, with ``step`` the
number of updates already made: the first update uses ``schedule(0)``, as optax does
when it evaluates a schedule at the update count before the increment.
"""
import math


def cosine_annealing_warm_restarts(base_lr, restart_period, t_mult=1, lr_min=0.0):
    """torch CosineAnnealingWarmRestarts stepped per batch
    (ref: models/__init__.py:303-307)."""
    t0 = float(restart_period)
    tm = float(t_mult)

    def schedule(step):
        step = float(step)
        if tm == 1.0:
            t_cur = math.fmod(step, t0)
            t_i = t0
        else:
            # the epsilon keeps exact restart boundaries from rounding down (sisr_tpu
            # adds the same one)
            n = math.floor(math.log(step / t0 * (tm - 1.0) + 1.0) / math.log(tm) + 1e-6)
            t_cur = step - t0 * (tm ** n - 1.0) / (tm - 1.0)
            t_i = t0 * tm ** n
        return lr_min + (base_lr - lr_min) * 0.5 * (1.0 + math.cos(math.pi * t_cur / t_i))

    return schedule


def multi_step_lr(base_lr, milestones, gamma):
    """torch MultiStepLR (ref: models/__init__.py:308-311); milestones in steps."""
    ms = sorted(float(m) for m in milestones)

    def schedule(step):
        return base_lr * gamma ** sum(float(step) >= m for m in ms)

    return schedule


def step_lr(base_lr, step_size, gamma):
    """torch StepLR (ref: models/__init__.py:324-327)."""

    def schedule(step):
        return base_lr * gamma ** math.floor(float(step) / step_size)

    return schedule


def custom_dasr(base_lr):
    """The reference's DASR LambdaLR (ref: models/__init__.py:312-323), with its two
    quirks kept as sisr_tpu keeps them: the lambda's values multiply the configured lr,
    and its breakpoints count batches."""

    def schedule(step):
        step = float(step)
        if step < 60:
            lam = 1e-3
        elif step < 225:
            lam = 1e-4
        else:
            lam = 1e-4 * 0.5 ** math.floor((step - 100.0) / 125.0)
        return base_lr * lam

    return schedule


def constant(base_lr):
    def schedule(step):
        return float(base_lr)

    return schedule


def build_schedule(lr, scheduler=None, scheduler_params=None):
    """A schedule from the reference's TOML naming (ref: models/__init__.py:302-329)."""
    if scheduler is None:
        return constant(lr)
    scheduler_params = scheduler_params or {}
    if scheduler == 'cosine_annealing_warm_restarts':
        return cosine_annealing_warm_restarts(lr, scheduler_params['restart_period'],
                                              scheduler_params.get('t_mult', 1) or 1,
                                              scheduler_params.get('lr_min', 0.0) or 0.0)
    if scheduler == 'multi_step_lr':
        return multi_step_lr(lr, scheduler_params['milestones'], scheduler_params['gamma'])
    if scheduler == 'step_lr':
        return step_lr(lr, scheduler_params['step_size'], scheduler_params['gamma'])
    if scheduler == 'custom_dasr':
        return custom_dasr(lr)
    raise RuntimeError('%s scheduler not implemented' % scheduler)
