"""Training losses: L1, MSE and the VGG perceptual mechanism (PyTorch port of
sisr_tpu's ``training/losses.py``, ref: Code/sr_tools/loss_functions.py
PerceptualMechanism = lambda_pixel * L1(pixel) + lambda_per * L1(VGG54 features))."""
import torch


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def build_loss(loss_type='l1', perceptual=None, vgg_apply=None, lambda_pixel=1.0):
    """A ``(pred, target) -> scalar`` loss.

    :param perceptual: lambda of the VGG feature term (the reference's ``perceptual``
        internal_param, loss_functions.py:6-22); needs ``vgg_apply``.
    :param vgg_apply: ``(N, H, W, 3) -> features`` with frozen weights, from
        :func:`sisr_tpu_torch.models.feature_extractors.load_vgg_extractor`; it runs in
        float32 (a bf16 prediction is cast up), as sisr_tpu's does.  The target's
        features take no grad.  The loss keeps it as ``vgg_apply``.
    """
    base = {'l1': l1_loss, 'mse': mse_loss}[loss_type]
    if perceptual is None:
        return base

    if loss_type != 'l1':
        # reference parity: PerceptualMechanism replaces the criterion and its pixel
        # term is always L1 (ref loss_functions.py:6-22)
        print("Warning: perceptual loss overrides the configured '%s' pixel "
              "criterion with L1 (reference PerceptualMechanism semantics)."
              % loss_type)

    if vgg_apply is None:
        raise RuntimeError('Perceptual loss requested but no VGG feature extractor is '
                           'available (provide pretrained weights with vgg_weights — see '
                           'sisr_tpu_torch/models/feature_extractors.py).')

    def loss(pred, target):
        gen = vgg_apply(pred)
        with torch.no_grad():
            real = vgg_apply(target)
        return lambda_pixel * l1_loss(pred, target) + perceptual * l1_loss(gen, real)

    loss.vgg_apply = vgg_apply
    return loss
