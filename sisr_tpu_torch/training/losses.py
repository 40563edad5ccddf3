"""Training losses: L1 and MSE (PyTorch port of sisr_tpu's ``training/losses.py``).
The VGG perceptual loss is not ported yet."""
import torch


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def build_loss(loss_type='l1', perceptual=None):
    """A ``(pred, target) -> scalar`` loss; ``perceptual`` (the reference's VGG feature
    term) raises until its slice."""
    if perceptual is not None:
        raise NotImplementedError('The perceptual (VGG feature) loss is not ported to '
                                  'sisr_tpu_torch yet: it comes with the long-tail tools '
                                  'slice (ROADMAP.md, Queue 1 item 10).')
    return {'l1': l1_loss, 'mse': mse_loss}[loss_type]
