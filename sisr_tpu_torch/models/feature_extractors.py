"""Feature extractors for the perceptual loss and the FACE_SIM metric (PyTorch port of
sisr_tpu's ``models/feature_extractors.py``, ref:
Code/SISR/models/feature_extractors/{VGGNets.py,lightCNN.py,handlers.py}).

The modules keep the torch checkpoint layouts, so they load those files as they are:
torchvision's VGG19 (``features.N.*``), LightCNN-29's (``{'state_dict': {'module.…'}}``
with ``*.filter`` names) and ``vgg_face_dag``'s (``conv1_1`` … ``fc8``).  No weights are
fetched and none are made up: every loader fails without a weights file (a randomly
initialised extractor would train or score silently wrong).

Every extractor takes (N, H, W, 3) float images in [0, 1] (sisr_tpu's NHWC layout),
runs in float32 on the device its weights were placed on, with frozen weights
(``requires_grad=False``, ``eval()``).
"""
import os

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.helpers import resolve_device

# VGG19 convolutional configuration (channels per conv, 'M' = maxpool)
_VGG19_CFG = [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
              512, 512, 512, 512, 'M', 512, 512, 512, 512, 'M']
_VGG_MEAN = (0.485, 0.456, 0.406)
_VGG_STD = (0.229, 0.224, 0.225)


class VGG19Features(nn.Module):
    """VGG19 feature trunk up to ``feature_layer`` (torchvision's index; 35 stops
    after conv5_4, before its ReLU: the reference's VGG54 perceptual-loss tap,
    VGGNets.py:118-131), after torchvision's input normalisation.  NCHW in and out."""

    def __init__(self, feature_layer=35):
        super().__init__()
        layers, in_ch = [], 3
        for v in _VGG19_CFG:
            if len(layers) >= feature_layer:
                break
            if v == 'M':
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers.append(nn.Conv2d(in_ch, v, 3, padding=1))
            if len(layers) < feature_layer:
                layers.append(nn.ReLU())
            in_ch = v
        self.features = nn.Sequential(*layers)
        self.register_buffer('mean', torch.tensor(_VGG_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer('std', torch.tensor(_VGG_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x):
        return self.features((x - self.mean) / self.std)


def _frozen(module, device):
    """``module`` on ``device``, in eval mode, with no parameter requiring a grad."""
    module.to(device).eval()
    for p in module.parameters():
        p.requires_grad_(False)
    return module


def _nhwc_call(module):
    """``(N, H, W, C) -> (N, H', W', C')`` through an NCHW ``module``, in float32 with
    autocast off (the compute type of sisr_tpu's extractors)."""
    def apply_fn(x):
        with torch.autocast(x.device.type, enabled=False):
            return module(x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    apply_fn.module = module
    return apply_fn


def load_vgg_extractor(weights_path=None, feature_layer=35, device=None):
    """A ``(N, H, W, 3) -> (N, H', W', 512)`` VGG19 feature fn on ``device`` (default:
    cuda) from a torchvision state_dict file, or None when no file exists (the
    caller's perceptual loss then refuses, as in sisr_tpu)."""
    if weights_path is None or not os.path.isfile(weights_path):
        return None
    device = resolve_device(device)
    state_dict = torch.load(weights_path, map_location='cpu', weights_only=True)
    module = VGG19Features(feature_layer=feature_layer)
    wanted = module.state_dict()
    module.load_state_dict({k: v for k, v in state_dict.items() if k in wanted})
    return _nhwc_call(_frozen(module, device))


def perceptual_loss_mechanism(name, mode='recognition', weights_path=None, device=None):
    """Dispatcher kept for the reference's API (ref: feature_extractors/handlers.py:5-14):
    the loaded VGG19 trunk for ('vgg', 'p_loss'), a face embedding fn for 'vggface' or
    'lightcnn' in 'recognition' mode."""
    if name == 'vgg' and mode == 'p_loss':
        apply_fn = load_vgg_extractor(weights_path, device=device)
        if apply_fn is None:
            raise RuntimeError('VGG19 weights unavailable — supply weights_path '
                               '(a torchvision state_dict file).')
        return apply_fn
    if name in ('vggface', 'lightcnn'):
        if mode != 'recognition':
            raise NotImplementedError(
                'Feature extractor %s/%s: only recognition-mode embeddings are '
                'wired to weights here (FACE_SIM); construct the module classes '
                'directly for other taps.' % (name, mode))
        return load_face_extractor(name, weights_path, device=device)
    raise NotImplementedError('Feature extractor %s/%s not implemented' % (name, mode))


# --- face feature extractors (ref: feature_extractors/{lightCNN,VGGNets}.py) -------------
class _MFM(nn.Module):
    """Max-feature-map (ref: lightCNN.py:8-20): a conv (or, ``linear``, a Linear) to
    twice the features, then the max of the two halves of the channels."""

    def __init__(self, in_channels, out_channels, kernel_size=3, padding=1, linear=False):
        super().__init__()
        self.out_channels = out_channels
        self.filter = nn.Linear(in_channels, 2 * out_channels) if linear else \
            nn.Conv2d(in_channels, 2 * out_channels, kernel_size, padding=padding)

    def forward(self, x):
        a, b = torch.split(self.filter(x), self.out_channels, 1)
        return torch.max(a, b)


class _Group(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv_a = _MFM(in_channels, in_channels, 1, padding=0)
        self.conv = _MFM(in_channels, out_channels, 3, padding=1)

    def forward(self, x, return_pair=False):
        a = self.conv_a(x)
        b = self.conv(a)
        return (a, b) if return_pair else b


class _ResBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv1 = _MFM(channels, channels)
        self.conv2 = _MFM(channels, channels)

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


class LightCNN29(nn.Module):
    """LightCNN 29-layer face network (ref: lightCNN.py:52-122, ``network_29layers``),
    with the reference's parameter names.  Grayscale (N, 1, 128, 128) in;
    ``extract_features`` returns group4's feature pair, ``embedding_only`` (None, the
    256-d fc), otherwise (logits, fc).  ``num_classes=None`` builds no ``fc2`` (the
    79077-class head FACE_SIM never uses)."""

    def __init__(self, num_classes=79077):
        super().__init__()
        self.conv1 = _MFM(1, 48, 5, padding=2)
        self.block1 = nn.Sequential(*[_ResBlock(48) for _ in range(1)])
        self.group1 = _Group(48, 96)
        self.block2 = nn.Sequential(*[_ResBlock(96) for _ in range(2)])
        self.group2 = _Group(96, 192)
        self.block3 = nn.Sequential(*[_ResBlock(192) for _ in range(3)])
        self.group3 = _Group(192, 128)
        self.block4 = nn.Sequential(*[_ResBlock(128) for _ in range(4)])
        self.group4 = _Group(128, 128)
        self.fc = _MFM(8 * 8 * 128, 256, linear=True)
        self.fc2 = nn.Linear(256, num_classes) if num_classes else None

    @staticmethod
    def _pool(x):
        return F.max_pool2d(x, 2, 2, ceil_mode=True)

    def forward(self, x, extract_features=False, embedding_only=False):
        x = self._pool(self.conv1(x))
        x = self._pool(self.group1(self.block1(x)))
        x = self._pool(self.group2(self.block2(x)))
        x = self.block4(self.group3(self.block3(x)))
        if extract_features:
            return self.group4(x, return_pair=True)
        x = self._pool(self.group4(x)).flatten(1)
        fc = self.fc(x)
        if embedding_only or self.fc2 is None:
            return None, fc
        return self.fc2(fc), fc


class VggFace(nn.Module):
    """VGG-Face descriptor network (ref: VGGNets.py:9-114), with ``vgg_face_dag``'s
    names.  ``mode`` 'p_loss' returns conv5_3 before its ReLU, 'recognition' fc7's
    features, anything else the class softmax.  Input (N, 3, H, W), VGG-Face
    mean-subtracted on the 0-255 scale (224^2 for the fc layers)."""

    MEAN = (129.186279296875, 104.76238250732422, 93.59396362304688)
    _CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self, mode='recognition'):
        super().__init__()
        self.mode = mode
        in_ch = 3
        for block, (features, n_convs) in enumerate(self._CFG, 1):
            for i in range(1, n_convs + 1):
                setattr(self, 'conv%d_%d' % (block, i), nn.Conv2d(in_ch, features, 3,
                                                                  padding=1))
                in_ch = features
        self.fc6 = nn.Linear(512 * 7 * 7, 4096)
        self.fc7 = nn.Linear(4096, 4096)
        self.fc8 = nn.Linear(4096, 2622)

    def forward(self, x):
        for block, (_, n_convs) in enumerate(self._CFG, 1):
            for i in range(1, n_convs + 1):
                x = getattr(self, 'conv%d_%d' % (block, i))(x)
                if block == 5 and i == n_convs and self.mode == 'p_loss':
                    return x
                x = F.relu(x)
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.fc6(x.flatten(1)))
        x = F.relu(self.fc7(x))
        if self.mode == 'recognition':
            return x
        return F.softmax(self.fc8(x), dim=-1)


def _strip_module_prefix(state_dict):
    return {(k[7:] if k.startswith('module.') else k): v for k, v in state_dict.items()}


def _bicubic_nchw(x, size):
    """torch's bicubic (``F.interpolate``, align_corners=False, no antialias): the
    reference's face preprocess (lightCNN.py:119), which sisr_tpu's
    ``interpolate_bicubic_torch`` emulates."""
    if tuple(x.shape[2:]) == (size, size):
        return x
    return F.interpolate(x, size=(size, size), mode='bicubic', align_corners=False)


def load_face_extractor(name, weights_path=None, device=None):
    """A face-embedding fn ``(N, H, W, 3) float [0, 1] -> (N, D)`` on ``device``
    (default: cuda), in float32:

    * ``'lightcnn'``: bicubic to 128^2, BT.601 luma, LightCNN29's 256-d fc (ref:
      lightCNN.py:117-121); ``fc2`` is not loaded;
    * ``'vggface'``: bicubic to 224^2, x255 minus the VGG-Face mean, fc7's 4096-d
      features ('recognition' mode, ref: VGGNets.py:110-111).

    Weights default to the reference's external-package paths
    (``configuration/constants.py``); a missing file raises."""
    from ..configuration import constants as sconst
    device = resolve_device(device)
    if weights_path is None:
        weights_path = {'lightcnn': sconst.lightcnn_weights,
                        'vggface': sconst.vggface_weights}[name]
    if not os.path.isfile(weights_path):
        raise RuntimeError('No %s weights at %s — download the reference external '
                           'package or pass face_weights.' % (name, weights_path))
    raw = torch.load(weights_path, map_location='cpu', weights_only=True)
    if isinstance(raw, dict) and 'state_dict' in raw:
        raw = raw['state_dict']
    sd = _strip_module_prefix(raw)

    if name == 'lightcnn':
        module = LightCNN29(num_classes=None)
        module.load_state_dict({k: v for k, v in sd.items() if not k.startswith('fc2.')})
        module = _frozen(module, device)
        luma = torch.tensor([0.299, 0.587, 0.114], device=device).view(1, 3, 1, 1)

        def embed(x):
            with torch.autocast(device.type, enabled=False):
                x = _bicubic_nchw(x.float().permute(0, 3, 1, 2), 128)
                return module((x * luma).sum(dim=1, keepdim=True), embedding_only=True)[1]
    elif name == 'vggface':
        module = VggFace(mode='recognition')
        module.load_state_dict(sd)
        module = _frozen(module, device)
        mean = torch.tensor(VggFace.MEAN, device=device).view(1, 3, 1, 1)

        def embed(x):
            with torch.autocast(device.type, enabled=False):
                x = _bicubic_nchw(x.float().permute(0, 3, 1, 2), 224)
                return module(x * 255.0 - mean)
    else:
        raise NotImplementedError('Unknown face extractor %r' % name)
    embed.module = module
    embed.device = device
    return embed
