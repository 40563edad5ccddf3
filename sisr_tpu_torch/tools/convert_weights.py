"""Weights bridge: sisr_tpu (Flax) parameter trees -> this package's torch state_dicts.

The inverse of sisr_tpu's ``tools/convert_weights.py`` for the families ported so far:
flax Conv kernels (kH, kW, I, O) become torch Conv2d weights (O, I, kH, kW), and the
Dense layers that sisr_tpu runs on pooled vectors (I, O) become 1x1 convs (O, I, 1, 1).
The param tree is read as nested dicts of array-likes (pass numpy arrays); every leaf
must be consumed and every key the model needs must be present, else it raises.
"""
import numpy as np
import torch


class _TrackingTree:
    """Leaf access over a nested param dict that records which leaves were read."""

    def __init__(self, params):
        self.leaves = {}

        def walk(node, path):
            if isinstance(node, dict) or hasattr(node, 'items'):
                for k, v in node.items():
                    walk(v, path + (str(k),))
            else:
                self.leaves[path] = np.asarray(node)
        walk(params, ())
        self.accessed = set()

    def __call__(self, *path):
        if path not in self.leaves:
            raise KeyError('sisr_tpu params lack %s: the model structure does not match'
                           % '/'.join(path))
        self.accessed.add(path)
        return self.leaves[path]

    def unconsumed(self):
        return sorted('/'.join(p) for p in self.leaves if p not in self.accessed)


def _conv(tree, sd, path, key):
    sd[key + '.weight'] = tree(*path, 'kernel').transpose(3, 2, 0, 1)
    sd[key + '.bias'] = tree(*path, 'bias')


def _dense_as_conv1x1(tree, sd, path, key):
    w = tree(*path, 'kernel')  # (I, O)
    sd[key + '.weight'] = w.T.reshape(w.shape[1], w.shape[0], 1, 1)
    sd[key + '.bias'] = tree(*path, 'bias')


def _rcan(tree):
    sd = {}
    groups = sorted(int(p[0].split('_')[1]) for p in tree.leaves
                    if p[0].startswith('group_') and p[1] == 'conv_tail' and p[2] == 'kernel')
    stages = sorted(int(p[1].split('_')[1]) for p in tree.leaves
                    if p[0] == 'upsampler' and p[2] == 'kernel')
    _conv(tree, sd, ('head',), 'head.0')
    for g in groups:
        blocks = sorted(int(p[1].split('_')[1]) for p in tree.leaves
                        if p[0] == 'group_%d' % g and p[1].startswith('rcab_')
                        and p[2:] == ('conv_0', 'kernel'))
        for b in blocks:
            src, dst = ('group_%d' % g, 'rcab_%d' % b), 'body.%d.body.%d.body' % (g, b)
            _conv(tree, sd, src + ('conv_0',), dst + '.0')
            _conv(tree, sd, src + ('conv_1',), dst + '.2')
            _dense_as_conv1x1(tree, sd, src + ('ca', 'du_0'), dst + '.3.conv_du.0')
            _dense_as_conv1x1(tree, sd, src + ('ca', 'du_1'), dst + '.3.conv_du.2')
        _conv(tree, sd, ('group_%d' % g, 'conv_tail'), 'body.%d.body.%d' % (g, len(blocks)))
    _conv(tree, sd, ('body_tail',), 'body.%d' % len(groups))
    for i in stages:
        _conv(tree, sd, ('upsampler', 'conv_%d' % i), 'tail.0.%d' % (2 * i))
    _conv(tree, sd, ('tail',), 'tail.1')
    return sd


CONVERTERS = {'rcan': _rcan}


def state_dict_from_jax(model_name, params):
    """sisr_tpu params of ``model_name`` -> a torch state_dict for this package's
    model of the same structure (float32 CPU tensors, reference key names)."""
    if model_name not in CONVERTERS:
        raise NotImplementedError('No sisr_tpu -> torch converter for %r yet (available: %s)'
                                  % (model_name, sorted(CONVERTERS)))
    tree = _TrackingTree(params)
    sd = CONVERTERS[model_name](tree)
    leftovers = tree.unconsumed()
    if leftovers:
        raise RuntimeError('sisr_tpu params for %r left %d leaf(s) unconsumed (e.g. %s): '
                           'the converter and the model structure disagree'
                           % (model_name, len(leftovers), leftovers[:4]))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}
