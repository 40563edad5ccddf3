"""Weights bridge: sisr_tpu (Flax) parameter trees <-> this package's torch state_dicts.

* :func:`state_dict_from_jax` is the inverse of sisr_tpu's ``tools/convert_weights.py``
  for the families ported so far: flax Conv kernels (kH, kW, I, O) become torch Conv2d
  weights (O, I, kH, kW), and the Dense layers that sisr_tpu runs on pooled vectors
  (I, O) become 1x1 convs (O, I, 1, 1).  The param tree is read as nested dicts of
  array-likes (pass numpy arrays); every leaf must be consumed and every key the
  model needs must be present, else it raises.
* :func:`params_from_state_dict` reads a port model's state_dict back in sisr_tpu's
  tree naming and HWIO layout: the form the int8 recipes of ``ops/quantization.py``
  take.
* :func:`int8_state_from_jax` carries sisr_tpu's quantised RCAN tree and activation
  scales across, so both packages can run the same int8 state.
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


def _rcan_layout(n_groups, n_blocks, n_stages):
    """(sisr_tpu path, torch key, kind) of every RCAN layer; kind is 'conv' (flax Conv)
    or 'dense' (a flax Dense on the pooled vector, a 1x1 conv in torch)."""
    yield ('head',), 'head.0', 'conv'
    for g in range(n_groups):
        for b in range(n_blocks):
            src, dst = ('group_%d' % g, 'rcab_%d' % b), 'body.%d.body.%d.body' % (g, b)
            yield src + ('conv_0',), dst + '.0', 'conv'
            yield src + ('conv_1',), dst + '.2', 'conv'
            yield src + ('ca', 'du_0'), dst + '.3.conv_du.0', 'dense'
            yield src + ('ca', 'du_1'), dst + '.3.conv_du.2', 'dense'
        yield ('group_%d' % g, 'conv_tail'), 'body.%d.body.%d' % (g, n_blocks), 'conv'
    yield ('body_tail',), 'body.%d' % n_groups, 'conv'
    for i in range(n_stages):
        yield ('upsampler', 'conv_%d' % i), 'tail.0.%d' % (2 * i), 'conv'
    yield ('tail',), 'tail.1', 'conv'


def _rcan(tree):
    # a gap in the numbering surfaces as a missing or an unconsumed leaf
    n_groups = len({p[0] for p in tree.leaves if p[0].startswith('group_')})
    n_blocks = len({p[1] for p in tree.leaves
                    if p[0] == 'group_0' and p[1].startswith('rcab_')})
    n_stages = len({p[1] for p in tree.leaves if p[0] == 'upsampler'})
    sd = {}
    for path, key, kind in _rcan_layout(n_groups, n_blocks, n_stages):
        w = tree(*path, 'kernel')
        # flax Conv (kH, kW, I, O) -> (O, I, kH, kW); Dense (I, O) -> (O, I, 1, 1)
        sd[key + '.weight'] = (w.transpose(3, 2, 0, 1) if kind == 'conv'
                               else w.T.reshape(w.shape[1], w.shape[0], 1, 1))
        sd[key + '.bias'] = tree(*path, 'bias')
    return sd


def _rcan_params(state_dict):
    """The inverse of :func:`_rcan` on torch tensors (views, no copies)."""
    def count(key_of):
        n = 0
        while key_of(n) in state_dict:
            n += 1
        return n
    n_groups = count(lambda g: 'body.%d.body.0.body.0.weight' % g)
    n_blocks = count(lambda b: 'body.0.body.%d.body.0.weight' % b)
    n_stages = count(lambda i: 'tail.0.%d.weight' % (2 * i))
    params, used = {}, set()
    for path, key, kind in _rcan_layout(n_groups, n_blocks, n_stages):
        w = state_dict[key + '.weight']
        node = params
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = {'kernel': w.permute(2, 3, 1, 0) if kind == 'conv'
                          else w.reshape(w.shape[0], w.shape[1]).t(),
                          'bias': state_dict[key + '.bias']}
        used.update((key + '.weight', key + '.bias'))
    return params, used


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


def params_from_state_dict(model_name, state_dict):
    """A port model's ``state_dict`` (torch layout) as sisr_tpu's parameter tree:
    nested dicts of tensors, conv kernels HWIO and Dense kernels (I, O), as views of
    the state_dict's tensors (on their device)."""
    if model_name not in PARAM_READERS:
        raise NotImplementedError('No torch -> sisr_tpu tree reader for %r yet '
                                  '(available: %s)' % (model_name, sorted(PARAM_READERS)))
    params, used = PARAM_READERS[model_name](state_dict)
    leftovers = sorted(set(state_dict) - used)
    if leftovers:
        raise RuntimeError('state_dict for %r left %d key(s) unread (e.g. %s)'
                           % (model_name, len(leftovers), leftovers[:4]))
    return params


PARAM_READERS = {'rcan': _rcan_params}


def int8_state_from_jax(qparams, act_scales, device='cpu'):
    """sisr_tpu's quantised tree and activation scales (``quantize_rcan_params`` and
    ``calibrate_rcan_scales``, as numpy) -> the port's: the same tree of tensors on
    ``device``, each conv entry with its packed ``_int_mm`` matrix, and the scales as
    ``np.float32``."""
    from ..ops.quantization import pack_kernel_matrix

    def convert(node):
        if isinstance(node, dict) or hasattr(node, 'items'):
            out = {str(k): convert(v) for k, v in node.items()}
            if 'scale' in out and 'kernel' in out:
                out['matrix'] = pack_kernel_matrix(out['kernel'])
            return out
        return torch.from_numpy(np.array(node)).to(device)

    return convert(qparams), {str(k): np.float32(v) for k, v in act_scales.items()}
