"""Weights bridge: sisr_tpu (Flax) parameter trees <-> this package's torch state_dicts.

* :func:`state_dict_from_jax` is the inverse of sisr_tpu's ``tools/convert_weights.py``
  for every family (SRCNN, VDSR, RCAN, EDSR, QRCAN and its alias qpircan, QEDSR, HAN,
  QHAN, SAN, QSAN, SRMD, SFTMD, SPARNet, QSPARNet): flax Conv kernels (kH, kW, I, O)
  become torch Conv2d weights (O, I, kH, kW), the Dense layers that sisr_tpu runs on pooled or metadata
  vectors (I, O) become 1x1 convs (O, I, 1, 1), and HAN's CSAM kernel (DHWIO over
  (C, H, W)) becomes the Conv3d weight (O, I, D, H, W); LAM's and CSAM's ``gamma``,
  CSAM's bias and SAN's ``gamma`` pass as they are.  Each family's layout lists every
  layer once, for both directions.  SPARNet and QSPARNet take sisr_tpu's full
  variables, ``{'params', 'batch_stats'}``, and are walked key by key as sisr_tpu's
  ``convert_sparnet`` walks them (:func:`sparnet_state_dict_from_jax`): bias-free
  convs, BatchNorm scales and running statistics, the PReLU slopes and the
  ParaCALayers.
  The param tree is read as nested dicts of array-likes (pass numpy arrays); every
  leaf must be consumed and every key the model needs must be present, else it
  raises.
* :func:`params_from_state_dict` reads a port model's state_dict back in sisr_tpu's
  tree naming and HWIO layout: the form the int8 recipes of ``ops/quantization.py``
  take.  It also reads a reference checkpoint's ``network``
  (:func:`repair_reference_keys`): the parameters a reference SAN or Q-SAN registers
  and never uses are dropped, an aged SFTMD checkpoint's SFT keys are renamed, and
  any other unread key raises.  SRMD's KAIR keys (``model.<2i>``) are read as they
  are: no ``model.`` prefix is ever stripped.  :func:`variables_from_state_dict` gives
  sisr_tpu's full variables: SPARNet's and QSPARNet's BatchNorm running statistics as
  ``batch_stats``.
* :func:`int8_state_from_jax` carries sisr_tpu's quantised trees and activation
  scales (RCAN, EDSR, QRCAN, QEDSR, HAN, QHAN, SAN, QSAN, SRMD, SFTMD, VDSR) across,
  so both packages can run the same int8 state.
"""
import re

import numpy as np
import torch

# the parameters a reference checkpoint carries and its forward never uses (ref:
# SAN_blocks.py:309, :377; architectures.py): SAN's and Q-SAN's top-level conv_last,
# each group's gamma and the non-local wrapper's SOCA.  Each pattern names those keys
# alone, so a stray key under a live SOCA (RG.<g>.soca.*) is still unread and raises.
DEAD_REFERENCE_KEYS = {
    'san': (r'^conv_last\.(weight|bias)$', r'^RG\.\d+\.gamma$',
            r'^non_local\.soca\.conv_du\.[02]\.(weight|bias)$'),
}
DEAD_REFERENCE_KEYS['qsan'] = DEAD_REFERENCE_KEYS['san']


def drop_dead_reference_keys(model_name, state_dict):
    """``state_dict`` without the keys of ``DEAD_REFERENCE_KEYS[model_name]`` (the same
    dict when the family has none)."""
    dead = [re.compile(p) for p in DEAD_REFERENCE_KEYS.get(model_name, ())]
    if not dead:
        return state_dict
    return {k: v for k, v in state_dict.items() if not any(d.search(k) for d in dead)}


def sftmd_aged_keys(state_dict):
    """An aged SFTMD checkpoint's keys as today's (sisr_tpu's ``sftmd_legacy_switch``;
    ref: SFTMD_variants/handlers.py:41-60): the dead ``sft_branch`` entries dropped, and
    the SFT layers' keys before the ``sft_module`` nesting (``sft1.``, ``sft2.``,
    ``sft.``) nested.  Today's keys pass as they are."""
    new = {}
    for k, v in state_dict.items():
        if 'sft_branch' in k:
            continue
        if 'sft_module' in k:
            new[k] = v
        elif 'sft1' in k or 'sft2' in k:
            new[k.replace('sft1', 'sft1.sft_module').replace('sft2', 'sft2.sft_module')] = v
        elif k[:4] == 'sft.':
            new[k.replace('sft.', 'sft.sft_module.')] = v
        else:
            new[k] = v
    return new


# a family's renames of an aged reference checkpoint's keys
AGED_KEY_REPAIRS = {'sftmd': sftmd_aged_keys}


def repair_reference_keys(model_name, state_dict):
    """A reference checkpoint's ``network`` as the port's model names it: the dead
    keys dropped (:func:`drop_dead_reference_keys`) and aged keys renamed
    (``AGED_KEY_REPAIRS``)."""
    state_dict = drop_dead_reference_keys(model_name, state_dict)
    repair = AGED_KEY_REPAIRS.get(model_name)
    return state_dict if repair is None else repair(state_dict)


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


def _count(present):
    """How many of present(0), present(1), ... hold, from 0 up."""
    n = 0
    while present(n):
        n += 1
    return n


def _upsampler_tail(n_stages):
    for i in range(n_stages):
        yield ('upsampler', 'conv_%d' % i), 'tail.0.%d' % (2 * i), 'conv'
    yield ('tail',), 'tail.1', 'conv'


def _han_fusion(n_stages):
    """(path, key, kind) of HAN's and QHAN's layers after the body tail: the leaves of
    LAM and CSAM ('leaf': one tensor as it is; 'conv3d': CSAM's kernel), the two
    fusion convs, the upsampler and the tail."""
    yield ('la', 'gamma'), 'la.gamma', 'leaf'
    yield ('csa', 'conv3d_kernel'), 'csa.conv.weight', 'conv3d'
    yield ('csa', 'conv3d_bias'), 'csa.conv.bias', 'leaf'
    yield ('csa', 'gamma'), 'csa.gamma', 'leaf'
    yield ('last_conv',), 'last_conv', 'conv'
    yield ('last',), 'last', 'conv'
    yield from _upsampler_tail(n_stages)


def _rcan_layout(n_groups, n_blocks, n_stages, han=False):
    """(sisr_tpu path, torch key, kind) of every RCAN layer, or with ``han`` every HAN
    layer (RCAN's body, then :func:`_han_fusion`); kind is 'conv' (flax Conv) or
    'dense' (a flax Dense on the pooled vector, a 1x1 conv in torch)."""
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
    yield from _han_fusion(n_stages) if han else _upsampler_tail(n_stages)


def _edsr_layout(n_blocks, n_stages):
    """(path, key, kind) of every EDSR layer (sisr_tpu's ``convert_edsr`` naming)."""
    yield ('head',), 'head.0', 'conv'
    for i in range(n_blocks):
        yield ('block_%d' % i, 'conv_0'), 'body.%d.body.0' % i, 'conv'
        yield ('block_%d' % i, 'conv_1'), 'body.%d.body.2' % i, 'conv'
    yield ('body_tail',), 'body.%d' % n_blocks, 'conv'
    yield from _upsampler_tail(n_stages)


# the parts a QRCAB may have, and a torch key that only that part has
_QRCAB_PARTS = {'pa_node': '.pa_node.pa.0.weight',
                'q_node': '.q_node.attribute_integrator.0.weight',
                'pre_concat': '.final_body.pre_concat.weight',  # style mini_concat
                'feature_0': '.final_body.feature_convs.0.0.weight'}  # extended_attention


def _qrcan_layout(n_groups, n_blocks, n_stages, has, han=False):
    """(path, key, kind) of every QRCAN layer (sisr_tpu's ``convert_qrcan`` naming), or
    with ``han`` every QHAN layer (``convert_qhan``: the body tail is ``body_tail``,
    torch ``body.<n_groups>``, then :func:`_han_fusion`); ``has(g, b, part)`` says
    whether block b of group g has a part of ``_QRCAB_PARTS``, which also tells the
    QCALayer's style."""
    yield ('head',), 'head.0', 'conv'
    for g in range(n_groups):
        for b in range(n_blocks):
            src, dst = ('group_%d' % g, 'qrcab_%d' % b), 'body.%d.body.%d' % (g, b)
            yield src + ('conv_0',), dst + '.body.0', 'conv'
            yield src + ('conv_1',), dst + '.body.2', 'conv'
            qca, ca = src + ('qca',), dst + '.final_body'
            if has(g, b, 'pre_concat'):
                yield qca + ('pre_concat',), ca + '.pre_concat', 'dense'
                yield qca + ('du_1',), ca + '.conv_du.1', 'dense'
            elif has(g, b, 'feature_0'):
                for i in range(3):
                    yield qca + ('feature_%d' % i,), ca + '.feature_convs.%d.0' % i, 'dense'
                yield qca + ('final',), ca + '.final_conv.0', 'dense'
            else:  # modulate, standard, max_concat, softmax
                yield qca + ('du_0',), ca + '.conv_du.0', 'dense'
                yield qca + ('du_1',), ca + '.conv_du.2', 'dense'
            if has(g, b, 'pa_node'):
                yield src + ('pa_node', 'pa_0'), dst + '.pa_node.pa.0', 'conv'
                yield src + ('pa_node', 'pa_1'), dst + '.pa_node.pa.2', 'conv'
            if has(g, b, 'q_node'):  # ParaCALayer, two layers with a ReLU between
                for i in range(2):
                    yield (src + ('q_node', 'fc_%d' % i),
                           dst + '.q_node.attribute_integrator.%d' % (2 * i), 'dense')
        yield ('group_%d' % g, 'final_body'), 'body.%d.final_body' % g, 'conv'
    if han:
        yield ('body_tail',), 'body.%d' % n_groups, 'conv'
        yield from _han_fusion(n_stages)
    else:
        yield ('final_body',), 'final_body', 'conv'
        yield from _upsampler_tail(n_stages)


def _qedsr_layout(n_blocks, n_stages, nonlinearity):
    """(path, key, kind) of every QEDSR layer (sisr_tpu's ``convert_qedsr`` naming).
    Each block's ParaCALayer has two layers; with ``nonlinearity`` a ReLU sits between
    them and shifts the second one's index in ``attribute_integrator``."""
    yield ('head',), 'head', 'conv'
    for i in range(n_blocks):
        src, dst = ('block_%d' % i,), 'body.%d' % i
        yield src + ('conv_0',), dst + '.body.0', 'conv'
        yield src + ('conv_1',), dst + '.body.2', 'conv'
        for k in range(2):
            yield (src + ('attention', 'fc_%d' % k),
                   dst + '.attention_layer.attribute_integrator.%d'
                   % (k * (2 if nonlinearity else 1)), 'dense')
    yield ('final_body',), 'final_body', 'conv'
    yield from _upsampler_tail(n_stages)


def _san_layout(n_groups, n_blocks, n_stages, q=False):
    """(path, key, kind) of every SAN layer (sisr_tpu's ``convert_san`` naming), or with
    ``q`` every QSAN layer (``convert_qsan``: each block a ``qrb_<b>`` with its
    ParaCALayer ``q_layer``, two layers with a ReLU between)."""
    yield ('head',), 'head.0', 'conv'
    yield ('gamma',), 'gamma', 'leaf'
    for part, key in (('g', 'g.0'), ('theta', 'theta'), ('phi', 'phi.0'), ('w', 'W')):
        yield ('non_local', 'non_local', part), 'non_local.non_local.' + key, 'conv'
    for g in range(n_groups):
        for b in range(n_blocks):
            src = ('rg_%d' % g, ('qrb_%d' if q else 'rb_%d') % b)
            dst = 'RG.%d.rcab.%d' % (g, b)
            yield src + ('conv_0',), dst + '.conv_first.0', 'conv'
            yield src + ('conv_1',), dst + '.conv_first.2', 'conv'
            if q:
                for i in range(2):
                    yield (src + ('q_layer', 'fc_%d' % i),
                           dst + '.q_layer.attribute_integrator.%d' % (2 * i), 'dense')
        yield ('rg_%d' % g, 'soca', 'du_0'), 'RG.%d.soca.conv_du.0' % g, 'dense'
        yield ('rg_%d' % g, 'soca', 'du_1'), 'RG.%d.soca.conv_du.2' % g, 'dense'
        yield ('rg_%d' % g, 'conv_last'), 'RG.%d.conv_last' % g, 'conv'
    yield from _upsampler_tail(n_stages)


def _srmd_layout(n_convs):
    """(path, key, kind) of every SRMD conv (sisr_tpu's ``convert_srmd`` naming): KAIR's
    Sequential ``model``, conv i at index 2i."""
    for i in range(n_convs):
        name = 'conv_tail' if i == n_convs - 1 else 'conv_%d' % i
        yield (name,), 'model.%d' % (2 * i), 'conv'


def _sft_layout(src, dst, sft_type):
    """(path, key, kind) of one SFT layer's ``sft_module`` (none for ``weak`` and
    ``none``, which have no parameters)."""
    convs = {'standard': ('mul_conv1', 'mul_conv2', 'add_conv1', 'add_conv2'),
             'concat': ('conv',)}.get(sft_type, ())
    for name in convs:
        yield src + ('sft_module', name), dst + '.sft_module.' + name, 'conv'


def _para_ca_layout(src, dst, n_layers):
    """A ParaCALayer with a ReLU between its layers: layer k at index 2k."""
    for k in range(n_layers):
        yield src + ('fc_%d' % k,), '%s.attribute_integrator.%d' % (dst, 2 * k), 'dense'


def _sftmd_layout(n_blocks, sft_type, q_layers, four_x):
    """(path, key, kind) of every SFTMD layer (sisr_tpu's ``convert_sftmd`` naming);
    ``q_layers`` 0 without q-injection; ``four_x``: two upscale convs."""
    for name in ('conv1', 'conv2', 'conv3'):
        yield (name,), name, 'conv'
    for i in range(1, n_blocks + 1):
        src, dst = ('sft_residual_%d' % i,), 'SFT-residual%d' % i
        yield src + ('conv1',), dst + '.conv1', 'conv'
        yield src + ('conv2',), dst + '.conv2', 'conv'
        for sft in ('sft1', 'sft2'):
            yield from _sft_layout(src + (sft,), '%s.%s' % (dst, sft), sft_type)
        for q in ('q_1', 'q_2') if q_layers else ():
            yield from _para_ca_layout(src + (q,), '%s.%s' % (dst, q), q_layers)
    yield from _sft_layout(('sft',), 'sft', sft_type)
    if q_layers:
        yield from _para_ca_layout(('final_injection',), 'final_injection', q_layers)
    yield ('conv_mid',), 'conv_mid', 'conv'
    yield ('up_conv1',), 'upscale.0', 'conv'
    if four_x:
        yield ('up_conv2',), 'upscale.3', 'conv'
    yield ('conv_output',), 'conv_output', 'conv'


def _basic_layout(n_convs):
    """(path, key, kind) of every SRCNN or VDSR conv (sisr_tpu's ``convert_srcnn``
    naming): the reference's ``layer_dict.conv_<i>``."""
    for i in range(n_convs):
        yield ('conv_%d' % i,), 'layer_dict.conv_%d' % i, 'conv'


def _tree_layout(model_name, tree, q_layer_nonlinearity=False):
    """The layout of the model whose sisr_tpu params ``tree`` holds; a gap in the
    numbering surfaces as a missing or an unconsumed leaf."""
    def count(prefix, *parent):
        return len({p[len(parent)] for p in tree.leaves if p[:len(parent)] == parent
                    and p[len(parent)].startswith(prefix)})
    n_stages = count('conv_', 'upsampler')
    if model_name in ('rcan', 'han'):
        return _rcan_layout(count('group_'), count('rcab_', 'group_0'), n_stages,
                            han=model_name == 'han')
    if model_name == 'edsr':
        return _edsr_layout(count('block_'), n_stages)
    if model_name == 'qedsr':
        return _qedsr_layout(count('block_'), n_stages, q_layer_nonlinearity)
    if model_name in ('san', 'qsan'):
        q = model_name == 'qsan'
        return _san_layout(count('rg_'), count('qrb_' if q else 'rb_', 'rg_0'), n_stages,
                           q=q)
    if model_name == 'srmd':
        return _srmd_layout(count('conv_'))
    if model_name in ('srcnn', 'vdsr'):
        return _basic_layout(count('conv_'))
    if model_name == 'sftmd':
        module = {p[3] for p in tree.leaves if p[:3] == ('sft_residual_1', 'sft1', 'sft_module')}
        sft_type = 'standard' if 'mul_conv1' in module else 'concat' if module else 'none'
        return _sftmd_layout(count('sft_residual_'), sft_type,
                             count('fc_', 'sft_residual_1', 'q_1'),
                             any(p[0] == 'up_conv2' for p in tree.leaves))

    def has(g, b, part):
        block = ('group_%d' % g, 'qrcab_%d' % b)
        prefix = block + (('qca', part) if part in ('pre_concat', 'feature_0') else (part,))
        return any(p[:len(prefix)] == prefix for p in tree.leaves)
    return _qrcan_layout(count('group_'), count('qrcab_', 'group_0'), n_stages, has,
                         han=model_name == 'qhan')


def _state_dict_layout(model_name, state_dict):
    """The layout of the port model whose ``state_dict`` this is."""
    n_stages = _count(lambda i: 'tail.0.%d.weight' % (2 * i) in state_dict)
    if model_name in ('rcan', 'han'):
        return _rcan_layout(_count(lambda g: 'body.%d.body.0.body.0.weight' % g in state_dict),
                            _count(lambda b: 'body.0.body.%d.body.0.weight' % b in state_dict),
                            n_stages, han=model_name == 'han')
    if model_name == 'edsr':
        return _edsr_layout(_count(lambda b: 'body.%d.body.0.weight' % b in state_dict),
                            n_stages)
    if model_name == 'qedsr':
        # with q_layer_nonlinearity a ReLU takes index 1 of every attribute_integrator
        return _qedsr_layout(
            _count(lambda b: 'body.%d.body.0.weight' % b in state_dict), n_stages,
            'body.0.attention_layer.attribute_integrator.2.weight' in state_dict)
    if model_name in ('san', 'qsan'):
        return _san_layout(
            _count(lambda g: 'RG.%d.conv_last.weight' % g in state_dict),
            _count(lambda b: 'RG.0.rcab.%d.conv_first.0.weight' % b in state_dict),
            n_stages, q=model_name == 'qsan')
    if model_name == 'srmd':
        return _srmd_layout(_count(lambda i: 'model.%d.weight' % (2 * i) in state_dict))
    if model_name in ('srcnn', 'vdsr'):
        return _basic_layout(_count(lambda i: 'layer_dict.conv_%d.weight' % i in state_dict))
    if model_name == 'sftmd':
        sft = 'SFT-residual1.sft1.sft_module.'
        sft_type = 'standard' if sft + 'mul_conv1.weight' in state_dict \
            else 'concat' if sft + 'conv.weight' in state_dict else 'none'
        return _sftmd_layout(
            _count(lambda i: 'SFT-residual%d.conv1.weight' % (i + 1) in state_dict),
            sft_type, _count(lambda k: 'SFT-residual1.q_1.attribute_integrator.%d.weight'
                             % (2 * k) in state_dict), 'upscale.3.weight' in state_dict)

    def has(g, b, part):
        return 'body.%d.body.%d%s' % (g, b, _QRCAB_PARTS[part]) in state_dict
    return _qrcan_layout(_count(lambda g: 'body.%d.final_body.weight' % g in state_dict),
                         _count(lambda b: 'body.0.body.%d.body.0.weight' % b in state_dict),
                         n_stages, has, han=model_name == 'qhan')


LAYOUT_MODELS = ('edsr', 'han', 'qedsr', 'qhan', 'qpircan', 'qrcan', 'qsan', 'rcan', 'san',
                 'sftmd', 'srcnn', 'srmd', 'vdsr')
# the families walked key by key, with BatchNorm running statistics
SPARNET_MODELS = ('qsparnet', 'sparnet')
# the reference's SPARNet Sequentials -> the prefix of sisr_tpu's blocks (<prefix>_<i>)
_SPAR_SECTIONS = {'encoder': 'encoder', 'res_layers': 'res', 'decoder': 'decoder'}
_SPAR_BLOCKS = {v: k for k, v in _SPAR_SECTIONS.items()}


def _sparnet_flax_path(key):
    """A SPARNet torch key -> (collection, sisr_tpu path, kind), or None for
    ``num_batches_tracked`` (flax keeps no count): sisr_tpu's ``convert_sparnet`` walk.
    Kinds: 'conv' (a conv's weight, HWIO), 'dense' (a ParaCALayer's 1x1 conv, (I, O)),
    'leaf' (as it is)."""
    parts = key.split('.')
    leaf = parts[-1]
    if leaf == 'num_batches_tracked':
        return None
    if parts[0] == 'out_conv':
        path, rest = ['out_conv'], parts[1:-1]
    else:
        path, rest = ['%s_%d' % (_SPAR_SECTIONS[parts[0]], int(parts[1]))], parts[2:-1]
    i = 0
    while i < len(rest):
        part = rest[i]
        if part == 'shortcut_func':
            path.append('shortcut')
        elif part == 'preact_func':  # Sequential(NormLayer, ReluLayer)
            path.append('preact_norm' if rest[i + 1] == '0' else 'preact_relu')
            i += 1
        elif part == 'out_block':  # Sequential(ConvLayer, Sigmoid)
            path.append('out_block')
            i += 1
        elif part == 'attribute_integrator':  # ParaCALayer: convs at 0, 2 (a ReLU at 1)
            path.append('fc_%d' % (int(rest[i + 1]) // 2))
            i += 1
        elif part != 'func':  # a ReluLayer's PReLU holds its slope
            path.append(part)
        i += 1
    if path[-1] in ('relu', 'preact_relu'):
        return 'params', tuple(path) + ('prelu',), 'leaf'
    if path[-1] == 'conv2d' or path[-1].startswith('fc_'):
        kind = ('conv' if path[-1] == 'conv2d' else 'dense') if leaf == 'weight' else 'leaf'
        return 'params', tuple(path) + ('kernel' if leaf == 'weight' else 'bias',), kind
    collection, name = {'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
                        'running_mean': ('batch_stats', 'mean'),
                        'running_var': ('batch_stats', 'var')}[leaf]
    return collection, tuple(path) + (name,), 'leaf'


def _sparnet_torch_key(path):
    """A sisr_tpu SPARNet path (within its collection) -> (torch key, kind): the
    inverse of :func:`_sparnet_flax_path`.  A norm's leaves sit under ``norm/norm``
    (flax's BatchNorm, GroupNorm, LayerNorm) or, for the ``in`` norm, on the NormLayer
    itself: both are the torch NormLayer's ``norm``."""
    block, *mods, leaf = path
    if block == 'out_conv':
        key = ['out_conv']
    else:
        prefix, _, index = block.rpartition('_')
        key = [_SPAR_BLOCKS[prefix], str(int(index))]
    for mod in mods:
        if mod == 'shortcut':
            key.append('shortcut_func')
        elif mod in ('preact_norm', 'preact_relu'):
            key += ['preact_func', '0' if mod == 'preact_norm' else '1']
        elif mod == 'out_block':
            key += ['out_block', '0']
        elif mod.startswith('fc_'):
            key += ['attribute_integrator', str(2 * int(mod[3:]))]
        else:
            key.append(mod)
    if leaf == 'prelu':
        return '.'.join(key + ['func', 'weight']), 'leaf'
    if mods[-1] == 'conv2d' or mods[-1].startswith('fc_'):
        name = {'kernel': 'weight', 'bias': 'bias'}[leaf]
        kind = ('conv' if mods[-1] == 'conv2d' else 'dense') if leaf == 'kernel' else 'leaf'
        return '.'.join(key + [name]), kind
    if not (len(mods) > 1 and mods[-2:] in (['norm', 'norm'], ['preact_norm', 'norm'])):
        key.append('norm')  # the ``in`` norm: flax's params on the NormLayer itself
    name = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
            'var': 'running_var'}[leaf]
    return '.'.join(key + [name]), 'leaf'


def sparnet_state_dict_from_jax(variables):
    """sisr_tpu's SPARNet or QSPARNet variables ``{'params', 'batch_stats'}`` (or the
    params alone, for a norm type without running statistics) -> the port's
    state_dict, ``num_batches_tracked`` 0 beside each BatchNorm's statistics (flax
    keeps no count).  Every leaf is read; a path the walk does not know raises."""
    if 'params' not in variables:
        variables = {'params': variables}
    sd = {}
    for collection in ('params', 'batch_stats'):
        tree = _TrackingTree(variables.get(collection, {}))
        for path in sorted(tree.leaves):
            try:
                key, kind = _sparnet_torch_key(path)
            except (KeyError, ValueError, IndexError) as exc:
                raise RuntimeError('sisr_tpu SPARNet %s leaf %s is not one the converter '
                                   'reads (%s)' % (collection, '/'.join(path), exc))
            sd[key] = _to_torch_layout(tree(*path), kind)
            if key.endswith('running_mean'):
                sd[key[:-len('running_mean')] + 'num_batches_tracked'] = np.array(0)
    extra = sorted(set(variables) - {'params', 'batch_stats'})
    if extra:
        raise RuntimeError('sisr_tpu SPARNet variables hold collections the converter '
                           'does not read: %s' % extra)
    return {k: torch.from_numpy(np.array(v, dtype=np.int64 if k.endswith(
        'num_batches_tracked') else np.float32)) for k, v in sd.items()}


def _to_torch_layout(a, kind):
    """A sisr_tpu leaf in torch's layout: flax Conv (kH, kW, I, O) -> (O, I, kH, kW);
    Dense (I, O) -> a 1x1 conv's (O, I, 1, 1); anything else as it is."""
    if kind == 'conv':
        return a.transpose(3, 2, 0, 1)
    if kind == 'dense':
        return a.T.reshape(a.shape[1], a.shape[0], 1, 1)
    return a


def _sparnet_variables(state_dict):
    """The port's SPARNet state_dict as sisr_tpu's variables (views on the
    state_dict's tensors), every key read."""
    variables = {}
    for key, value in state_dict.items():
        try:
            found = _sparnet_flax_path(key)
        except (KeyError, ValueError, IndexError) as exc:
            raise RuntimeError('SPARNet state_dict key %r is not one the converter reads '
                               '(%s)' % (key, exc))
        if found is None:
            continue
        collection, path, kind = found
        node = variables.setdefault(collection, {})
        for name in path[:-1]:
            node = node.setdefault(name, {})
        if kind == 'conv':
            value = value.permute(2, 3, 1, 0)
        elif kind == 'dense':
            value = value.reshape(value.shape[0], value.shape[1]).t()
        node[path[-1]] = value
    variables.setdefault('params', {})
    return variables


# leaf kinds: (sisr_tpu leaf -> torch tensor, torch tensor -> sisr_tpu leaf)
_LEAF_KINDS = {'leaf': (lambda a: a, lambda t: t),
               # CSAM's kernel: DHWIO over (C, H, W) <-> the Conv3d's (O, I, D, H, W)
               'conv3d': (lambda a: a.transpose(4, 3, 0, 1, 2),
                          lambda t: t.permute(2, 3, 4, 1, 0))}


def _canonical(model_name):
    return 'qrcan' if model_name == 'qpircan' else model_name


def state_dict_from_jax(model_name, params, q_layer_nonlinearity=False):
    """sisr_tpu params of ``model_name`` -> a torch state_dict for this package's
    model of the same structure (float32 CPU tensors, reference key names).  For
    ``qrcan`` the QCALayer style, q_node and pa_node of each block are read off the
    tree.  For ``qedsr`` the tree does not say whether the ParaCALayers have their
    ReLU, which shifts the torch keys: ``q_layer_nonlinearity`` is the model's
    flag."""
    if model_name in SPARNET_MODELS:
        return sparnet_state_dict_from_jax(params)
    if model_name not in LAYOUT_MODELS:
        raise NotImplementedError('No sisr_tpu -> torch converter for %r (available: %s)'
                                  % (model_name, sorted(LAYOUT_MODELS + SPARNET_MODELS)))
    tree = _TrackingTree(params)
    sd = {}
    for path, key, kind in _tree_layout(_canonical(model_name), tree, q_layer_nonlinearity):
        if kind in _LEAF_KINDS:
            sd[key] = _LEAF_KINDS[kind][0](tree(*path))
            continue
        sd[key + '.weight'] = _to_torch_layout(tree(*path, 'kernel'), kind)
        sd[key + '.bias'] = tree(*path, 'bias')
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
    the state_dict's tensors (on their device).  A ``qedsr`` state_dict tells its
    ``q_layer_nonlinearity`` by the ReLU-shifted ParaCALayer indices.  A reference
    checkpoint's dead parameters are dropped and its aged keys renamed first
    (:func:`repair_reference_keys`).  A state_dict with BatchNorm running statistics
    (SPARNet's, QSPARNet's) raises: :func:`variables_from_state_dict` reads it."""
    if model_name in SPARNET_MODELS:
        variables = _sparnet_variables(state_dict)
        if variables.get('batch_stats'):
            raise RuntimeError('state_dict for %r holds BatchNorm running statistics, '
                               'which the params alone leave unread: use '
                               'variables_from_state_dict' % model_name)
        return variables['params']
    if model_name not in LAYOUT_MODELS:
        raise NotImplementedError('No torch -> sisr_tpu tree reader for %r (available: %s)'
                                  % (model_name, sorted(LAYOUT_MODELS + SPARNET_MODELS)))
    state_dict = repair_reference_keys(model_name, state_dict)
    params, used = {}, set()
    for path, key, kind in _state_dict_layout(_canonical(model_name), state_dict):
        node = params
        for name in path[:-1]:
            node = node.setdefault(name, {})
        if kind in _LEAF_KINDS:
            node[path[-1]] = _LEAF_KINDS[kind][1](state_dict[key])
            used.add(key)
            continue
        w = state_dict[key + '.weight']
        node[path[-1]] = {'kernel': w.permute(2, 3, 1, 0) if kind == 'conv'
                          else w.reshape(w.shape[0], w.shape[1]).t(),
                          'bias': state_dict[key + '.bias']}
        used.update((key + '.weight', key + '.bias'))
    leftovers = sorted(set(state_dict) - used)
    if leftovers:
        raise RuntimeError('state_dict for %r left %d key(s) unread (e.g. %s)'
                           % (model_name, len(leftovers), leftovers[:4]))
    return params


def variables_from_state_dict(model_name, state_dict):
    """A port model's ``state_dict`` as sisr_tpu's full variables: ``{'params': ...}``,
    with ``'batch_stats'`` (each BatchNorm's ``mean`` and ``var``) for a SPARNet or
    QSPARNet with BatchNorms, as sisr_tpu's ``convert_torch_variables`` gives them.
    Every key is read, or it raises."""
    if model_name in SPARNET_MODELS:
        return _sparnet_variables(state_dict)
    return {'params': params_from_state_dict(model_name, state_dict)}


def int8_state_from_jax(qparams, act_scales, device='cpu'):
    """sisr_tpu's quantised tree and activation scales (``quantize_<family>_params``
    and ``calibrate_<family>_scales`` of any family of ``LAYOUT_MODELS``, as
    numpy) -> the port's: the same tree of tensors on ``device``, each int8 conv entry
    (one with a ``scale``) with its packed ``_int_mm`` matrix, the f32 attention
    entries (``ca``, ``qca``, ``pa_node``, ``q_node``, ``attention``, ``la``,
    ``csa``, ``non_local``, ``soca``, ``q_layer``, ``gamma``, SFTMD's SFT layers and
    gates) as they are, and the scales
    (``residual16`` too) as ``np.float32``."""
    from ..ops.quantization import pack_kernel_matrix

    def convert(node):
        if isinstance(node, dict) or hasattr(node, 'items'):
            out = {str(k): convert(v) for k, v in node.items()}
            if 'scale' in out and 'kernel' in out:
                out['matrix'] = pack_kernel_matrix(out['kernel'])
            return out
        return torch.from_numpy(np.array(node)).to(device)

    return convert(qparams), {str(k): np.float32(v) for k, v in act_scales.items()}
