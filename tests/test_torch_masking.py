"""sisr_tpu_torch's bucketed-eval masking (ops/masking.py, the CA op's valid extent)
against sisr_tpu's on the CPU: the mask helpers; the channel attention of CALayer and
of QCALayer in all six styles on a zero-padded map inside a mask context; the CA
op's extent (plain version) against the unpadded map, the full extent bit-identical
to none; the conv mask hooks' lifetime; and the bucketed forward of RCAN, Q-RCAN,
EDSR, Q-EDSR, HAN and Q-HAN (LAM's and CSAM's gammas non-zero), equal to the port's
unpadded forward within 1e-6 and to sisr_tpu's ``_bucketed_forward`` within 5e-4
(f32, the same weights)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sisr_tpu.models.blocks import CALayer as JaxCALayer
from sisr_tpu.models.handlers import define_model as jax_define_model
from sisr_tpu.models.q_layers import QCALayer as JaxQCALayer
from sisr_tpu.ops import masking as jax_masking
from sisr_tpu_torch.models.blocks import CALayer
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.models.q_layers import STYLES, QCALayer
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.ops import masking
from sisr_tpu_torch.tools.convert_weights import state_dict_from_jax

C, M = 32, 10
BUCKET, VALID = (16, 24), (11, 17)


def _padded(rng, n=2, garbage=True):
    """(n, C, 16, 24) NCHW maps valid in their first (11, 17) pixels; the pad holds
    garbage (which every pool must ignore) or zeros."""
    x = rng.rand(n, C, *BUCKET).astype(np.float32)
    pad = np.ones(BUCKET, bool)
    pad[:VALID[0], :VALID[1]] = False
    x[:, :, pad] = x[:, :, pad] * 4 + 4 if garbage else 0
    return x


def test_mask_helpers_match_sisr_tpu():
    rng = np.random.RandomState(0)
    x = _padded(rng)
    assert masking.valid_extent(*BUCKET) is None
    with masking.spatial_masks(BUCKET, VALID), \
            jax_masking.spatial_masks(BUCKET, jnp.asarray(VALID)):
        for factor in (1, 2, 4):
            ours = masking.valid_extent(BUCKET[0] * factor, BUCKET[1] * factor)
            theirs = jax_masking.valid_extent((1, BUCKET[0] * factor, BUCKET[1] * factor, 1))
            assert ours == tuple(int(v) for v in theirs) == (VALID[0] * factor,
                                                             VALID[1] * factor)
        assert masking.valid_extent(BUCKET[0] + 1, BUCKET[1]) is None  # off the grid
        nhwc = x.transpose(0, 2, 3, 1)
        np.testing.assert_array_equal(
            masking.apply_mask(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1),
            np.asarray(jax_masking.apply_mask(jnp.asarray(nhwc))))
        np.testing.assert_array_equal(
            masking.apply_mask(torch.from_numpy(nhwc), spatial_dims=(1, 2)).numpy(),
            np.asarray(jax_masking.apply_mask(jnp.asarray(nhwc))))
        np.testing.assert_allclose(
            masking.masked_global_mean(torch.from_numpy(x)).numpy(),
            np.asarray(jax_masking.masked_global_mean(jnp.asarray(nhwc))), atol=1e-6, rtol=0)
    # outside a context everything is the identity / the plain mean
    assert masking.mask_for(torch.from_numpy(x)) is None
    assert torch.equal(masking.masked_global_mean(torch.from_numpy(x)),
                       torch.from_numpy(x).mean(dim=(2, 3)))


def _jax_layer_weights(style):
    """The port module's dense layers (as (port_prefix, jax_name)) for a style."""
    if style in ('modulate', 'standard', 'max_concat', 'softmax'):
        return [('conv_du.0', 'du_0'), ('conv_du.2', 'du_1')]
    if style == 'mini_concat':
        return [('pre_concat', 'pre_concat'), ('conv_du.1', 'du_1')]
    return [('feature_convs.%d.0' % i, 'feature_%d' % i) for i in range(3)] + \
        [('final_conv.0', 'final')]


def _load_from_jax(module, params, pairs):
    state = {}
    for prefix, name in pairs:
        kernel = np.asarray(params[name]['kernel'])
        state[prefix + '.weight'] = torch.from_numpy(kernel.T.copy())[:, :, None, None]
        state[prefix + '.bias'] = torch.from_numpy(np.array(params[name]['bias']))
    module.load_state_dict(state)


@pytest.mark.parametrize('style', ['calayer'] + list(STYLES))
def test_masked_channel_attention_matches_sisr_tpu(style):
    """A padded map with garbage in the pad inside a mask context: the port's layer
    (the CA op's valid extent for CALayer and the kernel styles, masked_global_mean
    for the others) against sisr_tpu's masked_global_mean layer, 1e-5 f32."""
    rng = np.random.RandomState(1)
    x = _padded(rng)
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    width = C if style == 'modulate' else M
    meta = rng.rand(2, width).astype(np.float32)
    if style == 'calayer':
        jax_layer, port = JaxCALayer(channel=C), CALayer(C)
        variables = jax_layer.init(jax.random.PRNGKey(0), nhwc)
        call = lambda: jax_layer.apply(variables, nhwc)
        pairs = [('conv_du.0', 'du_0'), ('conv_du.2', 'du_1')]
        ours = lambda: port(torch.from_numpy(x))
    else:
        jax_layer = JaxQCALayer(channel=C, style=style, num_metadata=width)
        variables = jax_layer.init(jax.random.PRNGKey(0), nhwc, jnp.asarray(meta))
        call = lambda: jax_layer.apply(variables, nhwc, jnp.asarray(meta))
        port = QCALayer(C, style=style, num_metadata=width)
        pairs = _jax_layer_weights(style)
        ours = lambda: port(torch.from_numpy(x), torch.from_numpy(meta))
    _load_from_jax(port, variables['params'], pairs)
    with masking.spatial_masks(BUCKET, VALID), \
            jax_masking.spatial_masks(BUCKET, jnp.asarray(VALID)):
        theirs = np.asarray(call())
        with torch.no_grad():
            out = ours().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, theirs, atol=1e-5, rtol=0)
    with torch.no_grad():  # and the extent changed the result
        assert np.abs(ours().numpy().transpose(0, 2, 3, 1) - theirs).max() > 1e-4


@pytest.mark.parametrize('with_meta', [False, True])
def test_ca_extent_pools_the_valid_pixels(with_meta):
    """The op's plain version with an extent: the valid region equals the op on the
    unpadded map, the pad is scaled by the same attention; the full extent is the call
    without one, bit for bit; the counter of masked launches is a card counter."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(_padded(rng).transpose(0, 2, 3, 1).copy())
    w1 = torch.from_numpy(rng.randn(C + (M if with_meta else 0), 2).astype(np.float32))
    b1, w2 = torch.from_numpy(rng.randn(2).astype(np.float32)), \
        torch.from_numpy(rng.randn(2, C).astype(np.float32))
    b2 = torch.from_numpy(rng.randn(C).astype(np.float32))
    extra = {'meta': torch.from_numpy(rng.rand(2, M).astype(np.float32)),
             'gate': torch.from_numpy(rng.rand(2, C).astype(np.float32))} if with_meta else {}
    before = ca.fused_channel_attention.masked_launches
    out = ca.fused_channel_attention(x, w1, b1, w2, b2, valid_hw=VALID, **extra)
    crop = x[:, :VALID[0], :VALID[1]].contiguous()
    ref = ca.fused_channel_attention(crop, w1, b1, w2, b2, **extra)
    torch.testing.assert_close(out[:, :VALID[0], :VALID[1]], ref, atol=1e-6, rtol=0)
    att = out[:, :1, :1] / x[:, :1, :1]
    torch.testing.assert_close(out, x * att, atol=1e-6, rtol=1e-5)
    full = ca.fused_channel_attention(x, w1, b1, w2, b2, valid_hw=BUCKET, **extra)
    assert torch.equal(full, ca.fused_channel_attention(x, w1, b1, w2, b2, **extra))
    assert ca.fused_channel_attention.masked_launches == before
    # under autograd: the plain VJP with the same extent
    w1.requires_grad_(True)
    grad, = torch.autograd.grad(ca.fused_channel_attention(
        x, w1, b1, w2, b2, valid_hw=VALID, **extra).sum(), [w1])
    ref_grad, = torch.autograd.grad(ca.reference_channel_attention(
        x, w1, b1, w2, b2, valid_hw=VALID, **extra).sum(), [w1])
    assert torch.equal(grad, ref_grad)


@pytest.mark.parametrize('extent', [(0, 5), (5, 0), (17, 5), (5, 25)])
def test_ca_refuses_extents_outside_the_map(extent):
    x = torch.zeros(1, *BUCKET, C)
    weights = (torch.zeros(C, 2), torch.zeros(2), torch.zeros(2, C), torch.zeros(C))
    with pytest.raises(ValueError, match='valid extent'):
        ca._check_args(x, *weights, valid_hw=extent)
    ca._check_args(x, *weights, valid_hw=BUCKET)


def test_conv_mask_hooks_live_for_the_block_only():
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1), torch.nn.ReLU(),
                                torch.nn.Conv2d(4, 3, 3, padding=1))
    x = torch.ones(1, 3, *BUCKET)
    plain = model(x)
    with masking.conv_mask_hooks(model):
        assert all(len(m._forward_hooks) == 1 and len(m._forward_pre_hooks) == 1
                   for m in model if isinstance(m, torch.nn.Conv2d))
        assert torch.equal(model(x), plain)  # no context: the hooks do nothing
        with masking.spatial_masks(BUCKET, VALID):
            masked = model(x)
    assert all(not m._forward_hooks and not m._forward_pre_hooks for m in model)
    assert masked[:, :, VALID[0]:].abs().max() == 0 and masked[:, :, :, VALID[1]:].abs().max() == 0
    small = model(x[:, :, :VALID[0], :VALID[1]])
    torch.testing.assert_close(masked[:, :, :VALID[0], :VALID[1]], small, atol=1e-6, rtol=0)


FAMILIES = {
    'rcan': ({'scale': 4, 'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16,
              'reduction': 16}, None),
    'qrcan': ({'scale': 4, 'n_resgroups': 1, 'n_resblocks': 2, 'n_feats': 16,
               'reduction': 16, 'style': 'max_concat', 'include_q_layer': True,
               'metadata': ['blur_kernel']}, 10),
    'edsr': ({'scale': 4, 'num_features': 16, 'num_blocks': 2}, None),
    'qedsr': ({'scale': 4, 'num_features': 16, 'num_blocks': 2,
               'metadata': ['blur_kernel'], 'q_layer_nonlinearity': True}, 10),
    'han': ({'scale': 4, 'n_resgroups': 2, 'n_resblocks': 1, 'n_feats': 16,
             'reduction': 16}, None),
    'qhan': ({'scale': 4, 'n_resgroups': 2, 'n_resblocks': 1, 'n_feats': 16,
              'reduction': 16, 'metadata': ['blur_kernel']}, 10),
}


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_bucketed_forward_matches_unpadded_and_sisr_tpu(name):
    internal, n_meta = FAMILIES[name]
    jax_handler = jax_define_model(name, eval_mode=True, **internal)
    port = define_model(name, device='cpu', **internal)
    kwargs = {}
    if n_meta:
        for handler in (jax_handler, port):
            handler.set_metadata_keys(['blur_kernel'] * n_meta)
        kwargs['metadata'] = np.random.RandomState(4).rand(1, n_meta).astype(np.float32)
    jax_handler.init_state(spatial=(16, 16))
    params = jax.tree.map(np.asarray, jax_handler.state.params)
    if 'la' in params:  # HAN's LAM and CSAM start as the identity (gamma 0): make them act
        params = {**params, 'la': {'gamma': np.array([0.5], np.float32)},
                  'csa': {**params['csa'], 'gamma': np.array([-0.7], np.float32)}}
        jax_handler.state = jax_handler.state.replace(params=jax.tree.map(jnp.asarray, params))
    port.module.load_state_dict(state_dict_from_jax(
        name, params, q_layer_nonlinearity=internal.get('q_layer_nonlinearity', False)))
    rng = np.random.RandomState(3)
    images = [rng.rand(1, h, w, 3).astype(np.float32) for h, w in ((13, 17), (24, 9))]
    unpadded = [port.run_eval(x, **kwargs)[0] for x in images]
    jax_handler.set_eval_buckets(16)
    port.set_eval_buckets(16)
    assert not port.supports_fused_eval()
    for x, ref in zip(images, unpadded):
        ours = port.run_eval(x, **kwargs)[0]
        theirs = np.asarray(jax_handler.run_eval(x, **kwargs)[0])
        assert ours.shape == ref.shape == (1, 4 * x.shape[1], 4 * x.shape[2], 3)
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
        np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=0)
