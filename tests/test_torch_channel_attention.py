"""sisr_tpu_torch's channel attention against sisr_tpu's Pallas kernel (interpret mode)
and plain reference, on the CPU; the launch plan, argument checks, build command and
CALayer wiring in Python.  The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sisr_tpu.ops.pallas.channel_attention import _fused_ca_forward, _reference_ca
from sisr_tpu_torch.models import blocks
from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.ops.cuda import build


def _inputs(shape, seed, red=4):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return (rng.rand(*shape).astype(np.float32),
            (rng.randn(c, c // red) * 0.1).astype(np.float32),
            (rng.randn(c // red) * 0.1).astype(np.float32),
            (rng.randn(c // red, c) * 0.1).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize('shape', [(2, 16, 8, 32), (1, 13, 8, 32)])
def test_cpu_path_matches_pallas_interpret_and_reference(shape):
    arrays = _inputs(shape, seed=0)
    launches = ca.fused_channel_attention.launches
    ours = ca.fused_channel_attention(*map(torch.from_numpy, arrays)).numpy()
    assert ca.fused_channel_attention.launches == launches  # CPU: plain version, no launch
    pallas = np.asarray(_fused_ca_forward(*map(jnp.asarray, arrays), interpret=True))
    ref = np.asarray(_reference_ca(*map(jnp.asarray, arrays)))
    np.testing.assert_allclose(ours, pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('n,hw,c,itemsize,aligned,expect', [
    (8, 128 * 128, 64, 2, True, (True, 66)),   # main path: 16-byte vectors, 66 slabs
    (1, 13 * 8, 32, 4, True, (True, 1)),
    (1, 512 * 512, 64, 2, True, (True, 528)),  # one large map: many slabs per image
    (1, 7 * 5, 20, 2, True, (False, 1)),       # 40-byte pixels: one element a thread
    (1, 16, 64, 2, False, (False, 1)),         # misaligned x: scalar path
])
def test_launch_plan(n, hw, c, itemsize, aligned, expect):
    assert ca.launch_plan(n, hw, c, itemsize, aligned, sm_count=132) == expect


@pytest.mark.parametrize('mutate,error', [
    (lambda a: {**a, 'x': a['x'].permute(0, 2, 1, 3)}, ValueError),      # not contiguous
    (lambda a: {**a, 'x': a['x'].half()}, TypeError),
    (lambda a: {**a, 'x': a['x'][0]}, ValueError),
    (lambda a: {**a, 'w1': a['w1'].t()}, ValueError),
    (lambda a: {**a, 'b2': a['b2'][:-1]}, ValueError),
    (lambda a: {**a, 'w1': a['w1'].requires_grad_()}, NotImplementedError),
])
def test_kernel_argument_checks(mutate, error):
    arrays = _inputs((2, 4, 4, 32), seed=1)
    args = dict(zip(('x', 'w1', 'b1', 'w2', 'b2'), map(torch.from_numpy, arrays)))
    with pytest.raises(error):
        ca._check_args(**mutate(args))


def test_nvcc_command_targets_sm90a(monkeypatch):
    monkeypatch.setattr(build, 'nvcc_path', lambda: '/opt/cuda/bin/nvcc')
    path = build.library_path('channel_attention')
    cmd = build.nvcc_command('channel_attention', path)
    assert cmd[0] == '/opt/cuda/bin/nvcc'
    assert 'arch=compute_90a,code=sm_90a' in cmd and '-shared' in cmd
    assert cmd[-1] == build.source_path('channel_attention')
    assert path.startswith(build.BUILD_DIR + '/libchannel_attention-')


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(build, 'DEFAULT_NVCC', str(tmp_path / 'nvcc'))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        build.build(['channel_attention'])


def test_calayer_passes_a_contiguous_nhwc_view(monkeypatch):
    """A channels_last activation reaches the kernel as a contiguous NHWC view (no
    copy), with conv_du's weights as (C, Cr) / (Cr, C)."""
    seen = {}

    def spy(x, w1, b1, w2, b2):
        seen.update(contiguous=x.is_contiguous(), shape=tuple(x.shape),
                    w1=tuple(w1.shape), w2=tuple(w2.shape), ptr=x.data_ptr())
        return ca.reference_channel_attention(x, w1, b1, w2, b2)

    monkeypatch.setattr(blocks, 'fused_channel_attention', spy)
    layer = blocks.CALayer(32, 4)
    x = torch.rand(2, 32, 6, 5).contiguous(memory_format=torch.channels_last)
    out = layer(x)
    assert seen == {'contiguous': True, 'shape': (2, 6, 5, 32), 'w1': (32, 8),
                    'w2': (8, 32), 'ptr': x.data_ptr()}
    assert out.shape == x.shape
    assert out.is_contiguous(memory_format=torch.channels_last)

