"""sisr_tpu_torch on an NVIDIA card: the CUDA channel-attention kernel against its plain
version, and a small RCAN on the card against the CPU.  Every test here needs the card
and skips without one.  Imports torch only (no JAX), so the card's machine runs it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import channel_attention as ca

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


@pytest.mark.parametrize('shape,red,dtype', [((8, 128, 128, 64), 16, torch.bfloat16),
                                             ((8, 128, 128, 64), 16, torch.float32),
                                             ((1, 13, 8, 32), 4, torch.float32),
                                             ((2, 16, 8, 32), 4, torch.bfloat16),
                                             ((1, 7, 5, 20), 4, torch.bfloat16)])
@pytest.mark.parametrize('transposed_weights', [False, True])
def test_kernel_matches_plain_version(shape, red, dtype, transposed_weights):
    rng = np.random.RandomState(0)
    c, cr = shape[-1], shape[-1] // red
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dtype).cuda()
    w1, w2 = (torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1).cuda()
              for s in ((c, cr), (cr, c)))
    if transposed_weights:  # conv_du's layout, as CALayer passes it
        w1, w2 = w1.t().contiguous().t(), w2.t().contiguous().t()
    b1, b2 = (torch.from_numpy(rng.randn(n).astype(np.float32) * 0.1).cuda()
              for n in (cr, c))
    launches = ca.fused_channel_attention.launches
    with torch.inference_mode():
        out = ca.fused_channel_attention(x, w1, b1, w2, b2)
        again = ca.fused_channel_attention(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        ref = ca.reference_channel_attention(x, w1, b1, w2, b2)
    assert ca.fused_channel_attention.launches == launches + 2
    assert torch.equal(out, again)  # no atomics: the same bits every run
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:  # 2 bf16 ULPs: the summation order can flip how att rounds to bf16
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-6, rtol=1.6e-2)


def test_rcan_on_card_matches_cpu():
    kw = dict(scale=4, n_resgroups=2, n_resblocks=2, n_feats=32, reduction=16, seed=1)
    card, host = define_model('rcan', device='cuda', **kw), define_model('rcan', device='cpu',
                                                                          **kw)
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 16, 16, 3).astype(np.float32))
    launches = ca.fused_channel_attention.launches
    with torch.inference_mode():
        out = card.forward(x.cuda()).cpu()
        ref = host.forward(x)
    assert ca.fused_channel_attention.launches == launches + 4  # one per RCAB
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=0)
