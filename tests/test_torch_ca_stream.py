"""The stream route of the channel attention (``ca_stream``: one image a round, part of
each slab in shared memory, the rest read again from L2), on the CPU: its plan at the
H100's numbers as a table and as properties, its shared-memory layout, the route order
of both ops (on chip, then in rounds, then streaming, then three passes) and the stamp
names of its timeline.  The plain version the op runs on the CPU is held against
sisr_tpu's tiled Pallas kernels by tests/test_torch_channel_attention.py, and the
kernel itself on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sisr_tpu_torch.ops import channel_attention as ca
from sisr_tpu_torch.ops.cuda import build
from sisr_tpu_torch.tools import ca_res_timeline

H100 = {'sm_count': 132, 'smem_optin': 232448}  # SMs, opt-in shared memory per block
DIV2K = 339 * 510  # pixels of a DIV2K validation image's LR map


@pytest.mark.parametrize('n,hw,c,cr,x_itemsize,r_itemsize,aligned,m,expect', [
    # int8 RCAN's tail at DIV2K size: 132 slabs of 1310 pixels, 812 of them on chip
    (1, DIV2K, 64, 4, 4, 2, True, 0, (1, 132, 1310, 812, 232272)),
    (1, DIV2K, 64, 4, 4, 4, True, 0, (1, 132, 1310, 812, 232272)),  # same ring bytes
    (1, DIV2K, 64, 4, 4, 0, True, 0, (1, 132, 1310, 876, 232272)),  # the CA: no ring
    (1, 384 * 512, 64, 4, 4, 0, True, 10, (1, 132, 1490, 875, 232224)),  # the bucket
    (1, 512 * 512, 64, 4, 2, 0, True, 0, (1, 132, 1986, 1721, 232400)),
    (1, 512 * 512, 64, 4, 4, 0, True, 0, (1, 132, 1986, 876, 232272)),
    (2, DIV2K, 64, 4, 4, 0, True, 0, (2, 132, 1310, 876, 232272)),  # one image a round
    (2, DIV2K, 64, 4, 4, 2, True, 10, (2, 132, 1310, 811, 232224)),
    (1, DIV2K, 20, 5, 4, 2, True, 0, None),   # r: 40-byte pixels
    (1, DIV2K, 20, 5, 2, 0, True, 0, None),   # x: 40-byte pixels
    (1, DIV2K, 64, 4, 4, 2, False, 0, None),  # misaligned
])
def test_stream_plan(n, hw, c, cr, x_itemsize, r_itemsize, aligned, m, expect):
    assert ca.stream_plan(n, hw, c, cr, x_itemsize, r_itemsize, aligned, m=m,
                          **H100) == expect


@pytest.mark.parametrize('head,r_itemsize,m,expect', [
    (0, 0, 0, 8016), (0, 2, 0, 24400), (0, 4, 0, 24400), (0, 2, 10, 24608),
    (812, 2, 0, 232272), (876, 0, 0, 232272), (1, 0, 0, 8272),
])
def test_stream_layout_counts_ring_meta_and_head(head, r_itemsize, m, expect):
    """The head rounds up to 128 bytes; the ring is 2 slots of 8192 bytes with r and
    none without; M meta values take M * (Cr + 1) floats, to a 16-byte boundary; 6
    mbarriers (4 chunks of the head, 2 slots) close it."""
    assert ca.stream_smem_bytes(head, 64, 4, 4, r_itemsize, m) == expect


def _owners(n, hw, plan):
    """How many (round, block) pairs take each (image, pixel), head and tail apart."""
    rounds, blocks, slab, head, _ = plan
    heads, tails = np.zeros((n, hw), np.int64), np.zeros((n, hw), np.int64)
    for k in range(rounds):
        for s in range(blocks):
            lo, hi = s * slab, min(hw, (s + 1) * slab)
            heads[k, lo:min(hi, lo + head)] += 1
            tails[k, min(hi, lo + head):hi] += 1
    return heads, tails


@pytest.mark.parametrize('n,hw,r_itemsize', [(1, DIV2K, 2), (2, DIV2K, 0), (3, 5000, 4),
                                             (1, 100, 2)])
def test_stream_covers_each_pixel_once(n, hw, r_itemsize):
    plan = ca.stream_plan(n, hw, 64, 4, 4, r_itemsize, True, **H100)
    heads, tails = _owners(n, hw, plan)
    assert np.array_equal(heads + tails, np.ones((n, hw), np.int64))


@given(n=st.integers(1, 4), hw=st.integers(1, 600000),
       c=st.sampled_from([8, 16, 32, 64, 128, 256]), x_itemsize=st.sampled_from([2, 4]),
       r_itemsize=st.sampled_from([0, 2, 4]), m=st.sampled_from([0, 10, 20]),
       sm_count=st.sampled_from([132, 114, 78, 16]))
@settings(max_examples=300, deadline=None, derandomize=True)
def test_stream_plan_properties(n, hw, c, x_itemsize, r_itemsize, m, sm_count):
    """Each image its own round; every pixel once, no empty block, at most one block an
    SM; head + tail = slab with a head of at least one pixel, the largest that fits
    (one more pixel does not, unless the head is the whole slab); the layout within
    the opt-in shared memory and equal to stream_smem_bytes."""
    cr = max(1, c // 16)
    card = {'sm_count': sm_count, 'smem_optin': H100['smem_optin']}
    plan = ca.stream_plan(n, hw, c, cr, x_itemsize, r_itemsize, True, m=m, **card)
    layout = lambda head: ca.stream_smem_bytes(head, c, cr, x_itemsize, r_itemsize, m)
    if plan is None:
        assert layout(1) > card['smem_optin']
        return
    rounds, blocks, slab, head, smem = plan
    assert rounds == n
    assert blocks <= sm_count and (blocks - 1) * slab < hw <= blocks * slab
    assert slab == -(-hw // sm_count)
    tail = slab - head
    assert 1 <= head <= slab and tail >= 0
    assert smem == layout(head) <= card['smem_optin']
    assert head == slab or layout(head + 1) > card['smem_optin']


@given(n=st.integers(1, 200), hw=st.integers(1, 400000),
       c=st.sampled_from([20, 32, 64, 128]), itemsize=st.sampled_from([2, 4]),
       aligned=st.booleans(), m=st.sampled_from([0, 10]))
@settings(max_examples=300, deadline=None, derandomize=True)
def test_ca_route_order(n, hw, c, itemsize, aligned, m):
    """ca_plan takes the first route whose plan exists: on chip, in rounds, streaming,
    then three passes."""
    cr = max(1, c // 16)
    plans = [('onchip', ca.onchip_plan(n, hw, c, cr, itemsize, aligned, m=m, **H100)),
             ('rounds', ca.res_onchip_plan(n, hw, c, cr, itemsize, 0, aligned, m=m, **H100)),
             ('stream', ca.stream_plan(n, hw, c, cr, itemsize, 0, aligned, m=m, **H100))]
    expect = next(((r, p) for r, p in plans if p is not None), ('three_pass', None))
    assert ca.ca_plan(n, hw, c, cr, itemsize, aligned, m=m, **H100) == expect


@given(n=st.integers(1, 50), hw=st.integers(1, 400000), c=st.sampled_from([18, 32, 64]),
       x_itemsize=st.sampled_from([2, 4]), r_itemsize=st.sampled_from([2, 4]),
       aligned=st.booleans(), m=st.sampled_from([0, 10]))
@settings(max_examples=300, deadline=None, derandomize=True)
def test_ca_res_route_order(n, hw, c, x_itemsize, r_itemsize, aligned, m):
    """ca_res_plan: in rounds, then streaming, then three passes."""
    cr = max(1, c // 16)
    args = (n, hw, c, cr, x_itemsize, r_itemsize, aligned)
    plans = [('rounds', ca.res_onchip_plan(*args, m=m, **H100)),
             ('stream', ca.stream_plan(*args, m=m, **H100))]
    expect = next(((r, p) for r, p in plans if p is not None), ('three_pass', None))
    assert ca.ca_res_plan(*args, m=m, **H100) == expect


@pytest.mark.parametrize('shape,itemsize,m,expect', [
    ((1, 339, 510, 64), 4, 10, 'stream'),   # the f32 eval of a DIV2K validation image
    ((1, 384, 512, 64), 4, 0, 'stream'),    # its bucket
    ((2, 339, 510, 64), 4, 0, 'stream'),
    ((1, 512, 512, 64), 2, 0, 'stream'),
    ((1, 339, 510, 64), 2, 0, 'onchip'),    # bf16: 168 KB slabs fit
    ((8, 128, 128, 64), 4, 10, 'rounds'),
    ((1, 339, 510, 20), 2, 0, 'three_pass'),  # 40-byte pixels
])
def test_ca_plan_takes_the_stream_route_for_one_large_image(shape, itemsize, m, expect):
    n, h, w, c = shape
    assert ca.ca_plan(n, h * w, c, 4, itemsize, True, m=m, **H100)[0] == expect


@pytest.mark.parametrize('x_itemsize,r_itemsize,aligned,expect', [
    (4, 2, True, 'stream'), (4, 4, True, 'stream'), (2, 2, True, 'stream'),
    (4, 2, False, 'three_pass'),
])
def test_ca_res_plan_streams_the_div2k_tail(x_itemsize, r_itemsize, aligned, expect):
    """int8 RCAN's tail at DIV2K size (x f32, a bf16 or f32 carry) streams; a
    misaligned x or r takes three passes."""
    assert ca.ca_res_plan(1, DIV2K, 64, 4, x_itemsize, r_itemsize, aligned,
                          **H100)[0] == expect


def test_stream_timeline_stamp_names():
    """Six stamps a round after the entry's, for the first two rounds (13 stamps)."""
    names = ca_res_timeline.stamp_names(3, 'stream')
    assert len(names) == ca_res_timeline.STAMPS == 13
    assert names[1:7] == ['round0_head_pooled', 'round0_tail_pooled', 'round0_past_barrier',
                          'round0_excited', 'round0_tail_scaled', 'round0_head_scaled']
    assert ca_res_timeline.stamp_names(1, 'stream')[-1] == 'round0_head_scaled'
    stamps = np.zeros((1, ca_res_timeline.STAMP_BLOCKS, ca_res_timeline.STAMPS), np.uint64)
    stamps[0, :2, :7] = 10**9 + 1000 * np.arange(7)
    got = ca_res_timeline.timeline(stamps, blocks=2, rounds=1, route='stream')
    assert list(got) == names[:7] and got['round0_head_scaled'] == [6.0, 6.0, 6.0]


# a card small enough that a small map takes the stream route: 4 SMs, 48 KB a block
SMALL_CARD = {'sm_count': 4, 'smem_optin': 48 * 1024}


@pytest.mark.parametrize('r_itemsize', [0, 4, 2])
def test_small_card_plans_a_small_map_on_the_stream_route(r_itemsize):
    """(1, 40, 36, 32) f32, with no r (the CA), r f32 or r bf16: on a 4-SM card with 48
    KB of shared memory, 360-pixel slabs of which only part sit in shared memory."""
    route, plan = (ca.ca_res_plan(1, 40 * 36, 32, 8, 4, r_itemsize, True, **SMALL_CARD)
                   if r_itemsize else ca.ca_plan(1, 40 * 36, 32, 8, 4, True, **SMALL_CARD))
    assert route == 'stream' and plan[2] == 360 and 1 <= plan[3] < plan[2]


def test_stream_knobs_default_to_the_python_layout():
    """The `.cu` fixes the ring at the slots the Python layout counts unless a build
    defines another count, and each variant the timeline tool builds defines a knob
    the `.cu` reads."""
    with open(build.source_path('channel_attention')) as f:
        src = f.read()
    assert '#define SISR_CA_STREAM_SLOTS %d\n' % ca._STREAM_SLOTS in src
    assert ca_res_timeline.PRODUCT_SLOTS == ca._STREAM_SLOTS
    for name, defines, slots in ca_res_timeline.VARIANTS:
        (define,) = defines
        knob = define.split('=')[0]
        assert '#ifndef %s\n' % knob in src or '#ifdef %s\n' % knob in src, name
        assert slots == (int(define.split('=')[1]) if knob == 'SISR_CA_STREAM_SLOTS'
                         else ca._STREAM_SLOTS)
